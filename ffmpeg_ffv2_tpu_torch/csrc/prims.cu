// K10 roll, K11 rowcx, K12 transpose: the data-movement primitives that
// the bitonic sorter is built from, each repeated `reps` times as the
// microbenchmark of tools/microbench_pallas.py runs them.
//
// Replace the TPU kernel bodies tools/microbench_pallas.py:roll_kernel
// (a lane roll by 1 << (i % 7) along axis 1, then + 1), rowcx_kernel (the
// min and max of row blocks b = 1 << (i % 8) apart) and transpose_kernel
// (x = x.T + 1; x = x.T + 1).  The TPU kernels hold the whole (R, 128)
// array in VMEM and make every rep a pass over it there; here each block
// holds the part of the array that its reps touch in shared memory, and
// every rep is a pass over that copy (nothing is folded into closed form):
// - roll: rows are independent, ROLL_ROWS rows a block, one thread a lane,
//   ping-pong between two shared buffers;
// - rowcx: columns are independent and a pair never leaves an aligned group
//   of 2 * b_max rows (b_max = 1 << min(reps - 1, 7)), so a block holds one
//   such group of CX_COLS columns and exchanges in place;
// - transpose: tile (a, b) of x comes back to (a, b) after two transposes,
//   so a block holds one 32 x 32 tile and transposes it into a second
//   shared buffer and back, + 1 each time.
// Bound: device memory, each element read and written once (the reps run
// on chip); at the tool's shapes (0.25-1 MB) launch latency dominates.
// The + 1 wraps modulo 2^32 as int32 does in jax (unsigned arithmetic).

#include "common.cuh"

namespace {

constexpr int LANES = 128;
constexpr int ROLL_ROWS = 4;
constexpr int CX_COLS = 32;
constexpr int CX_ROW_THREADS = 8;
constexpr int TILE = 32;
constexpr int TILE_ROWS = 8;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__global__ void roll_kernel(const int* __restrict__ x, int R, int reps,
                            int* __restrict__ out) {
  __shared__ int buf[2][ROLL_ROWS][LANES];
  const int l = threadIdx.x, r = threadIdx.y;
  const long long row = (long long)blockIdx.x * ROLL_ROWS + r;
  const bool in = row < R;
  buf[0][r][l] = in ? x[row * LANES + l] : 0;
  __syncthreads();
  int cur = 0;
  for (int i = 0; i < reps; ++i) {
    const int sh = 1 << (i % 7);
    buf[cur ^ 1][r][l] = wrap_add(buf[cur][r][(l - sh) & (LANES - 1)], 1);
    cur ^= 1;
    __syncthreads();
  }
  if (in) out[row * LANES + l] = buf[cur][r][l];
}

__global__ void rowcx_kernel(const int* __restrict__ x, int reps, int group,
                             int* __restrict__ out) {
  extern __shared__ int s[];                        // [group][CX_COLS]
  const int tc = threadIdx.x, tr = threadIdx.y;
  const long long row0 = (long long)blockIdx.y * group;
  const int col = blockIdx.x * CX_COLS + tc;
  for (int r = tr; r < group; r += CX_ROW_THREADS)
    s[r * CX_COLS + tc] = x[(row0 + r) * LANES + col];
  __syncthreads();
  for (int i = 0; i < reps; ++i) {
    const int b = 1 << (i % 8);
    for (int q = tr; q < group / 2; q += CX_ROW_THREADS) {
      const int lo = (q / b) * 2 * b + q % b, hi = lo + b;
      const int a = s[lo * CX_COLS + tc], c = s[hi * CX_COLS + tc];
      s[lo * CX_COLS + tc] = min(a, c);
      s[hi * CX_COLS + tc] = max(a, c);
    }
    __syncthreads();
  }
  for (int r = tr; r < group; r += CX_ROW_THREADS)
    out[(row0 + r) * LANES + col] = s[r * CX_COLS + tc];
}

__global__ void transpose_kernel(const int* __restrict__ x, int W, int reps,
                                 int* __restrict__ out) {
  __shared__ int a[TILE][TILE + 1], t[TILE][TILE + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long r0 = (long long)blockIdx.y * TILE;
  const int c0 = blockIdx.x * TILE;
  for (int r = ty; r < TILE; r += TILE_ROWS)
    a[r][tx] = x[(r0 + r) * W + c0 + tx];
  __syncthreads();
  for (int i = 0; i < reps; ++i) {
    for (int r = ty; r < TILE; r += TILE_ROWS)
      t[r][tx] = wrap_add(a[tx][r], 1);
    __syncthreads();
    for (int r = ty; r < TILE; r += TILE_ROWS)
      a[r][tx] = wrap_add(t[tx][r], 1);
    __syncthreads();
  }
  for (int r = ty; r < TILE; r += TILE_ROWS)
    out[(r0 + r) * W + c0 + tx] = a[r][tx];
}

}  // namespace

// x, out: (R, 128) int32.
extern "C" cudaError_t ffv2_roll(const int* x, int R, int reps, int* out,
                                 cudaStream_t stream) {
  if (R > 0)
    roll_kernel<<<(R + ROLL_ROWS - 1) / ROLL_ROWS, dim3(LANES, ROLL_ROWS), 0,
                  stream>>>(x, R, reps, out);
  return cudaGetLastError();
}

// x, out: (R, 128) int32; R a multiple of 2 * b_max (the wrapper checks).
extern "C" cudaError_t ffv2_rowcx(const int* x, int R, int reps, int* out,
                                  cudaStream_t stream) {
  const int group = 2 << (reps < 8 ? (reps > 0 ? reps - 1 : 0) : 7);
  if (R % group) return cudaErrorInvalidValue;
  if (R > 0)
    rowcx_kernel<<<dim3(LANES / CX_COLS, R / group),
                   dim3(CX_COLS, CX_ROW_THREADS),
                   group * CX_COLS * sizeof(int), stream>>>(x, reps, group,
                                                            out);
  return cudaGetLastError();
}

// x, out: (R, W) int32; R and W multiples of 32 (the wrapper checks).
extern "C" cudaError_t ffv2_transpose(const int* x, int R, int W, int reps,
                                      int* out, cudaStream_t stream) {
  if (R % TILE || W % TILE) return cudaErrorInvalidValue;
  if (R > 0 && W > 0)
    transpose_kernel<<<dim3(W / TILE, R / TILE), dim3(TILE, TILE_ROWS), 0,
                       stream>>>(x, W, reps, out);
  return cudaGetLastError();
}
