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
// - rowcx: columns are independent, so a warp takes one column of a
//   256-row span and holds it in registers, lane l rows l + 32 k (k < 8).
//   A block stages CX_COLS columns of the span in shared memory with
//   coalesced loads, each warp reads its column out (an odd row stride: no
//   bank conflict), runs every rep there and writes back once.  A pass of
//   distance b < 32 is a __shfl_xor_sync(b): the lane whose bit b is clear
//   keeps the min, the other the max; b = 32, 64, 128 pairs registers k
//   and k ^ (b / 32) of a lane.  Eight passes (b = 1 .. 128) run as one
//   unrolled round, the reps % 8 left over after them; no division and no
//   barrier between passes.  A pair never leaves an aligned group of
//   2 * b_max rows (b_max = 1 << min(reps - 1, 7)) and R is a multiple of
//   it, so the rows past R of a short span meet only each other;
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
constexpr int CX_COLS = 8;               // columns a block, a warp each
constexpr int CX_SPAN = 256;             // rows a warp
constexpr int CX_REGS = CX_SPAN / 32;    // rows a lane
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

// one pass of distance b = 1 << SH over a warp's column in registers
template <int SH>
__device__ __forceinline__ void cx_pass(int (&v)[CX_REGS], int lane) {
  if constexpr (SH < 5) {
    const bool hi = lane & (1 << SH);
#pragma unroll
    for (int k = 0; k < CX_REGS; ++k) {
      const int o = __shfl_xor_sync(0xffffffffu, v[k], 1 << SH);
      v[k] = hi ? max(v[k], o) : min(v[k], o);
    }
  } else {
    constexpr int m = 1 << (SH - 5);
#pragma unroll
    for (int k = 0; k < CX_REGS; ++k)
      if (!(k & m)) {
        const int a = v[k], c = v[k | m];
        v[k] = min(a, c);
        v[k | m] = max(a, c);
      }
  }
}

__global__ void __launch_bounds__(CX_COLS * 32)
    rowcx_kernel(const int* __restrict__ x, int R, int reps,
                 int* __restrict__ out) {
  __shared__ int s[CX_SPAN][CX_COLS + 1];
  const int tid = threadIdx.x, lane = tid & 31, col = tid >> 5;
  const int c0 = blockIdx.x * CX_COLS;
  const long long r0 = (long long)blockIdx.y * CX_SPAN;
  const int rows = (int)min((long long)CX_SPAN, R - r0);
  // staging: thread tid moves column tid % CX_COLS of rows tid / CX_COLS +
  // 32 j, its loads all issued before the first store
  const int sc = tid % CX_COLS, sr = tid / CX_COLS;
  int v[CX_REGS];
#pragma unroll
  for (int j = 0; j < CX_REGS; ++j)
    if (sr + 32 * j < rows) v[j] = x[(r0 + sr + 32 * j) * LANES + c0 + sc];
#pragma unroll
  for (int j = 0; j < CX_REGS; ++j)
    if (sr + 32 * j < rows) s[sr + 32 * j][sc] = v[j];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < CX_REGS; ++k)
    v[k] = lane + 32 * k < rows ? s[lane + 32 * k][col] : 0;
  int i = 0;
  for (; i + 8 <= reps; i += 8) {
    cx_pass<0>(v, lane);
    cx_pass<1>(v, lane);
    cx_pass<2>(v, lane);
    cx_pass<3>(v, lane);
    cx_pass<4>(v, lane);
    cx_pass<5>(v, lane);
    cx_pass<6>(v, lane);
    cx_pass<7>(v, lane);
  }
  const int tail = reps - i;
  if (tail > 0) cx_pass<0>(v, lane);
  if (tail > 1) cx_pass<1>(v, lane);
  if (tail > 2) cx_pass<2>(v, lane);
  if (tail > 3) cx_pass<3>(v, lane);
  if (tail > 4) cx_pass<4>(v, lane);
  if (tail > 5) cx_pass<5>(v, lane);
  if (tail > 6) cx_pass<6>(v, lane);
#pragma unroll
  for (int k = 0; k < CX_REGS; ++k)
    if (lane + 32 * k < rows) s[lane + 32 * k][col] = v[k];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CX_REGS; ++j)
    if (sr + 32 * j < rows)
      out[(r0 + sr + 32 * j) * LANES + c0 + sc] = s[sr + 32 * j][sc];
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
  if (R < 0 || reps < 0 || R % group) return cudaErrorInvalidValue;
  if (R > 0)
    rowcx_kernel<<<dim3(LANES / CX_COLS, (R + CX_SPAN - 1) / CX_SPAN),
                   CX_COLS * 32, 0, stream>>>(x, R, reps, out);
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
