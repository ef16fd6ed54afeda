// K13-K17: the capability probes of tools/probe_mosaic.py, each the CUDA
// counterpart of one TPU kernel body there (the `kern` of
// p1_scalar_extract, p1b_scalar_in_ds, p2_big_prefetch, p4_roll_dynamic and
// p5_taa_rows).  On the TPU they ask whether Mosaic lowers a vector-to-
// scalar reduction, a data-dependent row slice of scratch, a large scalar
// prefetch table read at traced indices, a lane roll by a data-dependent
// shift and a lane gather.  On Hopper each is a block reduction or an
// indexed load:
// - K13: out = v + max(v); one block reduces the whole (R, 128) array;
// - K14: out (1, 128) = row max(v[0]) mod 4 of v.  One warp: lane l
//   loads words l + 32 k of row 0 (k < 4, coalesced), five
//   __shfl_xor_sync steps give the row's max in every lane, and lane l
//   copies words l + 32 k of row m = max mod 4 from device memory to out.
//   The TPU body's scratch copy of v is not part of the function, so
//   nothing is staged: two dependent loads, no shared memory, no barrier,
//   and any R >= 4;
// - K15: row i of out is x[i] * 0 + the sum of tab[16 i .. 16 i + 16),
//   read from device memory (the table may exceed the 64 KB of
//   __constant__).  Its work (16 words in, 128 out a row) is nanoseconds,
//   so what bounds it on this card is the launch itself.  So a warp takes
//   a row and the grid is one block of up to 32 warps (more blocks of 32
//   only past G = 32): lanes l and l + 16 load word l of the row's 16 (one
//   64-byte load), four __shfl_xor_sync steps add them up in every lane
//   (unsigned, so the sum wraps as jnp's int32 does), and lane l writes
//   words l + 32 k of the row, k < 4 (each a coalesced 128-byte store, so
//   any 4-byte aligned x and out will do).  No shared memory, no barrier;
//   nvcc drops the read of x, since x * 0 is 0 for every x;
// - K16: out = roll(v, (128 - max(v[0]) mod 128) mod 128) along the lanes;
//   every block reduces row 0 itself, so blocks need no order;
// - K17: out[r, l] = v[r, idx[l]] for idx in [0, 128).
// mod is the floor modulo of jnp's %, sums and adds wrap as int32 does.
// Bound: launch latency; the arrays are a few KB (K15's table up to 512
// KB, of which 16 words a row are read).

#include <climits>

#include "common.cuh"

namespace {

constexpr int LANES = 128;
constexpr int ROWS = 8;            // rows a block for K16 and K17
constexpr int PF_WORDS = 16;       // K15's table words a row
constexpr int PF_WARPS = 32;       // K15's rows a block, a warp each

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max over the 128 lanes of row 0, for a block of 128 * rows threads
__device__ int row0_max(const int* __restrict__ v, int* red) {
  const int t = threadIdx.y * LANES + threadIdx.x;
  if (t < LANES) {
    const int m = warp_max(v[t]);
    if ((t & 31) == 0) red[t >> 5] = m;
  }
  __syncthreads();
  return max(max(red[0], red[1]), max(red[2], red[3]));
}

__global__ void scalar_extract_kernel(const int* __restrict__ v, int n,
                                      int* __restrict__ out) {
  __shared__ int red[32];
  int m = INT_MIN;
  for (int e = threadIdx.x; e < n; e += blockDim.x) m = max(m, v[e]);
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = warp_max(threadIdx.x < blockDim.x / 32 ? red[threadIdx.x] : INT_MIN);
    if (threadIdx.x == 0) red[0] = m;
  }
  __syncthreads();
  m = red[0];
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    out[e] = (int)((unsigned)v[e] + (unsigned)m);
}

__global__ void __launch_bounds__(32)
    scalar_in_ds_kernel(const int* __restrict__ v, int* __restrict__ out) {
  const int lane = threadIdx.x;
  int m = v[lane];
#pragma unroll
  for (int k = 1; k < LANES / 32; ++k) m = max(m, v[lane + 32 * k]);
  const int* row = v + floor_mod(warp_max(m), 4) * LANES;
#pragma unroll
  for (int k = 0; k < LANES / 32; ++k) out[lane + 32 * k] = row[lane + 32 * k];
}

__global__ void __launch_bounds__(PF_WARPS * 32)
    big_prefetch_kernel(const int* __restrict__ tab,
                        const int* __restrict__ x, int G,
                        int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * PF_WARPS + (threadIdx.x >> 5);
  if (i >= G) return;                    // a whole warp: no shuffle left
  unsigned sum = (unsigned)tab[i * PF_WORDS + (lane & (PF_WORDS - 1))];
#pragma unroll
  for (int o = PF_WORDS / 2; o; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const long long row = i * LANES;
#pragma unroll
  for (int k = 0; k < LANES / 32; ++k)
    out[row + lane + 32 * k] =
        (int)((unsigned)x[row + lane + 32 * k] * 0u + sum);
}

__global__ void roll_dynamic_kernel(const int* __restrict__ v, int R,
                                    int* __restrict__ out) {
  __shared__ int red[4];
  const int r = floor_mod(row0_max(v, red), LANES);
  const int sh = floor_mod(LANES - r, LANES);
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.y;
  const int l = threadIdx.x;
  if (row < R)
    out[row * LANES + l] = v[row * LANES + ((l - sh) & (LANES - 1))];
}

__global__ void taa_rows_kernel(const int* __restrict__ v,
                                const int* __restrict__ idx, int R,
                                int* __restrict__ out) {
  const long long row = (long long)blockIdx.x * ROWS + threadIdx.y;
  const int l = threadIdx.x;
  if (row < R) out[row * LANES + l] = v[row * LANES + idx[l]];
}

}  // namespace

// v, out: (R, 128) int32.
extern "C" cudaError_t ffv2_probe_scalar_extract(const int* v, int R,
                                                 int* out,
                                                 cudaStream_t stream) {
  if (R > 0) scalar_extract_kernel<<<1, 1024, 0, stream>>>(v, R * LANES, out);
  return cudaGetLastError();
}

// v: (R, 128), R >= 4; out: (1, 128).
extern "C" cudaError_t ffv2_probe_scalar_in_ds(const int* v, int R, int* out,
                                               cudaStream_t stream) {
  if (R < 4) return cudaErrorInvalidValue;
  scalar_in_ds_kernel<<<1, 32, 0, stream>>>(v, out);
  return cudaGetLastError();
}

// tab: (n_tab,) with n_tab >= 16 * G; x, out: (G, 128).
extern "C" cudaError_t ffv2_probe_big_prefetch(const int* tab, int n_tab,
                                               const int* x, int G, int* out,
                                               cudaStream_t stream) {
  if (n_tab < (long long)PF_WORDS * G) return cudaErrorInvalidValue;
  if (G > 0) {
    const int blocks = (G + PF_WARPS - 1) / PF_WARPS;
    const int threads = 32 * (G < PF_WARPS ? G : PF_WARPS);
    big_prefetch_kernel<<<blocks, threads, 0, stream>>>(tab, x, G, out);
  }
  return cudaGetLastError();
}

// v, out: (R, 128).
extern "C" cudaError_t ffv2_probe_roll_dynamic(const int* v, int R, int* out,
                                               cudaStream_t stream) {
  if (R > 0)
    roll_dynamic_kernel<<<(R + ROWS - 1) / ROWS, dim3(LANES, ROWS), 0,
                          stream>>>(v, R, out);
  return cudaGetLastError();
}

// v, out: (R, 128); idx: (128,) in [0, 128).
extern "C" cudaError_t ffv2_probe_taa_rows(const int* v, const int* idx,
                                           int R, int* out,
                                           cudaStream_t stream) {
  if (R > 0)
    taa_rows_kernel<<<(R + ROWS - 1) / ROWS, dim3(LANES, ROWS), 0, stream>>>(
        v, idx, R, out);
  return cudaGetLastError();
}
