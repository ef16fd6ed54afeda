// K13-K17: the capability probes of tools/probe_mosaic.py, each the CUDA
// counterpart of one TPU kernel body there (the `kern` of
// p1_scalar_extract, p1b_scalar_in_ds, p2_big_prefetch, p4_roll_dynamic and
// p5_taa_rows).  On the TPU they ask whether Mosaic lowers a vector-to-
// scalar reduction, a data-dependent row slice of scratch, a large scalar
// prefetch table read at traced indices, a lane roll by a data-dependent
// shift and a lane gather.  On Hopper each is a warp reduction or an
// indexed load:
// - K13: out = v + max(v), the add wrapping as int32.  Up to 8 rows (the
//   tool runs 8) one warp holds the whole array in registers: lane l loads
//   words l + 32 k, k < 4 R, all issued before any is used, takes their
//   max, five __shfl_xor_sync steps give the max to every lane, and lane l
//   stores each of its words plus the max from registers.  The loop is
//   unrolled to 32 registers: k < 4 R guards each load, a register past
//   4 R holds INT_MIN, so the max runs unguarded over all 32 (a chain of
//   3-way max instructions), and the stores end at word 4 R by a return
//   (a guard around each row's stores made nvcc reload out's address in
//   every row).  One kernel serves every R <= 8; no shared memory, no
//   barrier.  Past 8 rows the words outgrow a lane's registers, and one
//   block of 1024 threads reduces the array (grid-stride, its 32 warps'
//   maxima combined in shared memory behind two barriers), then adds;
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
// - K16: out = roll(v, sh) along the lanes, sh = (128 - max(v[0]) mod 128)
//   mod 128, so out[r, l] = v[r, (l - sh) & 127].  A warp takes ROLL_ROWS
//   rows and finds sh itself, as K14 finds its row: four words of row 0 a
//   lane, their max, five __shfl_xor_sync steps, the floor modulo twice.
//   Then lane l loads word (l + 32 k - sh) & 127 of each of its rows, k <
//   4 (32 consecutive words taken modulo 128: at most two 128-byte lines a
//   load), all before any store, and stores them at l + 32 k (coalesced).
//   The grid's last warp, short of rows, has one row.  No warp waits for
//   another: blocks of up to ROLL_WARPS warps, one an SM sub-partition, no
//   shared memory, no barrier, any R;
// - K17: out[r, l] = v[r, idx[l]] for idx in [0, 128).  One memory round
//   trip, then shuffles: a warp takes a row, lane l loads idx words
//   l + 32 k (k < 4) and the row's words l + 32 k in one batch before
//   any is used.  Output word l + 32 k is register s >> 5 of lane s & 31,
//   s = idx[l + 32 k]: four __shfl_sync (one a source register, from lane
//   s & 31) and a select on s >> 5, so no register is indexed at run time
//   (that would put the row in local memory); 16 shuffles a row.  A warp
//   issues a shuffle every 4 cycles, so the rows go one a warp, in blocks
//   of TAA_WARPS warps (on the H100 at R = 10, three rows a warp took
//   0.3-0.4 µs more, and a thread a word with its two dependent loads
//   0.1-0.2 µs more).  No shared memory, no barrier, any R;
// mod is the floor modulo of jnp's %, sums and adds wrap as int32 does.
// Bound: launch latency; the arrays are a few KB (K15's table up to 512
// KB, of which 16 words a row are read).

#include <climits>

#include "common.cuh"

namespace {

constexpr int LANES = 128;
constexpr int PF_WORDS = 16;       // K15's table words a row
constexpr int PF_WARPS = 32;       // K15's rows a block, a warp each
constexpr int SE_WARP_ROWS = 8;    // K13's rows in one warp's registers
constexpr int ROLL_ROWS = 2;       // K16's rows a warp
constexpr int ROLL_WARPS = 4;      // K16's warps a block
constexpr int TAA_WARPS = 4;       // K17's warps a block, a row each

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K13 at 1 <= R <= 8 rows: one warp, the array in its registers; lane l
// holds words l + 32 k, k < n = 4 R, and INT_MIN in the rest
__global__ void __launch_bounds__(32)
    scalar_extract_warp_kernel(const int* __restrict__ v, int R,
                               int* __restrict__ out) {
  constexpr int W = SE_WARP_ROWS * LANES / 32;
  const int lane = threadIdx.x;
  const int n = R * LANES / 32;
  int w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = k < n ? v[lane + 32 * k] : INT_MIN;
  int m = w[0];
#pragma unroll
  for (int k = 1; k < W; ++k) m = max(m, w[k]);
  const unsigned add = (unsigned)warp_max(m);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k == n) return;
    out[lane + 32 * k] = (int)((unsigned)w[k] + add);
  }
}

// K13 past 8 rows: one block of 1024 threads over n = R * 128 words
__global__ void __launch_bounds__(1024)
    scalar_extract_block_kernel(const int* __restrict__ v, int n,
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

// N rows of K16 from row r0: every load before any store
template <int N>
__device__ __forceinline__ void roll_rows(const int* __restrict__ v,
                                          int* __restrict__ out,
                                          long long r0, int lane, int sh) {
  int w[N][LANES / 32];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < LANES / 32; ++k)
      w[j][k] = v[(r0 + j) * LANES + ((lane + 32 * k - sh) & (LANES - 1))];
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int k = 0; k < LANES / 32; ++k)
      out[(r0 + j) * LANES + lane + 32 * k] = w[j][k];
}

// K16: warp g of the grid takes rows ROLL_ROWS g .. ROLL_ROWS g + ROLL_ROWS
__global__ void __launch_bounds__(ROLL_WARPS * 32)
    roll_dynamic_kernel(const int* __restrict__ v, int R,
                        int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r0 =
      ((long long)blockIdx.x * ROLL_WARPS + (threadIdx.x >> 5)) * ROLL_ROWS;
  if (r0 >= R) return;                   // a whole warp: no shuffle left
  int m = v[lane];
#pragma unroll
  for (int k = 1; k < LANES / 32; ++k) m = max(m, v[lane + 32 * k]);
  const int sh = floor_mod(LANES - floor_mod(warp_max(m), LANES), LANES);
  // a guard between a row's loads and its stores would hold the next
  // row's loads behind them, so the guard picks the whole copy: the grid's
  // last warp, short of rows, has one row
  static_assert(ROLL_ROWS == 2, "the short warp copies one row");
  if (r0 + ROLL_ROWS <= R) {
    roll_rows<ROLL_ROWS>(v, out, r0, lane, sh);
  } else {
    roll_rows<1>(v, out, r0, lane, sh);
  }
}

// K17: warp g of the grid takes row g
__global__ void __launch_bounds__(TAA_WARPS * 32)
    taa_rows_kernel(const int* __restrict__ v, const int* __restrict__ idx,
                    int R, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * TAA_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;                    // a whole warp: no shuffle left
  int src[LANES / 32], w[LANES / 32];
#pragma unroll
  for (int k = 0; k < LANES / 32; ++k) src[k] = idx[lane + 32 * k];
#pragma unroll
  for (int k = 0; k < LANES / 32; ++k) w[k] = v[r * LANES + lane + 32 * k];
#pragma unroll
  for (int k = 0; k < LANES / 32; ++k) {
    const int s = src[k] & 31, hi = src[k] >> 5;
    const int a = __shfl_sync(0xffffffffu, w[0], s);
    const int b = __shfl_sync(0xffffffffu, w[1], s);
    const int c = __shfl_sync(0xffffffffu, w[2], s);
    const int d = __shfl_sync(0xffffffffu, w[3], s);
    out[r * LANES + lane + 32 * k] =
        hi == 0 ? a : hi == 1 ? b : hi == 2 ? c : d;
  }
}

}  // namespace

// v, out: (R, 128) int32.
extern "C" cudaError_t ffv2_probe_scalar_extract(const int* v, int R,
                                                 int* out,
                                                 cudaStream_t stream) {
  if (R > SE_WARP_ROWS)
    scalar_extract_block_kernel<<<1, 1024, 0, stream>>>(v, R * LANES, out);
  else if (R > 0)
    scalar_extract_warp_kernel<<<1, 32, 0, stream>>>(v, R, out);
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
  if (R > 0) {
    const int warps = (R + ROLL_ROWS - 1) / ROLL_ROWS;
    const int blocks = (warps + ROLL_WARPS - 1) / ROLL_WARPS;
    const int threads = 32 * (warps < ROLL_WARPS ? warps : ROLL_WARPS);
    roll_dynamic_kernel<<<blocks, threads, 0, stream>>>(v, R, out);
  }
  return cudaGetLastError();
}

// v, out: (R, 128); idx: (128,) in [0, 128).
extern "C" cudaError_t ffv2_probe_taa_rows(const int* v, const int* idx,
                                           int R, int* out,
                                           cudaStream_t stream) {
  if (R > 0) {
    const int blocks = (R + TAA_WARPS - 1) / TAA_WARPS;
    const int threads = 32 * (R < TAA_WARPS ? R : TAA_WARPS);
    taa_rows_kernel<<<blocks, threads, 0, stream>>>(v, idx, R, out);
  }
  return cudaGetLastError();
}
