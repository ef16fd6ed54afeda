// K10 roll, K11 rowcx, K12 transpose: the data-movement primitives that
// the bitonic sorter is built from, each repeated `reps` times as the
// microbenchmark of tools/microbench_pallas.py runs them.
//
// Replace the TPU kernel bodies tools/microbench_pallas.py:roll_kernel
// (a lane roll by 1 << (i % 7) along axis 1, then + 1), rowcx_kernel (the
// min and max of row blocks b = 1 << (i % 8) apart) and transpose_kernel
// (x = x.T + 1; x = x.T + 1).  The TPU kernels hold the whole (R, 128)
// array in VMEM and make every rep a pass over it there; here each warp or
// block holds the part of the array that its reps touch on chip, and every
// rep is a pass over that copy (nothing is folded into closed form):
// - roll: rows are independent, so a warp takes one row and holds it in
//   registers, lane l elements l + 32 k in v[k] (k < 4), loaded and stored
//   as four coalesced 128-byte rows.  A roll by s < 32 is one
//   __shfl_sync from lane (l - s) & 31 a register; lane l < s takes
//   element l - s + 32 k from register k - 1 of that lane, the others from
//   register k.  s = 32 and 64 rename the registers (v[k] <- v[k - s/32]),
//   no shuffle.  The seven rolls s = 1 .. 64 run as one unrolled round,
//   the reps % 7 left over after them: no shared memory, no barrier and
//   no division between reps.  Bound on this card: the launch, then the
//   chain of 64 dependent passes (a shuffle's latency each for s < 32);
//   the 1 MB of (2048, 128) move in well under a microsecond;
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
//   so a block holds one 32 x 32 tile B in registers, in a skewed layout:
//   lane l, register k holds T[l][(l + k) & 31] of the tile T it stands
//   for.  A transpose of T is then register j of lane l taking register
//   (32 - j) & 31 of lane (l + j) & 31, then + 1: 31 independent shuffles,
//   each with one register index for the whole warp, no select.  Register
//   j only ever trades with register 32 - j (0 and 16 with themselves), so
//   the block's four warps, one on each of the SM's sub-partitions, each
//   hold 8 of the 32 registers (four such pairs; the last warp three and
//   registers 0 and 16) and need no word from each other: no shared
//   memory, no barrier.  A warp issues a shuffle every 4 cycles at best
//   (with one warp a tile, a rep's 62 shuffles had 264 cycles of issue
//   stalls), so the split lets a rep's shuffles issue four at a time.
//   Each warp starts at T = B^T, the tile one transpose on: register k of
//   lane l is B[(l + k) & 31][l], which it gathers for its 8 registers
//   alone (32 rows a load).  T after the reps is (B + 2 reps)^T, whose
//   register k of lane l is element ((l + k) & 31, l) of the output tile,
//   stored there the same way.
// Bound: device memory, each element read and written once (the reps run
// on chip); at the tool's shapes (0.25-1 MB) launch latency dominates.
// The + 1 wraps modulo 2^32 as int32 does in jax (unsigned arithmetic).

#include "common.cuh"

namespace {

constexpr int LANES = 128;
constexpr int ROLL_WARPS = 4;            // rows a block, a warp each
constexpr int ROLL_REGS = LANES / 32;    // elements a lane
constexpr int CX_COLS = 8;               // columns a block, a warp each
constexpr int CX_SPAN = 256;             // rows a warp
constexpr int CX_REGS = CX_SPAN / 32;    // rows a lane
constexpr int TILE = 32;
constexpr int TILE_WARPS = 4;            // warps a tile, a sub-partition each
constexpr int TILE_SLOTS = TILE / TILE_WARPS;   // registers a lane

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// one rep over a warp's row in registers: roll by s = 1 << SH, then + 1
template <int SH>
__device__ __forceinline__ void roll_pass(int (&v)[ROLL_REGS], int lane) {
  int u[ROLL_REGS];
  if constexpr (SH < 5) {
    constexpr int s = 1 << SH;
    const bool wrapped = lane < s;
#pragma unroll
    for (int k = 0; k < ROLL_REGS; ++k)
      u[k] = __shfl_sync(0xffffffffu, v[k], (lane - s) & 31);
#pragma unroll
    for (int k = 0; k < ROLL_REGS; ++k)
      v[k] = wrap_add(wrapped ? u[(k + ROLL_REGS - 1) % ROLL_REGS] : u[k], 1);
  } else {
    constexpr int d = 1 << (SH - 5);     // registers the row moves by
#pragma unroll
    for (int k = 0; k < ROLL_REGS; ++k) u[k] = v[k];
#pragma unroll
    for (int k = 0; k < ROLL_REGS; ++k)
      v[k] = wrap_add(u[(k + ROLL_REGS - d) % ROLL_REGS], 1);
  }
}

__global__ void __launch_bounds__(ROLL_WARPS * 32)
    roll_kernel(const int* __restrict__ x, int R, int reps,
                int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * ROLL_WARPS + (threadIdx.x >> 5);
  if (row >= R) return;                  // a whole warp: no shuffle left
  int v[ROLL_REGS];
#pragma unroll
  for (int k = 0; k < ROLL_REGS; ++k) v[k] = x[row * LANES + lane + 32 * k];
  int i = 0;
  for (; i + 7 <= reps; i += 7) {
    roll_pass<0>(v, lane);
    roll_pass<1>(v, lane);
    roll_pass<2>(v, lane);
    roll_pass<3>(v, lane);
    roll_pass<4>(v, lane);
    roll_pass<5>(v, lane);
    roll_pass<6>(v, lane);
  }
  const int tail = reps - i;
  if (tail > 0) roll_pass<0>(v, lane);
  if (tail > 1) roll_pass<1>(v, lane);
  if (tail > 2) roll_pass<2>(v, lane);
  if (tail > 3) roll_pass<3>(v, lane);
  if (tail > 4) roll_pass<4>(v, lane);
  if (tail > 5) roll_pass<5>(v, lane);
#pragma unroll
  for (int k = 0; k < ROLL_REGS; ++k) out[row * LANES + lane + 32 * k] = v[k];
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

// the register of the skewed layout that slot s of warp G holds: slots
// 2p and 2p + 1 hold registers j = 4 G + 1 + p and 32 - j, which a
// transpose swaps; the last warp's slots 6 and 7 hold registers 0 and 16,
// which it keeps
template <int G>
__device__ constexpr int slot_register(int s) {
  return G == TILE_WARPS - 1 && s >= 6 ? (s & 1) * 16
         : s & 1                        ? TILE - (4 * G + 1 + (s >> 1))
                                        : 4 * G + 1 + (s >> 1);
}

// one rep's transpose of a warp's slots, then + 1: register j of lane l
// takes register (32 - j) & 31 of lane (l + j) & 31 (src[s] = lane +
// slot_register(s)), one register index for the whole warp
template <bool LAST>
__device__ __forceinline__ void transpose_pass(const int (&v)[TILE_SLOTS],
                                               int (&w)[TILE_SLOTS],
                                               const int (&src)[TILE_SLOTS]) {
#pragma unroll
  for (int s = 0; s < TILE_SLOTS; ++s) {
    if (LAST && s == 6)
      w[s] = wrap_add(v[s], 1);                      // register 0
    else
      w[s] = wrap_add(__shfl_sync(0xffffffffu, v[LAST && s == 7 ? s : s ^ 1],
                                  src[s]),
                      1);
  }
}

// warp G's part of a tile whose row 0, column `lane` is x[at]
template <int G>
__device__ __forceinline__ void transpose_part(const int* __restrict__ x,
                                               int W, int reps,
                                               int* __restrict__ out,
                                               int lane, long long at) {
  // register k of lane l is B[(l + k) & 31][l]
  int v[TILE_SLOTS], w[TILE_SLOTS], src[TILE_SLOTS];
#pragma unroll
  for (int s = 0; s < TILE_SLOTS; ++s) {
    src[s] = (lane + slot_register<G>(s)) & 31;
    v[s] = x[at + (long long)src[s] * W];
  }
  for (int i = 0; i < reps; ++i) {
    transpose_pass<G == TILE_WARPS - 1>(v, w, src);
    transpose_pass<G == TILE_WARPS - 1>(w, v, src);
  }
  // register k of lane l now holds element ((l + k) & 31, l) of the tile
#pragma unroll
  for (int s = 0; s < TILE_SLOTS; ++s)
    out[at + (long long)src[s] * W] = v[s];
}

__global__ void __launch_bounds__(TILE_WARPS * 32)
    transpose_kernel(const int* __restrict__ x, int W, int reps,
                     int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long at =
      (long long)blockIdx.y * TILE * W + (long long)blockIdx.x * TILE + lane;
  switch (threadIdx.x >> 5) {
    case 0: transpose_part<0>(x, W, reps, out, lane, at); break;
    case 1: transpose_part<1>(x, W, reps, out, lane, at); break;
    case 2: transpose_part<2>(x, W, reps, out, lane, at); break;
    default: transpose_part<3>(x, W, reps, out, lane, at);
  }
}

}  // namespace

// x, out: (R, 128) int32.
extern "C" cudaError_t ffv2_roll(const int* x, int R, int reps, int* out,
                                 cudaStream_t stream) {
  if (R > 0)
    roll_kernel<<<(R + ROLL_WARPS - 1) / ROLL_WARPS, ROLL_WARPS * 32, 0,
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
    transpose_kernel<<<dim3(W / TILE, R / TILE), TILE_WARPS * 32, 0,
                       stream>>>(x, W, reps, out);
  return cudaGetLastError();
}
