// K2 adapt: the FFV1 context-state walk over chain-grouped cells.
//
// Replaces ffmpeg_ffv2_tpu/ffv1/adapt_pallas.py:_kernel_slotpack
// (adapt_pallas, emission_order=False).  The TPU kernel walks the tiles in
// grid order on one core, 128 lanes x 32 slot states per tile, and hands
// the states of split groups (tile_pred >= 0) from a tile to its successor
// through an HBM carry buffer -- which works only because the grid runs in
// order.
//
// Bound: latency of one dependent chain per lane.  Each cell row is one
// table lookup per slot whose input is the previous row's output, so the
// walk of a lane is serial over its rows (up to GCAP = 4096 per tile, and
// a split group chains tiles); the bytes moved are small (4 bytes in,
// 32 out per cell).
// Design: one warp per (root tile, lane); thread t holds permuted slot row
// t (slot 4*(t&7) + (t>>3), host.SLOT_AT_ROW), so the 32 states of the lane
// stay in registers.  The 512-byte transition table sits in shared memory.
// The carry is removed: a root tile (tile_pred < 0) walks its lane on
// through the successor tiles (succ, the inverse of tile_pred, built by the
// wrapper), keeping the state in registers where the lane's continuation
// flag (s0[tile][32][lane]) is set -- no state passes between blocks.  Warps
// of non-root tiles exit at once.  Each warp reads 32 rows of its lane with
// one load per thread and broadcasts them by shuffles, so the chain waits
// on memory once per 32 rows; the 8 packed sv words of a cell are put
// together by shuffles (device_coder.pack_sv_words).  Coding depth <= 10
// only (no repeat sub-steps); the wrapper raises for deeper formats.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Validity and coded bit of this thread's slot for one pixel diff v
// (device_coder.slot_bit_grid; first hits only, e <= 9).
__device__ __forceinline__ void slot_hit(int slot, int v, int* valid,
                                         int* bit) {
  const int a = v < 0 ? -v : v;
  const int e = exponent_of(a);
  const int eE = min(e + 1, 10);
  const int eM = min(e, 10);
  if (slot == 0) {
    *valid = 1;
    *bit = v == 0;
  } else if (v == 0) {
    *valid = 0;
    *bit = 0;
  } else if (slot <= 10) {  // exponent ones then the terminating zero
    *valid = slot <= eE;
    *bit = slot <= e;
  } else if (slot < 22) {  // sign
    *valid = slot == 11 + eM;
    *bit = v < 0;
  } else {  // mantissa, high bit first
    *valid = slot <= 21 + eM;
    const int msh = (slot == 31 && e > 9) ? e - 1 : slot - 22;
    *bit = (a >> max(msh, 0)) & 1;
  }
}

__global__ void __launch_bounds__(128)
adapt_kernel(const int* __restrict__ ch1, const int* __restrict__ caps,
             const int* __restrict__ bases, const int* __restrict__ pred,
             const int* __restrict__ succ, const int* __restrict__ s0,
             const int* __restrict__ table, int tiles, int cellrows,
             int* __restrict__ sv, int* __restrict__ ends) {
  __shared__ unsigned char tab[512];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) {
    const unsigned w = (unsigned)table[i];
    tab[4 * i] = w & 0xFF;
    tab[4 * i + 1] = (w >> 8) & 0xFF;
    tab[4 * i + 2] = (w >> 16) & 0xFF;
    tab[4 * i + 3] = w >> 24;
  }
  __syncthreads();

  const long long warp =
      (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int t = threadIdx.x & 31;
  const int root = (int)(warp >> 7);
  const int lane = (int)(warp & 127);
  if (root >= tiles || pred[root] >= 0) return;
  const int slot = 4 * (t & 7) + (t >> 3);

  int s = 0;
  for (int tile = root; tile >= 0; tile = succ[tile]) {
    const int base = bases[tile];
    int cap = caps[tile];
    // memory guard; layout_plan's clamp keeps every tile inside the cells
    if (base < 0 || cap > cellrows - base) cap = 0;
    if (cap <= 0) {
      // the TPU kernel skips such a tile: its carry slot stays zero
      s = 0;
      continue;
    }
    const int* blk = s0 + (size_t)tile * 33 * 128;
    if (tile == root || blk[32 * 128 + lane] <= 0) s = blk[t * 128 + lane];
    for (int r0 = 0; r0 < cap; r0 += 32) {
      const int nr = min(32, cap - r0);
      const int mine =
          t < nr ? ch1[(size_t)(base + r0 + t) * 128 + lane] : 0;
      for (int j = 0; j < nr; ++j) {
        const int row = __shfl_sync(FULL, mine, j);
        int valid, bit;
        slot_hit(slot, (row & 0xFFF) - 2048, &valid, &bit);
        valid &= (row >> 13) & 1;
        const int out = valid ? s : 0;
        if (valid) s = tab[(bit << 8) | s];
        const unsigned b0 = __shfl_sync(FULL, out, t & 7);
        const unsigned b1 = __shfl_sync(FULL, out, (t & 7) + 8);
        const unsigned b2 = __shfl_sync(FULL, out, (t & 7) + 16);
        const unsigned b3 = __shfl_sync(FULL, out, (t & 7) + 24);
        if (t < 8)
          sv[((size_t)(base + r0 + j) * 8 + t) * 128 + lane] =
              (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
      }
    }
    ends[((size_t)tile * 32 + t) * 128 + lane] = s;
  }
}

}  // namespace

extern "C" cudaError_t ffv2_adapt(const int* ch1, const int* caps,
                                  const int* bases, const int* pred,
                                  const int* succ, const int* s0,
                                  const int* table, int tiles, int cellrows,
                                  int* sv, int* ends, cudaStream_t stream) {
  if (tiles > 0) {
    // one warp per (tile, lane): 128 lanes x 32 threads per tile
    const long long blocks = (long long)tiles * 128 * 32 / 128;
    adapt_kernel<<<(unsigned)blocks, 128, 0, stream>>>(
        ch1, caps, bases, pred, succ, s0, table, tiles, cellrows, sv, ends);
  }
  return cudaGetLastError();
}
