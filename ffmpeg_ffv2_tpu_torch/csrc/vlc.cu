// K5 vlc: the Golomb-Rice VlcState walk over chain-grouped cells.
//
// Replaces ffmpeg_ffv2_tpu/ffv1/device_rice.py:_vlc_kernel
// (vlc_adapt_pallas).  The TPU kernel walks the tiles in grid order on one
// core, 128 lanes per tile, four state rows (drift, error_sum, bias, count)
// per lane, and hands the states of split groups (tile_pred >= 0) to the
// successor tile through an HBM carry buffer -- which works only because
// the grid runs in order.
//
// Bound: latency of one dependent chain per lane.  Each live cell's code
// word and state update depend on the previous live cell of its lane, so a
// lane is serial over its rows (up to GCAP = 4096 per tile, and a split
// group chains tiles); the bytes moved are small (4 bytes in, 4 out per
// cell).
// Design: one block of 128 threads per tile, one thread per lane; the four
// states stay in registers.  As in K2 (adapt.cu) the carry is removed: a
// root tile (tile_pred < 0) walks its lane on through the successor tiles
// (succ, the inverse of tile_pred, built by the wrapper), keeping the
// states where the lane's continuation flag (s0[tile][4][lane]) is set.
// Blocks of non-root tiles exit at once.  A row is one coalesced load
// across the block's 128 lanes; BATCH rows are loaded before they are
// walked, so the chain waits on memory once per BATCH rows.  There is no
// table gather: k = bitlength((error_sum - 1) / count), the closed form of
// device_rice.py:501-505.  Cell payload (pb, a launch argument, 12 for
// coding depths <= 12 and 16 for 13..16): diff + 2^(pb - 1) in bits
// 0..pb-1, the silent flag in bit pb, the valid flag in bit pb + 1.

#include "common.cuh"

namespace {

constexpr int BATCH = 16;

// One put_vlc_symbol + update_vlc_state (device_rice.vlc_code_word and
// vlc_update); returns len << 18 | val, or 0 for a row that is not live.
__device__ __forceinline__ int vlc_step(int row, int bits, int pb,
                                        int& drift, int& es, int& bias,
                                        int& count) {
  if (!((row >> (pb + 1)) & 1) || ((row >> pb) & 1)) return 0;
  const int v0 = (row & ((1 << pb) - 1)) - (1 << (pb - 1));
  const int half = 1 << (bits - 1);
  const int d = (v0 - bias) & ((1 << bits) - 1);
  const int v = d - ((d & half) << 1);
  // smallest k <= 16 with count << k >= error_sum; count is 0 only in a
  // zero carry, where the reference's sum over k gives 16 (es > 0) or 0
  const int q = count > 0 ? (es - 1) / count : (es > 0 ? 0xFFFF : 0);
  const int k = q >= 1 ? 32 - __clz(q) : 0;
  const int code = v ^ ((2 * drift + count) >> 31);
  const int vv = (int)((unsigned)code << 1) ^ (code >> 31);
  const int e = vv >> k;
  int len, val;
  if (e >= 12) {
    len = 12 + bits;
    val = vv - 11;
  } else {
    len = e + k + 1;
    val = (1 << k) | (vv & ((1 << k) - 1));
  }
  es = (es + abs(v)) & 0xFFFF;
  drift += v;
  if (count == 128) {
    count >>= 1;
    drift >>= 1;  // arithmetic
    es >>= 1;
  }
  count += 1;
  if (drift <= -count) {
    bias = max(bias - 1, -128);
    drift = max(drift + count, -count + 1);
  } else if (drift > 0) {
    bias = min(bias + 1, 127);
    drift = min(drift - count, 0);
  }
  return (len << 18) | val;
}

__global__ void __launch_bounds__(128)
vlc_kernel(const int* __restrict__ ch1, const int* __restrict__ caps,
           const int* __restrict__ bases, const int* __restrict__ pred,
           const int* __restrict__ succ, const int* __restrict__ s0,
           int cellrows, int bits, int pb, int* __restrict__ code,
           int* __restrict__ ends) {
  const int root = blockIdx.x;
  const int lane = threadIdx.x;
  if (pred[root] >= 0) return;

  int drift = 0, es = 0, bias = 0, count = 0;
  for (int tile = root; tile >= 0; tile = succ[tile]) {
    const int base = bases[tile];
    int cap = caps[tile];
    // memory guard; layout_plan's clamp keeps every tile inside the cells
    if (base < 0 || cap > cellrows - base) cap = 0;
    if (cap <= 0) {
      // the TPU kernel skips such a tile: its carry slot stays zero
      drift = es = bias = count = 0;
      continue;
    }
    const int* blk = s0 + (size_t)tile * 5 * 128 + lane;
    if (tile == root || blk[4 * 128] <= 0) {
      drift = blk[0];
      es = blk[128];
      bias = blk[2 * 128];
      count = blk[3 * 128];
    }
    const int* in = ch1 + (size_t)base * 128 + lane;
    int* out = code + (size_t)base * 128 + lane;
    for (int r0 = 0; r0 < cap; r0 += BATCH) {
      int rows[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j)
        rows[j] = r0 + j < cap ? in[(size_t)(r0 + j) * 128] : 0;
#pragma unroll
      for (int j = 0; j < BATCH; ++j)
        if (r0 + j < cap)
          out[(size_t)(r0 + j) * 128] =
              vlc_step(rows[j], bits, pb, drift, es, bias, count);
    }
    int* end = ends + (size_t)tile * 4 * 128 + lane;
    end[0] = drift;
    end[128] = es;
    end[2 * 128] = bias;
    end[3 * 128] = count;
  }
}

}  // namespace

extern "C" cudaError_t ffv2_vlc(const int* ch1, const int* caps,
                                const int* bases, const int* pred,
                                const int* succ, const int* s0, int tiles,
                                int cellrows, int bits, int pb, int* code,
                                int* ends, cudaStream_t stream) {
  if (pb != 12 && pb != 16) return cudaErrorInvalidValue;
  if (tiles > 0)
    vlc_kernel<<<tiles, 128, 0, stream>>>(ch1, caps, bases, pred, succ, s0,
                                          cellrows, bits, pb, code, ends);
  return cudaGetLastError();
}
