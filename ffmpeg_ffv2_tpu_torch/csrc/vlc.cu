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
// Only bias and drift carry the chain from row to row: the count follows
// from how many live cells the lane has seen, and error_sum, k and the code
// word feed nothing back (device_rice.py:vlc_update).  So a block of 32
// lanes, one thread a lane, splits each lane's walk over four warps, which
// meet at a named barrier once a batch of BATCH rows:
// - the loader warp reads the rows (a coalesced row of 32 lanes a load)
//   into registers a batch before it turns them into each row's inputs
//   of the chain, two batches ahead of the chain, in a ring of NB batches
//   in shared memory: the folded value's offset v0, the live mask, the
//   count after the row and the halving flag (the count before it is 128).
//   It carries the count as the count it would reach without halving, one
//   add a row (struct Count);
// - the chain warp runs bias and drift, a row a link, with no branch and no
//   division: the folded value v, drift + v, halved by a shift, and the
//   drift tests as selects.  Per row it writes v, the sign of the code
//   (from the pre-row drift and count) and the live flag, packed in one
//   word, to one of two buffers in shared memory;
// - two store warps take each batch one batch behind: each runs error_sum
//   over the batch (a short chain), keeping each row's pre-row value, then
//   codes half of the rows, independent of each other: k, the smallest k
//   <= 16 with count << k >= error_sum, from two leading-zero counts and
//   one compare, the code word, and a coalesced store of 32 lanes.
// A row's chain link takes some 40 cycles on this card (tools/latency.py);
// a warp that also decoded or coded the rows would issue those
// instructions on the chain's time, so each warp keeps one part.  The ring
// and the buffers take their slot from the batch's index over the whole
// walk, so a tile's first batches never land on the last one of the tile
// before, which the store warps may still read.
// As in K2 (adapt.cu) the carry is removed: a root tile (tile_pred < 0)
// walks its lanes on through the successor tiles (succ, the inverse of
// tile_pred, built by the wrapper), keeping the states where the lane's
// continuation flag (s0[tile][4][lane]) is set, and zeroing them across a
// tile of cap 0, which the TPU kernel skips.  Blocks of non-root tiles
// exit at once.  Each warp writes its own states to `ends` after a tile.
// Cell payload (pb, a launch argument, 12 for coding depths <= 12 and 16
// for 13..16): diff + 2^(pb - 1) in bits 0..pb-1, the silent flag in bit
// pb, the valid flag in bit pb + 1.

#include "common.cuh"

namespace {

constexpr int BATCH = 16;     // rows between two barriers
constexpr int NB = 4;         // batches in the ring
constexpr int THREADS = 128;  // the chain, two store warps, the loader

// A lane's count, as the number n it would reach with no halving: a live
// row adds 1 to n (the only link from row to row), and the count is n up
// to 128, then 65..128 over and over (the halving at 128 makes 128 + 1
// into 65), unless the state started above 128, where it never halves.
struct Count {
  int n;
  bool big;
  __device__ void load(int count) {
    n = count;
    big = count > 128;
  }
  __device__ int at() const {
    return big || n <= 128 ? n : 65 + ((n - 129) & 63);
  }
};

// A row's inputs of the chain: x = v0 (the payload's diff), y = the count
// after the row, z = 1 where the count before it is 128 on a live row (the
// halving), w = the value mask where the row is live, else 0.
__device__ __forceinline__ int4 prep_row(int x, int pb, int mask,
                                         Count& cn) {
  const int live = ((x >> (pb + 1)) & ~(x >> pb)) & 1;
  const int count = cn.at();
  cn.n += live;
  int4 p;
  p.x = (x & ((1 << pb) - 1)) - (1 << (pb - 1));
  p.y = cn.at();
  p.z = live & (count == 128);
  p.w = mask & -live;
  return p;
}

// The loader's registers for one batch: rows BATCH j .. BATCH (j + 1) - 1
// of the tile in this thread's lane, 0 past the tile (no valid flag).
struct Rows {
  int r[BATCH];
  __device__ void load(const int* __restrict__ in, int j, int cap) {
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int row = BATCH * j + i;
      r[i] = row < cap ? __ldg(in + (size_t)row * 128) : 0;
    }
  }
  // the rows' inputs of the chain into the ring slot of walk batch g
  __device__ void store(int4 (*ring)[BATCH][32], int g, int t, int pb,
                        int mask, Count& cn) const {
#pragma unroll
    for (int i = 0; i < BATCH; ++i)
      ring[g % NB][i][t] = prep_row(r[i], pb, mask, cn);
  }
};

// The chain warp's link for one row p (prep_row): bias and drift after it,
// and the word for the store warps, v << 2 | sign << 1 | live.  count is
// the count before the row.  Only bias and drift are on the chain; a row
// that is not live leaves both as they are (zero masks, no shift, false
// tests).
__device__ __forceinline__ int chain_row(int4 p, int half, int count,
                                         int& drift, int& bias) {
  const int c1 = p.y;
  const bool live = p.w != 0;
  const int hm = p.w & half;
  const int sgn = (2 * drift + count) >> 31;     // the code's sign
  const int u = ((p.x - bias) & p.w) ^ hm;
  const int d1 = (drift + u - hm) >> p.z;        // drift + v, halved
  const bool neg = live && d1 <= -c1;
  const bool pos = live && d1 > 0;
  const int dn = max(d1 + c1, 1 - c1), dp = min(d1 - c1, 0);
  const int bm = max(bias - 1, -128), bp = min(bias + 1, 127);
  drift = neg ? dn : (pos ? dp : d1);
  bias = neg ? bm : (pos ? bp : bias);
  return (int)((unsigned)(u - hm) << 2) | (sgn & 2) | (int)live;
}

// error_sum after a row from the chain's word w and its halving flag h; a
// row that is not live has v = 0 and no halving, and leaves es as it is.
__device__ __forceinline__ int next_es(int es, int w, int h) {
  return ((es + abs(w >> 2)) & (w & 1 ? 0xFFFF : -1)) >> h;
}

// The code word of the chain's word w from the pre-row error_sum and
// count, 0 for a row that is not live.  k is the smallest k with count <<
// k >= es: with k0 = clz(count) - clz(es) (at least 0), count << k0 has
// es's bit length, so k is k0 or k0 + 1; a zero count (a zero carry)
// gives 16 where es > 0, as the reference's sum over k < 16.
__device__ __forceinline__ int code_word(int w, int bits, int es,
                                         int count) {
  const int sgn = -((w >> 1) & 1);
  const int v = w >> 2;
  const int k0 = max(__clz(count) - __clz(es), 0);
  const int kc = k0 + ((count << k0) < es);
  const int k = count > 0 ? kc : (es > 0 ? 16 : 0);
  const int code = v ^ sgn;
  const int vv = (int)((unsigned)code << 1) ^ (code >> 31);
  const int e = vv >> k;
  const bool esc = e >= 12;
  const int len = esc ? 12 + bits : e + k + 1;
  const int val = esc ? vv - 11 : (1 << k) | (vv & ((1 << k) - 1));
  return (w & 1) ? (len << 18) | val : 0;
}

// The warps of the block meet here once a batch (they arrive from
// different places in the code, so a named barrier, not __syncthreads).
__device__ __forceinline__ void batch_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

__global__ void __launch_bounds__(THREADS)
vlc_kernel(const int* __restrict__ ch1, const int* __restrict__ caps,
           const int* __restrict__ bases, const int* __restrict__ pred,
           const int* __restrict__ succ, const int* __restrict__ s0,
           int cellrows, int bits, int pb, int* __restrict__ code,
           int* __restrict__ ends) {
  // [batch % NB][row][lane]: the loader's rows for the chain (and the
  // counts for the store warps); [batch & 1][row][lane]: the chain's words
  __shared__ int4 ring[NB][BATCH][32];
  __shared__ int buf[2][BATCH][32];
  const int root = blockIdx.x >> 2;
  const int t = threadIdx.x & 31;
  const int lane = (blockIdx.x & 3) * 32 + t;
  const int warp = threadIdx.x >> 5;   // 0 chain, 1 and 2 stores, 3 loads
  if (pred[root] >= 0) return;
  const int mask = (1 << bits) - 1, half = 1 << (bits - 1);

  int drift = 0, es = 0, bias = 0, count = 0;
  Count cn;   // the loader's count
  cn.load(0);
  int batch = 0;   // batches of the walk so far, every warp alike
  for (int tile = root; tile >= 0; tile = succ[tile]) {
    const int base = bases[tile];
    int cap = caps[tile];
    // memory guard; layout_plan's clamp keeps every tile inside the cells
    if (base < 0 || cap > cellrows - base) cap = 0;
    if (cap <= 0) {
      // the TPU kernel skips such a tile: its carry slot stays zero
      drift = es = bias = count = 0;
      cn.load(0);
      continue;
    }
    const int* blk = s0 + (size_t)tile * 5 * 128 + lane;
    if (tile == root || blk[4 * 128] <= 0) {
      drift = blk[0];
      es = blk[128];
      bias = blk[2 * 128];
      count = blk[3 * 128];
      cn.load(count);
    }
    const int nb = (cap + BATCH - 1) / BATCH;
    int* end = ends + (size_t)tile * 4 * 128 + lane;
    if (warp == 3) {
      // the tile's batches 0 and 1 before its first barrier; then, before
      // the barrier that ends the chain's batch b, batch b + 2 into the
      // slot of batch b - 2 (which every warp has left) from the
      // registers, and batch b + 3 into them
      const int* in = ch1 + (size_t)base * 128 + lane;
      Rows q;
      q.load(in, 0, cap);
      q.store(ring, batch, t, pb, mask, cn);
      q.load(in, 1, cap);
      q.store(ring, batch + 1, t, pb, mask, cn);
      q.load(in, 2, cap);
      batch_sync();
      for (int b = 0; b < nb; ++b, ++batch) {
        q.store(ring, batch + 2, t, pb, mask, cn);
        q.load(in, b + 3, cap);
        batch_sync();
      }
      continue;
    }
    batch_sync();
    if (warp == 0) {
      for (int b = 0; b < nb; ++b, ++batch) {
        const int4(*rows)[32] = ring[batch % NB];
        int(*out)[32] = buf[batch & 1];
        int4 p[BATCH];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) p[i] = rows[i][t];
#pragma unroll
        for (int i = 0; i < BATCH; ++i) {
          out[i][t] = chain_row(p[i], half, count, drift, bias);
          count = p[i].y;
        }
        batch_sync();
      }
      end[0] = drift;
      end[2 * 128] = bias;
      end[3 * 128] = count;
    } else {
      // both store warps run error_sum over every row; store warp s codes
      // and writes rows s, s + 2, ...
      const int s = warp - 1;
      int* dst = code + (size_t)(base + s) * 128 + lane;
      for (int b = 0; b < nb; ++b, ++batch) {
        batch_sync();
        const int(*words)[32] = buf[batch & 1];
        const int4(*rows)[32] = ring[batch % NB];
        const int nr = min(BATCH, cap - BATCH * b) - s;   // rows left for s
        int w_[BATCH / 2], es_[BATCH / 2], count_[BATCH / 2];
#pragma unroll
        for (int j = 0; j < BATCH / 2; ++j) {
          const int w0 = words[2 * j][t], w1 = words[2 * j + 1][t];
          const int4 p0 = rows[2 * j][t], p1 = rows[2 * j + 1][t];
          const int es0 = es, count0 = count;
          es = next_es(es, w0, p0.z);
          const int es1 = es, count1 = p0.y;
          es = next_es(es, w1, p1.z);
          count = p1.y;
          w_[j] = s ? w1 : w0;
          es_[j] = s ? es1 : es0;
          count_[j] = s ? count1 : count0;
        }
#pragma unroll
        for (int j = 0; j < BATCH / 2; ++j) {
          const int c = code_word(w_[j], bits, es_[j], count_[j]);
          if (2 * j < nr) dst[(size_t)(BATCH * b + 2 * j) * 128] = c;
        }
      }
      if (s == 0) end[128] = es;
    }
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
    vlc_kernel<<<tiles * 4, THREADS, 0, stream>>>(
        ch1, caps, bases, pred, succ, s0, cellrows, bits, pb, code, ends);
  return cudaGetLastError();
}
