// K2 adapt and K6 adapt_emission: the FFV1 context-state walk over
// chain-grouped cells.
//
// Replaces ffmpeg_ffv2_tpu/ffv1/adapt_pallas.py:_kernel_slotpack (K2,
// adapt_pallas with emission_order=False) and :_kernel_emission (K6,
// emission_order=True).  The TPU kernels walk the tiles in grid order on one
// core, 128 lanes x 32 slot states per tile, and hand the states of split
// groups (tile_pred >= 0) from a tile to its successor through an HBM carry
// buffer -- which works only because the grid runs in order.
//
// Bound: latency of one dependent chain per lane.  Each cell row is one
// table lookup per slot whose input is the previous row's output, so the
// walk of a lane is serial over its rows (up to GCAP = 4096 per tile, and
// a split group chains tiles); the bytes moved are small (4 bytes in,
// 32-48 out per cell).  At coding depths 11..17 each row adds R =
// code_bits - 10 dependent lookups on slots 10 and 31 (two chains of R, in
// two threads).
// Design: two warps per (root tile, lane), a chain warp and a store warp;
// thread t of the chain warp holds permuted slot row t (slot 4*(t&7) +
// (t>>3), host.SLOT_AT_ROW), so the 32 states of the lane stay in
// registers.  The transition table sits in shared memory, with a third
// 256-byte page that maps each state to itself, so a slot that a row does
// not hit looks up its own state and the chain has no select.
// The carry is removed: a root tile (tile_pred < 0) walks its lane on
// through the successor tiles (succ, the inverse of tile_pred, built by the
// wrapper), keeping the state in registers where the lane's continuation
// flag (s0[tile][32][lane]) is set -- no state passes between blocks.  Warps
// of non-root tiles exit at once.
// The rows go in batches of 32, in three parts, so that the chain warp
// holds nothing but the lookups:
// 1. off the chain: thread t loads row t of the batch and builds the row's
//    hit and bit masks over all 32 slots at once; a 32 x 32 bit transpose
//    (five shuffle rounds) gives each thread the masks of its slot over
//    the 32 rows, and warp votes the slot-10 and slot-31 masks of the R
//    repeat sub-steps.  The next batch's masks are built, and the batch
//    after it loaded, before this batch's chain.
// 2. the chain: 32 (1 + R) dependent shared-memory lookups; the
//    pre-update byte of each lookup goes to one of the lane's two buffers
//    in shared memory, laid out as the cells' output words, off the chain.
// 3. the store warp writes the batch out from that buffer while the chain
//    warp walks the next batch into the other (the two meet at a named
//    barrier once a batch), so the chain never waits on the stores, whose
//    4-byte words lie 512 bytes apart (cells x words x 128 lanes).
// K2 output: whole words of the batch's cells (8 packed sv words,
// device_coder.pack_sv_words, and the repeat sub-steps' pre-update pairs
// sv10 | sv31 << 8, two to a word, after them).
// K6 output: the emission-order packing (store_batch) on the store warp.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 2;   // lanes a block, two warps each

// Emission index of this slot's first hit in the pixel's rac-op stream:
// slot 0 -> 0; exponent slot j -> j; sign -> 2e + 2; mantissa slot 22 + i
// -> 2e + 1 - i, except slot 31's first hit when e > 9, at k = e + 2.
__device__ __forceinline__ int first_hit_k(int slot, int e) {
  if (slot <= 10) return slot;
  if (slot < 22) return 2 * e + 2;
  return (slot == 31 && e > 9) ? e + 2 : 2 * e + 1 - (slot - 22);
}

// A batch of 32 rows for this thread's slot: bit j of v is whether row j
// hits the slot, of b its coded bit; rv/rb the same for the repeat
// sub-steps (slots 10 and 31; 0 elsewhere).
template <int R>
struct Pages {
  unsigned v, b;
  unsigned rv[R > 0 ? R : 1], rb[R > 0 ? R : 1];
};

// The 32 x 32 bit matrix whose row t thread t holds, transposed: thread t
// gets column t (five butterfly rounds, each swapping the off-diagonal
// blocks of half the size).
__device__ __forceinline__ unsigned transpose32(unsigned x, int t) {
  unsigned m = 0x0000FFFFu;
#pragma unroll
  for (int j = 16; j; j >>= 1, m ^= m << j) {
    const unsigned y = __shfl_xor_sync(FULL, x, j);
    x = (t & j) ? (x & ~m) | ((y & ~m) >> j) : (x & m) | ((y & m) << j);
  }
  return x;
}

// Part 1: the pages of a batch, off the chain.  Thread t takes row t (its
// cell payload `row`, 0 past the tile: no valid flag, no hit) and builds
// the row's hit and bit masks over the 32 slots at once
// (device_coder.slot_bit_grid: first hits, with the e > 9 caps of slots
// 10 and 31); with eM = min(e, 10) (e = -1 for a zero diff):
//   slot 0 is hit always, its bit v == 0;
//   exponent slot j (1..10) for j <= e + 1, its bit e >= j;
//   sign slot 11 + eM, its bit v < 0;
//   mantissa slot 22 + i for i < eM, its bit bit i of |v| (slot 31 takes
//   bit e - 1 when e > 9).
// A bit transpose turns them into masks over the rows, and a shuffle gives
// thread t those of its slot.  The repeat hits jj = 1..R of slots 10 and
// 31 (e > 9) are votes over the rows.
template <int R>
__device__ __forceinline__ void pages_of(int row, int t, int slot, bool k10,
                                         bool k31, int mask, int bias,
                                         int vbit, Pages<R>& p) {
  const int v = (row & mask) - bias;
  const bool ok = (row >> vbit) & 1;
  const int a = v < 0 ? -v : v;
  const int e = exponent_of(a);
  const int eM = min(e, 10);
  const unsigned ones = (1u << max(eM, 0)) - 1;   // eM ones
  unsigned hit = 1u | (((1u << min(e + 1, 10)) - 1) << 1);
  if (v != 0) hit |= (1u << (11 + eM)) | (ones << 22);
  const int msh31 = e > 9 ? e - 1 : 9;
  const unsigned bit = (unsigned)(v == 0) | (ones << 1) |
                       (v < 0 ? 0x7FFu << 11 : 0u) |
                       ((unsigned)(a & 0x1FF) << 22) |
                       ((unsigned)((a >> msh31) & 1) << 31);
  p.v = __shfl_sync(FULL, transpose32(ok ? hit : 0u, t), slot);
  p.b = __shfl_sync(FULL, transpose32(bit, t), slot);
#pragma unroll
  for (int jj = 1; jj <= R; ++jj) {
    const unsigned v10 = __ballot_sync(FULL, ok && e >= 9 + jj);
    const unsigned b10 = __ballot_sync(FULL, e >= jj + 10);
    const unsigned v31 = __ballot_sync(FULL, ok && e >= 10 + jj);
    const unsigned b31 =
        __ballot_sync(FULL, (a >> max(e - 1 - jj, 0)) & 1);
    p.rv[jj - 1] = k10 ? v10 : k31 ? v31 : 0u;
    p.rb[jj - 1] = k10 ? b10 : k31 ? b31 : 0u;
  }
}

// The table offset of a lookup: bit 0 -> 0, bit 1 -> 256, no hit -> 512
// (the identity page).
__device__ __forceinline__ int page(unsigned v, unsigned b, int j) {
  return (v >> j) & 1 ? (int)((b >> j) & 1) << 8 : 512;
}

// Part 2: the chain over a batch, 32 (1 + R) dependent shared-memory
// lookups.  The pre-update byte of each row (0 where the slot is not hit)
// goes to the warp's buffer at `cell` (stride `row_bytes` a row), and the
// slot-10 and slot-31 threads put those of their sub-steps at `rep`; the
// stores are off the chain.
template <int R>
__device__ __forceinline__ void chain(const Pages<R>& p,
                                      const unsigned char* tab, int& s,
                                      unsigned char* cell, unsigned char* rep,
                                      bool krep, int row_bytes) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    cell[j * row_bytes] = (p.v >> j) & 1 ? s : 0;
    s = tab[page(p.v, p.b, j) + s];
#pragma unroll
    for (int jj = 0; jj < R; ++jj) {
      if (krep)
        rep[j * row_bytes + 4 * (jj >> 1) + 2 * (jj & 1)] =
            (p.rv[jj] >> j) & 1 ? s : 0;
      s = tab[page(p.rv[jj], p.rb[jj], j) + s];
    }
  }
}

// Part 3 for one batch, by the lane's store warp: the batch's bytes in
// the buffer `b8` (32 rows of 4 * OW bytes) out to the cells of rows r0 ..
// r0 + nr - 1 of the tile at `base`.  K2: whole words, one store each.
// K6: per row, each thread reads its slot's pre-update byte back and
// places it at the slot's emission index kk (adapt_pallas.py:117-130), the
// slot-10 and slot-31 threads add their repeat bytes at k = 10 + j and e +
// 2 + j, and word m of the cell is the warp OR of the bytes that land in
// it, for m < ev_words.  As in the TPU kernel, bytes past ev_words words
// are dropped and the slot-31 repeat bytes land by adding.
template <int R, bool kEmission>
__device__ __forceinline__ void store_batch(
    const unsigned char* b8, const int* rows, int r0, int nr, int base,
    int t, int slot, bool k10, bool k31, int my_byte, int rep_byte,
    int mask, int bias, int out_words, int lane, int* __restrict__ out) {
  constexpr int NW = (12 + R) / 2;
  constexpr int OW = 8 + (R + 1) / 2;
  if (!kEmission) {
    const unsigned* buf = reinterpret_cast<const unsigned*>(b8);
    int* dst = out + (size_t)(base + r0) * OW * 128 + lane;
    for (int i = t; i < nr * OW; i += 32) dst[(size_t)i * 128] = (int)buf[i];
    return;
  }
  const int row_cur = t < nr ? rows[(size_t)(r0 + t) * 128] : 0;
#pragma unroll 1
  for (int j = 0; j < nr; ++j) {
    const int row = __shfl_sync(FULL, row_cur, j);
    const int v = (row & mask) - bias;
    const int a = v < 0 ? -v : v;
    const int e = exponent_of(a);
    const unsigned char* cell = b8 + j * 4 * OW;
    const unsigned pre_b = cell[my_byte];
    unsigned orv[NW], addv[NW];
    const int kk = first_hit_k(slot, e);
#pragma unroll
    for (int m = 0; m < NW; ++m) {
      orv[m] = (kk >> 2) == m ? pre_b << ((kk & 3) * 8) : 0u;
      addv[m] = 0;
    }
#pragma unroll
    for (int jj = 1; jj <= R; ++jj) {
      const unsigned rb =
          cell[rep_byte + 4 * ((jj - 1) >> 1) + 2 * ((jj - 1) & 1)];
      if (k10) {
        const int k10i = 10 + jj;
#pragma unroll
        for (int m = 0; m < NW; ++m)
          if ((k10i >> 2) == m) orv[m] |= rb << ((k10i & 3) * 8);
      } else if (k31) {
        const int k31i = e + 2 + jj;
#pragma unroll
        for (int m = 0; m < NW; ++m)
          if ((k31i >> 2) == m) addv[m] += rb << ((k31i & 3) * 8);
      }
    }
    const size_t cw = (size_t)(base + r0 + j) * out_words;
#pragma unroll
    for (int m = 0; m < NW; ++m) {
      if (m < out_words) {
        const unsigned word = __reduce_or_sync(FULL, orv[m]) +
                              __shfl_sync(FULL, addv[m], 31);
        if (t == m) out[(cw + m) * 128 + lane] = (int)word;
      }
    }
  }
}

// The two warps of a lane meet here once a batch, at named barrier 1 +
// pair (constant ids, so that ptxas reserves no more barriers than that).
__device__ __forceinline__ void pair_sync(int pair) {
  static_assert(LANES == 2, "one barrier id a lane of the block");
  if (pair == 0)
    asm volatile("bar.sync 1, 64;" ::: "memory");
  else
    asm volatile("bar.sync 2, 64;" ::: "memory");
}

// R: repeat sub-steps per row (code_bits - 10, or 0).  OW: the words of a
// cell in the shared buffer (K2's output: 8 + ceil(R / 2)).
template <int R, bool kEmission>
__global__ void __launch_bounds__(64 * LANES)
adapt_kernel(const int* __restrict__ ch1, const int* __restrict__ caps,
             const int* __restrict__ bases, const int* __restrict__ pred,
             const int* __restrict__ succ, const int* __restrict__ s0,
             const int* __restrict__ table, int tiles, int cellrows,
             int mask, int bias, int vbit, int out_words,
             int* __restrict__ out, int* __restrict__ ends) {
  constexpr int OW = 8 + (R + 1) / 2;
  __shared__ unsigned char tab[768];
  // two buffers a lane: the chain fills one while the store warp empties
  // the other
  __shared__ unsigned obuf[LANES][2][32 * OW];
  for (int i = threadIdx.x; i < 128; i += blockDim.x) {
    const unsigned w = (unsigned)table[i];
    tab[4 * i] = w & 0xFF;
    tab[4 * i + 1] = (w >> 8) & 0xFF;
    tab[4 * i + 2] = (w >> 16) & 0xFF;
    tab[4 * i + 3] = w >> 24;
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) tab[512 + i] = i;
  // the high pair of the last repeat word stays 0 at odd R
  for (int i = threadIdx.x; i < LANES * 2 * 32 * OW; i += blockDim.x)
    (&obuf[0][0][0])[i] = 0;
  __syncthreads();

  const int t = threadIdx.x & 31;
  const int pair = threadIdx.x >> 6;
  const bool chain_warp = ((threadIdx.x >> 5) & 1) == 0;
  const long long tl = (long long)blockIdx.x * LANES + pair;
  const int root = (int)(tl >> 7);
  const int lane = (int)(tl & 127);
  if (root >= tiles || pred[root] >= 0) return;
  const int slot = 4 * (t & 7) + (t >> 3);
  const bool k10 = slot == 10, k31 = slot == 31;
  // this thread's byte of a cell row in the buffer: word t & 7, byte t >> 3
  const int my_byte = (t & 7) * 4 + (t >> 3);
  // the repeat pair byte of sub-step jj + 1: word 8 + jj / 2, byte
  // (jj & 1) * 2, + 1 for slot 31
  const int rep_byte = 32 + k31;

  int s = 0, batch = 0;
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
    // rows past the tile read as 0: no valid flag, no hit
    const int* rows = ch1 + (size_t)base * 128 + lane;
    if (!chain_warp) {
      for (int r0 = 0; r0 < cap; r0 += 32, ++batch) {
        pair_sync(pair);
        store_batch<R, kEmission>(
            reinterpret_cast<const unsigned char*>(obuf[pair][batch & 1]),
            rows, r0, min(32, cap - r0), base, t, slot, k10, k31, my_byte,
            rep_byte, mask, bias, out_words, lane, out);
      }
      continue;
    }
    const int* blk = s0 + (size_t)tile * 33 * 128;
    if (tile == root || blk[32 * 128 + lane] <= 0) s = blk[t * 128 + lane];
    int nxt = t + 32 < cap ? rows[(size_t)(t + 32) * 128] : 0;
    Pages<R> pc;
    pages_of<R>(t < cap ? rows[(size_t)t * 128] : 0, t, slot, k10, k31, mask,
                bias, vbit, pc);
    for (int r0 = 0; r0 < cap; r0 += 32, ++batch) {
      Pages<R> pn;
      pages_of<R>(nxt, t, slot, k10, k31, mask, bias, vbit, pn);
      nxt = r0 + 64 + t < cap ? rows[(size_t)(r0 + 64 + t) * 128] : 0;
      unsigned char* b8 =
          reinterpret_cast<unsigned char*>(obuf[pair][batch & 1]);
      chain<R>(pc, tab, s, b8 + my_byte, b8 + rep_byte, R > 0 && (k10 || k31),
               4 * OW);
      pc = pn;
      pair_sync(pair);
    }
    ends[((size_t)tile * 32 + t) * 128 + lane] = s;
  }
}

// (mask, bias, valid bit) of the cell payload's diff field
// (host.payload_field).
void payload_field(int code_bits, int* mask, int* bias, int* vbit) {
  if (code_bits > 16) {
    *mask = 0x1FFFF, *bias = 65536, *vbit = 17;
  } else if (code_bits > 10) {
    *mask = 0xFFFF, *bias = 32768, *vbit = 16;
  } else {
    *mask = 0xFFF, *bias = 2048, *vbit = 13;
  }
}

template <bool kEmission>
cudaError_t launch(const int* ch1, const int* caps, const int* bases,
                   const int* pred, const int* succ, const int* s0,
                   const int* table, int tiles, int cellrows, int code_bits,
                   int out_words, int* out, int* ends, cudaStream_t stream) {
  if (code_bits < 8 || code_bits > 17) return cudaErrorInvalidValue;
  if (tiles <= 0) return cudaGetLastError();
  int mask, bias, vbit;
  payload_field(code_bits, &mask, &bias, &vbit);
  // two warps per (tile, lane): 128 lanes per tile
  const unsigned blocks = (unsigned)((long long)tiles * 128 / LANES);
#define FFV2_ADAPT_CASE(R)                                                 \
  case R:                                                                  \
    adapt_kernel<R, kEmission><<<blocks, 64 * LANES, 0, stream>>>(        \
        ch1, caps, bases, pred, succ, s0, table, tiles, cellrows, mask,    \
        bias, vbit, out_words, out, ends);                                 \
    break;
  switch (code_bits > 10 ? code_bits - 10 : 0) {
    FFV2_ADAPT_CASE(0)
    FFV2_ADAPT_CASE(1)
    FFV2_ADAPT_CASE(2)
    FFV2_ADAPT_CASE(3)
    FFV2_ADAPT_CASE(4)
    FFV2_ADAPT_CASE(5)
    FFV2_ADAPT_CASE(6)
    FFV2_ADAPT_CASE(7)
  }
#undef FFV2_ADAPT_CASE
  return cudaGetLastError();
}

}  // namespace

// K2: sv (cellrows, n_sv_words(code_bits), 128).
extern "C" cudaError_t ffv2_adapt(const int* ch1, const int* caps,
                                  const int* bases, const int* pred,
                                  const int* succ, const int* s0,
                                  const int* table, int tiles, int cellrows,
                                  int code_bits, int* sv, int* ends,
                                  cudaStream_t stream) {
  const int r = code_bits > 10 ? code_bits - 10 : 0;
  return launch<false>(ch1, caps, bases, pred, succ, s0, table, tiles,
                       cellrows, code_bits, 8 + (r + 1) / 2, sv, ends, stream);
}

// K6: ev (cellrows, ev_words, 128), ev_words <= n_ev_words(code_bits).
extern "C" cudaError_t ffv2_adapt_emission(
    const int* ch1, const int* caps, const int* bases, const int* pred,
    const int* succ, const int* s0, const int* table, int tiles,
    int cellrows, int code_bits, int ev_words, int* ev, int* ends,
    cudaStream_t stream) {
  if (ev_words < 1 || ev_words > (code_bits + 2) / 2)
    return cudaErrorInvalidValue;
  return launch<true>(ch1, caps, bases, pred, succ, s0, table, tiles,
                      cellrows, code_bits, ev_words, ev, ends, stream);
}
