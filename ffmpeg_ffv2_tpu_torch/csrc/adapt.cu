// K2 adapt, K6 adapt_emission and emission_pack: the FFV1 context-state
// walk over chain-grouped cells, and the packing of its slot-packed words
// into emission order.
//
// Replaces ffmpeg_ffv2_tpu/ffv1/adapt_pallas.py:_kernel_slotpack (K2,
// adapt_pallas with emission_order=False) and :_kernel_emission (K6,
// emission_order=True), and the XLA repack that follows K2 in the JAX
// encoder (ffmpeg_ffv2_tpu/ffv1/device_coder.py:repack_emission_order,
// _repack_jit; no Pallas counterpart).  The TPU kernels walk the tiles in
// grid order on one core, 128 lanes x 32 slot states per tile, and hand the
// states of split groups (tile_pred >= 0) from a tile to its successor
// through an HBM carry buffer -- which works only because the grid runs in
// order.
//
// The walk's bound: latency of one dependent chain per lane.  Each cell row
// is one table lookup per slot whose input is the previous row's output, so
// the walk of a lane is serial over its rows (up to GCAP = 4096 per tile,
// and a split group chains tiles); the bytes moved are small (4 bytes in,
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
// The walk writes whole words of the batch's cells (8 packed sv words,
// adapt.pack_sv_words, and the repeat sub-steps' pre-update pairs sv10 |
// sv31 << 8, two to a word, after them).
//
// emission_pack: slot-packed words -> emission-order words, one thread a
// cell.  Byte k of a cell's output is one byte of its slot words, or 0,
// and which one depends only on (code_bits, the cell's exponent e, k) and
// the fill past the op count (the repack repeats the sign byte there, K6
// writes 0): the wrapper passes that choice as a source table built on the
// host (adapt.emission_table), one row an exponent, four source bytes a
// word.  Its bound: bytes (a payload word and 8-12 slot words read and 2-9
// words written a cell).  Design: a block stages each of its cells' slot
// words in shared memory, word-major and thread-minor (so a warp's byte
// reads hit 32 banks whatever their bytes), with a zero word after them
// for the table's "zero" source, and builds each output word from four
// table lookups and four byte loads; 32 lanes of a row read each slot word
// and write each output word as 128 contiguous bytes.  The walked extent
// (the end of the last tile with rows) comes from the tile tables in every
// block, so no row count goes to the host; rows from it on are written 0
// without reading.
// K6: the walk into a scratch of slot-packed words, then emission_pack
// with the zero fill, on one stream (the kernel boundary orders them).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 2;   // lanes a block, two warps each

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

// Part 3 for one batch, by the lane's store warp: the batch's words in
// the buffer `buf` (32 rows of OW words) out to the cells of rows r0 ..
// r0 + nr - 1 of the tile at `base`, one store a word.
template <int OW>
__device__ __forceinline__ void store_batch(const unsigned* buf, int r0,
                                            int nr, int base, int t,
                                            int lane, int* __restrict__ out) {
  int* dst = out + (size_t)(base + r0) * OW * 128 + lane;
  for (int i = t; i < nr * OW; i += 32) dst[(size_t)i * 128] = (int)buf[i];
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
// cell (8 + ceil(R / 2)), in the shared buffer and in the output.
template <int R>
__global__ void __launch_bounds__(64 * LANES)
adapt_kernel(const int* __restrict__ ch1, const int* __restrict__ caps,
             const int* __restrict__ bases, const int* __restrict__ pred,
             const int* __restrict__ succ, const int* __restrict__ s0,
             const int* __restrict__ table, int tiles, int cellrows,
             int mask, int bias, int vbit, int* __restrict__ out,
             int* __restrict__ ends) {
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
        store_batch<OW>(obuf[pair][batch & 1], r0, min(32, cap - r0), base,
                        t, lane, out);
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

constexpr int PACK_THREADS = 256;        // cells a block of emission_pack
constexpr int MAX_SV_WORDS = 12;         // n_sv_words(17)
constexpr int MAX_EV_WORDS = 9;          // n_ev_words(17)
constexpr int MAX_SOURCE_ROWS = 18;      // e = -1 .. 16

// emission_pack.  src: the source table, `src_rows` rows (row e + 1 for
// the cell's exponent e, e = -1 for a zero diff, up to the payload field's
// largest) of `ev_words` words; byte j of word m is the source of output
// byte k = 4m + j: a byte index into the cell's nsv slot words, or 4 *
// nsv, the zero word staged after them.  Cells of rows from the walked
// extent on are written 0.
__global__ void __launch_bounds__(PACK_THREADS)
emission_pack_kernel(const int* __restrict__ sv, const int* __restrict__ ch1,
                     const int* __restrict__ caps,
                     const int* __restrict__ bases, int tiles, int cellrows,
                     int nsv, int mask, int bias,
                     const int* __restrict__ src, int src_rows, int ev_words,
                     int out_words, int* __restrict__ out) {
  __shared__ unsigned tab[MAX_SOURCE_ROWS * MAX_EV_WORDS];
  // word w of thread t's cell at words[w][t]; words[nsv][t] stays 0
  __shared__ unsigned words[MAX_SV_WORDS + 1][PACK_THREADS];
  __shared__ int warp_ext[PACK_THREADS / 32];
  const int t = threadIdx.x;
  for (int i = t; i < src_rows * ev_words; i += PACK_THREADS)
    tab[i] = (unsigned)src[i];
  words[nsv][t] = 0;
  // the walked extent: the end of the last tile with rows
  int ext = 0;
  for (int i = t; i < tiles; i += PACK_THREADS) {
    const int c = caps[i];
    if (c > 0) ext = max(ext, bases[i] + c);
  }
  ext = __reduce_max_sync(FULL, ext);
  if ((t & 31) == 0) warp_ext[t >> 5] = ext;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < PACK_THREADS / 32; ++w) ext = max(ext, warp_ext[w]);
  ext = min(ext, cellrows);

  const unsigned char* mine =
      reinterpret_cast<const unsigned char*>(&words[0][t]);
  const long long cells = (long long)cellrows * 128;
  for (long long cell = (long long)blockIdx.x * PACK_THREADS + t;
       cell < cells; cell += (long long)gridDim.x * PACK_THREADS) {
    const int row = (int)(cell >> 7), lane = (int)(cell & 127);
    int* dst = out + (size_t)row * out_words * 128 + lane;
    if (row >= ext) {
      for (int m = 0; m < out_words; ++m) dst[(size_t)m * 128] = 0;
      continue;
    }
    const int* cw = sv + (size_t)row * nsv * 128 + lane;
    for (int w = 0; w < nsv; ++w) words[w][t] = (unsigned)cw[(size_t)w * 128];
    const int v = (ch1[cell] & mask) - bias;
    const unsigned* trow = tab + (exponent_of(v < 0 ? -v : v) + 1) * ev_words;
    for (int m = 0; m < out_words; ++m) {
      const unsigned s4 = trow[m];
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned b = (s4 >> (8 * j)) & 0xFF;
        word |= (unsigned)mine[(b >> 2) * (4 * PACK_THREADS) + (b & 3)]
                << (8 * j);
      }
      dst[(size_t)m * 128] = (int)word;
    }
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

int n_sv_words(int code_bits) {
  return 8 + ((code_bits > 10 ? code_bits - 10 : 0) + 1) / 2;
}

int n_ev_words(int code_bits) { return (code_bits + 2) / 2; }

cudaError_t launch_walk(const int* ch1, const int* caps, const int* bases,
                        const int* pred, const int* succ, const int* s0,
                        const int* table, int tiles, int cellrows,
                        int code_bits, int* sv, int* ends,
                        cudaStream_t stream) {
  if (code_bits < 8 || code_bits > 17) return cudaErrorInvalidValue;
  if (tiles <= 0) return cudaGetLastError();
  int mask, bias, vbit;
  payload_field(code_bits, &mask, &bias, &vbit);
  // two warps per (tile, lane): 128 lanes per tile
  const unsigned blocks = (unsigned)((long long)tiles * 128 / LANES);
#define FFV2_ADAPT_CASE(R)                                                 \
  case R:                                                                  \
    adapt_kernel<R><<<blocks, 64 * LANES, 0, stream>>>(                   \
        ch1, caps, bases, pred, succ, s0, table, tiles, cellrows, mask,    \
        bias, vbit, sv, ends);                                             \
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

cudaError_t launch_pack(const int* sv, const int* ch1, const int* caps,
                        const int* bases, int tiles, int cellrows,
                        int code_bits, int out_words, const int* src,
                        int* out, cudaStream_t stream) {
  if (code_bits < 8 || code_bits > 17) return cudaErrorInvalidValue;
  const int ev_words = n_ev_words(code_bits);
  if (out_words < 1 || out_words > ev_words) return cudaErrorInvalidValue;
  if (cellrows <= 0) return cudaGetLastError();
  int mask, bias, vbit;
  payload_field(code_bits, &mask, &bias, &vbit);
  // rows e = -1 .. log2(bias): every exponent the payload field can hold
  const int src_rows = 33 - __builtin_clz((unsigned)bias);
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, emission_pack_kernel, PACK_THREADS, 0);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card once, each striding over the cells
  const long long need =
      ((long long)cellrows * 128 + PACK_THREADS - 1) / PACK_THREADS;
  const unsigned blocks =
      (unsigned)std::min(need, (long long)sms * std::max(per_sm, 1));
  emission_pack_kernel<<<blocks, PACK_THREADS, 0, stream>>>(
      sv, ch1, caps, bases, tiles, cellrows, n_sv_words(code_bits), mask,
      bias, src, src_rows, ev_words, out_words, out);
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
  return launch_walk(ch1, caps, bases, pred, succ, s0, table, tiles,
                     cellrows, code_bits, sv, ends, stream);
}

// emission_pack: sv (cellrows, n_sv_words(code_bits), 128) -> out
// (cellrows, out_words, 128), out_words <= n_ev_words(code_bits), by the
// source table src (adapt.source_words).
extern "C" cudaError_t ffv2_emission_pack(const int* sv, const int* ch1,
                                          const int* caps, const int* bases,
                                          int tiles, int cellrows,
                                          int code_bits, int out_words,
                                          const int* src, int* out,
                                          cudaStream_t stream) {
  return launch_pack(sv, ch1, caps, bases, tiles, cellrows, code_bits,
                     out_words, src, out, stream);
}

// K6: the walk into sv (zeroed by the caller), then emission_pack by src
// (the zero fill) into ev (cellrows, ev_words, 128), on one stream.
extern "C" cudaError_t ffv2_adapt_emission(
    const int* ch1, const int* caps, const int* bases, const int* pred,
    const int* succ, const int* s0, const int* table, int tiles,
    int cellrows, int code_bits, int ev_words, const int* src, int* sv,
    int* ev, int* ends, cudaStream_t stream) {
  if (ev_words < 1 || ev_words > n_ev_words(code_bits))
    return cudaErrorInvalidValue;
  const cudaError_t err = launch_walk(ch1, caps, bases, pred, succ, s0,
                                      table, tiles, cellrows, code_bits, sv,
                                      ends, stream);
  if (err != cudaSuccess) return err;
  return launch_pack(sv, ch1, caps, bases, tiles, cellrows, code_bits,
                     ev_words, src, ev, stream);
}
