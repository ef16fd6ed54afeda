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
// Design: one warp per (root tile, lane); thread t holds permuted slot row
// t (slot 4*(t&7) + (t>>3), host.SLOT_AT_ROW), so the 32 states of the lane
// stay in registers.  The 512-byte transition table sits in shared memory.
// The carry is removed: a root tile (tile_pred < 0) walks its lane on
// through the successor tiles (succ, the inverse of tile_pred, built by the
// wrapper), keeping the state in registers where the lane's continuation
// flag (s0[tile][32][lane]) is set -- no state passes between blocks.  Warps
// of non-root tiles exit at once.  Each warp reads 32 rows of its lane with
// one load per thread and broadcasts them by shuffles, so the chain waits
// on memory once per 32 rows.
// K2 output: the 8 packed sv words of a cell are put together by shuffles
// (device_coder.pack_sv_words); the repeat sub-steps' pre-update pairs
// sv10 | sv31 << 8 pack two to a word after them (warp OR reductions).
// K6 output: each thread places its slot's pre-update byte at the slot's
// emission index kk (adapt_pallas.py:117-130), the slot-10 and slot-31
// threads add their repeat bytes at k = 10 + j and e + 2 + j, and word m of
// the cell is the warp OR of the bytes that land in it, for m < ev_words.
// As in the TPU kernel, bytes past ev_words words are dropped and the
// slot-31 repeat bytes land by adding.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Validity and coded bit of this thread's slot for one pixel diff v
// (device_coder.slot_bit_grid; first hits, with the e > 9 caps of slots 10
// and 31).
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

// Emission index of this slot's first hit in the pixel's rac-op stream:
// slot 0 -> 0; exponent slot j -> j; sign -> 2e + 2; mantissa slot 22 + i
// -> 2e + 1 - i, except slot 31's first hit when e > 9, at k = e + 2.
__device__ __forceinline__ int first_hit_k(int slot, int e) {
  if (slot <= 10) return slot;
  if (slot < 22) return 2 * e + 2;
  return (slot == 31 && e > 9) ? e + 2 : 2 * e + 1 - (slot - 22);
}

// R: repeat sub-steps per row (code_bits - 10, or 0).  NW: the most
// emission-order words a cell can have at this depth (n_ev_words).
template <int R, bool kEmission>
__global__ void __launch_bounds__(128)
adapt_kernel(const int* __restrict__ ch1, const int* __restrict__ caps,
             const int* __restrict__ bases, const int* __restrict__ pred,
             const int* __restrict__ succ, const int* __restrict__ s0,
             const int* __restrict__ table, int tiles, int cellrows,
             int mask, int bias, int vbit, int out_words,
             int* __restrict__ out, int* __restrict__ ends) {
  constexpr int NW = (12 + R) / 2;
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
        const int v = (row & mask) - bias;
        const int ok = (row >> vbit) & 1;
        int valid, bit;
        slot_hit(slot, v, &valid, &bit);
        valid &= ok;
        const int pre = valid ? s : 0;
        if (valid) s = tab[(bit << 8) | s];
        // repeat hits of slots 10/31 (e > 9): sub-step jj is hit jj + 1;
        // only the threads of slot 10 (t = 18) and slot 31 (t = 31) move
        const int a = v < 0 ? -v : v;
        const int e = exponent_of(a);
        int rep[R > 0 ? R : 1];
#pragma unroll
        for (int jj = 1; jj <= R; ++jj) {
          int vj = 0, bj = 0;
          if (slot == 10) {
            vj = ok && e >= 9 + jj;
            bj = e >= jj + 10;
          } else if (slot == 31) {
            vj = ok && e >= 10 + jj;
            bj = (a >> max(e - 1 - jj, 0)) & 1;
          }
          rep[jj - 1] = vj ? s : 0;
          if (vj) s = tab[(bj << 8) | s];
        }
        const size_t cell = (size_t)(base + r0 + j) * out_words;
        if (!kEmission) {
          const unsigned b0 = __shfl_sync(FULL, pre, t & 7);
          const unsigned b1 = __shfl_sync(FULL, pre, (t & 7) + 8);
          const unsigned b2 = __shfl_sync(FULL, pre, (t & 7) + 16);
          const unsigned b3 = __shfl_sync(FULL, pre, (t & 7) + 24);
          if (t < 8)
            out[(cell + t) * 128 + lane] =
                (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
#pragma unroll
          for (int w = 0; w < (R + 1) / 2; ++w) {
            // pairs 2w and 2w + 1 (sub-steps 2w + 1, 2w + 2)
            const unsigned hi = 2 * w + 1 < R ? (unsigned)rep[2 * w + 1] : 0;
            unsigned part = 0;
            if (slot == 10) part = (unsigned)rep[2 * w] | (hi << 16);
            if (slot == 31) part = ((unsigned)rep[2 * w] << 8) | (hi << 24);
            const unsigned word = __reduce_or_sync(FULL, part);
            if (t == 8 + w) out[(cell + 8 + w) * 128 + lane] = (int)word;
          }
        } else {
          unsigned orv[NW], addv[NW];
          const int kk = first_hit_k(slot, e);
#pragma unroll
          for (int m = 0; m < NW; ++m) {
            orv[m] = (kk >> 2) == m ? (unsigned)pre << ((kk & 3) * 8) : 0u;
            addv[m] = 0;
          }
#pragma unroll
          for (int jj = 1; jj <= R; ++jj) {
            if (slot == 10) {
              const int k10 = 10 + jj;
#pragma unroll
              for (int m = 0; m < NW; ++m)
                if ((k10 >> 2) == m)
                  orv[m] |= (unsigned)rep[jj - 1] << ((k10 & 3) * 8);
            } else if (slot == 31) {
              const int k31 = e + 2 + jj;
#pragma unroll
              for (int m = 0; m < NW; ++m)
                if ((k31 >> 2) == m)
                  addv[m] += (unsigned)rep[jj - 1] << ((k31 & 3) * 8);
            }
          }
#pragma unroll
          for (int m = 0; m < NW; ++m) {
            if (m < out_words) {
              const unsigned word = __reduce_or_sync(FULL, orv[m]) +
                                    __shfl_sync(FULL, addv[m], 31);
              if (t == m) out[(cell + m) * 128 + lane] = (int)word;
            }
          }
        }
      }
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
  // one warp per (tile, lane): 128 lanes x 32 threads per tile
  const unsigned blocks = (unsigned)((long long)tiles * 128 * 32 / 128);
#define FFV2_ADAPT_CASE(R)                                                 \
  case R:                                                                  \
    adapt_kernel<R, kEmission><<<blocks, 128, 0, stream>>>(                \
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
