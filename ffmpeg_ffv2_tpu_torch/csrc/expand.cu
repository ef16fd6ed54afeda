// K3 expand: stream-order per-pixel sv words -> per-slice rac op words.
//
// Replaces ffmpeg_ffv2_tpu/ffv1/expand_pallas.py:_expand_kernel
// (expand_pallas).  The TPU kernel walks 4096-op chunks in grid order and
// carries an SMEM record pointer from chunk to chunk; within a chunk it
// moves records to their op positions with a log-shift distribute and a
// segmented fill, because TPU lanes cannot store to data-dependent
// addresses.
//
// Bound: device memory.  At 1080p the call reads the diff (12.4 MB, twice)
// and the packed sv words a chunk needs, and writes every op word of the
// (S, op_cap) output once (~55 MB, the NOP fill up to op_cap included).
// Design: two kernels on one stream; CUDA blocks run in no order, so no
// block waits for another and every base is recomputed per block.
//  1. chunk_ops_kernel: one block a (slice, chunk of CHUNK pixels) sums
//     the chunk's op counts (1 for d = 0, else 2e + 3).
//  2. expand_kernel, one block a (slice, chunk): its first op position is
//     hpad + the earlier chunks' totals of its slice.  It stages the
//     chunk's diffs and the sv words its ops read in shared memory,
//     scans the counts into op offsets, then writes its op range
//     output-centric: a thread owns four consecutive 16-byte-aligned op
//     positions, finds their pixel by a binary search over the offsets
//     and stores them as one 16-byte word; only the range's ragged
//     first and last words take scalar stores.  Each op word belongs to
//     exactly one block, so no stores race.  Chunk 0 also writes the
//     prefix (the hlen[s] header ops, then NOPs up to hpad); tail blocks
//     (one a TAIL_OPS words of op_cap, up to MAX_TAIL_BLOCKS, launched
//     first) write the terminator (sv 129, bit 0), the two flush ops at
//     total..total+2, the NOPs up to op_cap and n_ops = total + 3.  Positions at or past op_cap are dropped (the encoder
//     retries with a larger op_cap).  Op k of a pixel reads byte k of
//     its emission-order sv words (0 past the W words carried).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4 * THREADS;   // pixels a block, four a thread
// tail blocks a slice: one a TAIL_OPS op words of op_cap, at most
// MAX_TAIL_BLOCKS
constexpr int TAIL_OPS = 65536;
constexpr int MAX_TAIL_BLOCKS = 32;
constexpr int MAX_WORDS = 16;        // sv words any op can read (k <= 63)
constexpr int TERMINATOR_SV = 129;

__device__ __forceinline__ int op_count(int d) {
  return d ? 2 * exponent_of(d < 0 ? -d : d) + 3 : 1;
}

// Sum (or max) of v over the block; every thread gets the result.
template <bool MAX>
__device__ int block_reduce(int v, int* red) {
  for (int o = 16; o; o >>= 1) {
    const int u = __shfl_xor_sync(~0u, v, o);
    v = MAX ? max(v, u) : v + u;
  }
  __syncthreads();                     // red may still be read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < THREADS / 32; ++w) v = MAX ? max(v, red[w]) : v + red[w];
  return v;
}

__global__ void chunk_ops_kernel(const int* __restrict__ diff, int npix,
                                 int nchunks, int* __restrict__ chunk_ops) {
  __shared__ int red[THREADS / 32];
  const int c = blockIdx.x, s = blockIdx.y;
  const int* d = diff + (size_t)s * npix;
  const int end = min(npix, (c + 1) * CHUNK);
  int v = 0;
  for (int i = c * CHUNK + threadIdx.x; i < end; i += THREADS)
    v += op_count(d[i]);
  v = block_reduce<false>(v, red);
  if (threadIdx.x == 0) chunk_ops[s * nchunks + c] = v;
}

// Store op words of flat positions [g0, g0 + 4) that fall in [lo, hi):
// one 16-byte store when all four do, else one store each.
__device__ __forceinline__ void store4(int* __restrict__ opw, size_t g0,
                                       size_t lo, size_t hi, const int* v) {
  if (g0 >= lo && g0 + 4 <= hi) {
    *reinterpret_cast<int4*>(opw + g0) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int k = 0; k < 4; ++k)
    if (g0 + k >= lo && g0 + k < hi) opw[g0 + k] = v[k];
}

__global__ void __launch_bounds__(THREADS)
expand_kernel(const int* __restrict__ words, int W,
              const int* __restrict__ diff, const int* __restrict__ svp,
              const int* __restrict__ btp, const int* __restrict__ hlen,
              int S, int npix, int hpad, int op_cap, int nchunks,
              int tail_blocks, const int* __restrict__ chunk_ops,
              int* __restrict__ opw, int* __restrict__ n_ops) {
  extern __shared__ int sm[];
  int* sdiff = sm;                     // [CHUNK] the chunk's diffs
  int* soff = sm + CHUNK;              // [CHUNK + 1] op offsets in the chunk
  int* sw = soff + CHUNK + 1;          // [min(W, MAX_WORDS)][CHUNK] sv words
  __shared__ int red[THREADS / 32];
  const int s = blockIdx.y, t = threadIdx.x;
  const int* co = chunk_ops + s * nchunks;
  const size_t row = (size_t)s * op_cap;
  const size_t row_end = row + op_cap;

  if ((int)blockIdx.x < tail_blocks) {
    // tail (the first blocks, so that the long fill starts early):
    // terminator, two flushes, NOPs to op_cap
    int v = 0;
    for (int j = t; j < nchunks; j += THREADS) v += co[j];
    const int total = hpad + block_reduce<false>(v, red);
    if (blockIdx.x == 0 && t == 0) n_ops[s] = total + 3;
    const size_t lo = row + min(total, op_cap);
    if (lo >= row_end) return;
    for (size_t q = (lo >> 2) + (size_t)blockIdx.x * THREADS + t;
         q <= (row_end - 1) >> 2; q += (size_t)tail_blocks * THREADS) {
      int val[4];
      for (int k = 0; k < 4; ++k) {
        const long long r = (long long)(q * 4 + k - row) - total;
        val[k] = r == 0 ? (MODE_OP << 9) | TERMINATOR_SV
                        : r == 1 ? MODE_FLUSH1 << 9
                                 : r == 2 ? MODE_FLUSH2 << 9 : 0;
      }
      store4(opw, q * 4, lo, row_end, val);
    }
    return;
  }

  const int c = blockIdx.x - tail_blocks;
  if (c == 0) {  // prefix: keyframe bit and headers, NOPs up to hpad
    const int n = min(hpad, op_cap), h = hlen[s];
    for (int r = t; r < n; r += THREADS) {
      const int i = s * hpad + r;
      opw[row + r] =
          r < h ? (svp[i] & 0xFF) | (btp[i] << 8) | (MODE_OP << 9) : 0;
    }
  }

  // the chunk's first op position: hpad + the earlier chunks' ops
  int v = 0;
  for (int j = t; j < c; j += THREADS) v += co[j];
  const int first = hpad + block_reduce<false>(v, red);
  if (first >= op_cap) return;         // every op of the chunk is dropped

  const int p0 = c * CHUNK;
  const int n = min(CHUNK, npix - p0);
  const int* dsrc = diff + (size_t)s * npix + p0;
  for (int i = t; i < n; i += THREADS) sdiff[i] = dsrc[i];
  __syncthreads();

  // exclusive scan of the counts, four contiguous pixels a thread
  int cnt[4], sum = 0, mx = 0;
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * t + k;
    cnt[k] = i < n ? op_count(sdiff[i]) : 0;
    sum += cnt[k];
    mx = max(mx, cnt[k]);
  }
  int incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(~0u, incl, o);
    if ((t & 31) >= o) incl += u;
  }
  __shared__ int wsum[THREADS / 32];
  if ((t & 31) == 31) wsum[t >> 5] = incl;
  __syncthreads();
  int off = incl - sum;
  for (int w = 0; w < (t >> 5); ++w) off += wsum[w];
  for (int k = 0; k < 4; ++k) {
    soff[4 * t + k] = off;
    off += cnt[k];
  }
  if (t == THREADS - 1) soff[CHUNK] = off;   // the chunk's op count

  // the sv words the chunk's ops read: ceil(max count / 4), at most W
  const int nw = min(min(W, MAX_WORDS), (block_reduce<true>(mx, red) + 3) >> 2);
  for (int w = 0; w < nw; ++w) {
    const int* src = words + ((size_t)w * S + s) * npix + p0;
    for (int i = t; i < n; i += THREADS) sw[w * CHUNK + i] = src[i];
  }
  __syncthreads();

  const size_t lo = row + first;
  const size_t hi = row + min(first + soff[CHUNK], op_cap);
  if (hi <= lo) return;
  for (size_t q = (lo >> 2) + t; q <= (hi - 1) >> 2; q += THREADS) {
    // the pixel of the first owned position: the last offset <= it
    const int rel0 = (int)((q * 4 > lo ? q * 4 : lo) - lo);
    int a = 0, b = n - 1;
    while (a < b) {
      const int m = (a + b + 1) >> 1;
      if (soff[m] <= rel0) a = m; else b = m - 1;
    }
    int beg = soff[a], end = soff[a + 1], d = sdiff[a];
    int val[4];
    for (int k = 0; k < 4; ++k) {
      const size_t g = q * 4 + k;
      val[k] = 0;
      if (g < lo || g >= hi) continue;
      const int rel = (int)(g - lo);
      if (rel >= end) {  // the next pixel (counts >= 1: one step at most)
        ++a;
        beg = end;
        end = soff[a + 1];
        d = sdiff[a];
      }
      const int kk = rel - beg;
      const int m = d < 0 ? -d : d;
      const int e = exponent_of(m);
      int bit;
      if (kk == 0)
        bit = d == 0;
      else if (kk <= e)
        bit = 1;
      else if (kk == e + 1)
        bit = 0;
      else if (kk <= 2 * e + 1)
        bit = (m >> (2 * e + 1 - kk)) & 1;
      else
        bit = d < 0;
      const int w = kk >> 2;
      const int sv = w < nw ? (sw[w * CHUNK + a] >> ((kk & 3) * 8)) & 0xFF : 0;
      val[k] = sv | (bit << 8) | (MODE_OP << 9);
    }
    store4(opw, q * 4, lo, hi, val);
  }
}

}  // namespace

extern "C" cudaError_t ffv2_expand(const int* words, int W, const int* diff,
                                   const int* svp, const int* btp,
                                   const int* hlen, int S, int npix, int hpad,
                                   int op_cap, int* chunk_ops, int* opw,
                                   int* n_ops, cudaStream_t stream) {
  if (S <= 0) return cudaGetLastError();
  // one chunk at least, so that chunk 0 writes the prefix of an empty row
  const int nchunks = max(1, (npix + CHUNK - 1) / CHUNK);
  const size_t smem =
      sizeof(int) * (2 * CHUNK + 1 + (size_t)min(W, MAX_WORDS) * CHUNK);
  cudaError_t err = cudaFuncSetAttribute(
      expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  chunk_ops_kernel<<<dim3(nchunks, S), THREADS, 0, stream>>>(diff, npix,
                                                             nchunks,
                                                             chunk_ops);
  // tail blocks a slice: one a TAIL_OPS words of the row
  const int tail_blocks = max(1, min(MAX_TAIL_BLOCKS, op_cap / TAIL_OPS));
  expand_kernel<<<dim3(tail_blocks + nchunks, S), THREADS, smem, stream>>>(
      words, W, diff, svp, btp, hlen, S, npix, hpad, op_cap, nchunks,
      tail_blocks, chunk_ops, opw, n_ops);
  return cudaGetLastError();
}
