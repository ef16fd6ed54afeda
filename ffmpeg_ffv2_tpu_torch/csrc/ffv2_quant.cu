// K18 pvq: FFV2's quantizer on the card: each block's DC, the PVQ pulses
// of every band and the exact split sums of each band's energy.
//
// Replaces ffmpeg_ffv2_tpu/ffv2/tpu.py:_pvq_band_device (:233, a lax.scan
// of qp pulse steps over a tournament argmax) and the rest of
// _quantize_streams (:293-318): XLA on the TPU, no Pallas body.  There
// every step of the scan runs over all blocks of a band at once, padded
// to a power of two, and picks each block's position by a log2 tournament
// over the padded lanes.
//
// Here one block of 256 threads takes one (row, band): a row is one
// n x n block's coefficient stream in coding order, [DC, AC...], and AC
// position j of band [lo, hi) is streams[row, 1 + j] (the last band's
// phantom position, past n * n - 1, reads 0).  Each thread keeps the
// magnitudes and pulse counts of its ITEMS positions (lo + tid, lo + tid
// + 256, ...) in registers, so the loads are coalesced and nothing is
// written until the last step.  The block
//  1. reduces the band's largest magnitude and its three split sums
//     (|x| >> 9 and |x| & 511 squared and crossed, uint32 sums: JAX's
//     int32 sums mod 2^32), and takes the prescale shift from the float32
//     exponent of the maximum, as JAX does (the bit length below 2^24);
//  2. runs qp pulse steps: each thread scores its positions (a = (xy +
//     ax)^2, b = yy + 2 y + 1, q = a // b, r = a - q b), keeps its best
//     under JAX's order, and the block reduces (warp shuffles, then one
//     warp over the warps' winners); the winner's thread adds the pulse,
//     and every thread updates xy += ax and yy = b.
// JAX's order is a total one (larger q, then the larger cross product
// r * b_other, then the lower index), so any reduction tree picks JAX's
// winner.  A position is a candidate while y < qp - 1; when no candidate
// is left (JAX's `ok` false) nothing changes again and the loop ends.
// Pulses are y times the sign of the coefficient, cast to int8 (exact:
// |y| < qp).
//
// Bound: operations; about 8 integer operations (one a division) a
// position a pulse step, qp steps a band; the bytes (25 MB of streams in
// and 6 MB of pulses out at 1080p yuv444p) take a third of that time.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BANDS = 16;

struct Bands {
  int start[MAX_BANDS + 1];
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// jnp's // on int32 (b != 0: b = yy + 2 y + 1 >= 1)
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if (a % b != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}

struct Cand {
  int q, r, b, i, ax;
};

__device__ __forceinline__ Cand none() { return Cand{INT_MIN, 0, 1, INT_MAX, 0}; }

// tpu.py:270-274: the left operand wins the tournament's pair
__device__ __forceinline__ bool better(const Cand& l, const Cand& r) {
  if (l.q != r.q) return l.q > r.q;
  const int cl = wmul(l.r, r.b), cr = wmul(r.r, l.b);
  if (cl != cr) return cl > cr;
  return l.i < r.i;
}

__device__ __forceinline__ Cand warp_best(Cand c) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    Cand o;
    o.q = __shfl_down_sync(0xffffffffu, c.q, off);
    o.r = __shfl_down_sync(0xffffffffu, c.r, off);
    o.b = __shfl_down_sync(0xffffffffu, c.b, off);
    o.i = __shfl_down_sync(0xffffffffu, c.i, off);
    o.ax = __shfl_down_sync(0xffffffffu, c.ax, off);
    if (better(o, c)) c = o;
  }
  return c;                                    // lane 0 holds the best
}

template <int ITEMS>
__global__ void __launch_bounds__(THREADS)
    pvq_kernel(const int* __restrict__ streams, int n2, Bands bands, int qp,
               int* __restrict__ dc, int8_t* __restrict__ pulses,
               int* __restrict__ sums, int plen, int nbands) {
  __shared__ int s_max[WARPS];
  __shared__ unsigned s_sum[3][WARPS];
  __shared__ int s_shift;
  __shared__ Cand s_cand[WARPS];
  __shared__ Cand s_win;

  const int row = blockIdx.x, band = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lo = bands.start[band], L = bands.start[band + 1] - lo;
  const int* __restrict__ s = streams + (long long)row * n2;
  if (band == 0 && tid == 0) dc[row] = s[0];

  // 1. magnitudes, the band's maximum, the split sums
  int ax[ITEMS], y[ITEMS];
  int mx = INT_MIN;
  unsigned hh = 0, hl = 0, ll = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = tid + k * THREADS, j = lo + p;
    const int v = (p < L && 1 + j < n2) ? s[1 + j] : 0;
    const int a = v < 0 ? wsub(0, v) : v;      // jnp.abs: INT_MIN stays
    ax[k] = a;
    y[k] = 0;
    if (p < L) {
      mx = max(mx, a);
      const unsigned h = (unsigned)(a >> 9), l = (unsigned)(a & 511);
      hh += h * h;
      hl += h * l;
      ll += l * l;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    mx = max(mx, __shfl_down_sync(0xffffffffu, mx, off));
    hh += __shfl_down_sync(0xffffffffu, hh, off);
    hl += __shfl_down_sync(0xffffffffu, hl, off);
    ll += __shfl_down_sync(0xffffffffu, ll, off);
  }
  if (lane == 0) {
    s_max[warp] = mx;
    s_sum[0][warp] = hh;
    s_sum[1][warp] = hl;
    s_sum[2][warp] = ll;
  }
  __syncthreads();
  if (tid == 0) {
    int m = s_max[0];
    unsigned t0 = s_sum[0][0], t1 = s_sum[1][0], t2 = s_sum[2][0];
    for (int w = 1; w < WARPS; ++w) {
      m = max(m, s_max[w]);
      t0 += s_sum[0][w];
      t1 += s_sum[1][w];
      t2 += s_sum[2][w];
    }
    int* out = sums + ((long long)row * nbands + band) * 3;
    out[0] = (int)t0;
    out[1] = (int)t1;
    out[2] = (int)t2;
    // tpu.py:244-246: the bit length from the float32 exponent
    const int bl = (__float_as_int((float)max(m, 1)) >> 23) - 126;
    s_shift = max(bl - 8, 0);
  }
  __syncthreads();
  const int shift = s_shift;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) ax[k] >>= shift;

  // 2. the pulse steps
  int xy = 0, yy = 0;
  for (int step = 0; step < qp; ++step) {
    Cand best = none();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int p = tid + k * THREADS;
      if (p < L && y[k] < qp - 1) {
        const int sx = wadd(xy, ax[k]);
        const int a = wmul(sx, sx);
        const int b = wadd(wadd(yy, wmul(2, y[k])), 1);
        const int q = floor_div(a, b);
        const Cand c{q, wsub(a, wmul(q, b)), b, p, ax[k]};
        if (better(c, best)) best = c;
      }
    }
    best = warp_best(best);
    if (lane == 0) s_cand[warp] = best;
    __syncthreads();
    if (warp == 0) {
      Cand c = lane < WARPS ? s_cand[lane] : none();
      c = warp_best(c);
      if (lane == 0) s_win = c;
    }
    __syncthreads();
    const Cand w = s_win;
    if (w.q < 0) break;                        // JAX's ok is false
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (tid + k * THREADS == w.i) ++y[k];
    xy = wadd(xy, w.ax);
    yy = w.b;                                  // yy + 2 (y + 1) - 1
  }

  int8_t* out = pulses + (long long)row * plen + (lo - bands.start[0]);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = tid + k * THREADS, j = lo + p;
    if (p < L) {
      const int v = 1 + j < n2 ? s[1 + j] : 0;
      const int sg = (v > 0) - (v < 0);
      out[p] = (int8_t)(y[k] * sg);
    }
  }
}

}  // namespace

// streams: int32 [NB, n2] in coding order; band_starts: nbands + 1 AC
// offsets in host memory (dsp.band_starts, the last one may pass n2 - 1:
// the phantom position); dc: int32 [NB]; pulses: int8 [NB, plen] with
// plen = band_starts[nbands] - band_starts[0]; sums: int32 [NB, nbands, 3].
extern "C" cudaError_t ffv2_pvq(const int* streams, int NB, int n2,
                                const int* band_starts, int nbands, int qp,
                                int* dc, int8_t* pulses, int* sums, int plen,
                                cudaStream_t stream) {
  if (nbands < 1 || nbands > MAX_BANDS || NB < 0 || qp < 0)
    return cudaErrorInvalidValue;
  Bands b;
  int max_len = 0;
  for (int i = 0; i <= nbands; ++i) b.start[i] = band_starts[i];
  for (int i = 0; i < nbands; ++i) {
    const int len = b.start[i + 1] - b.start[i];
    if (len < 0) return cudaErrorInvalidValue;
    max_len = len > max_len ? len : max_len;
  }
  if (plen != b.start[nbands] - b.start[0]) return cudaErrorInvalidValue;
  if (NB == 0) return cudaGetLastError();
  const dim3 grid(NB, nbands);
#define PVQ_LAUNCH(N)                                                       \
  pvq_kernel<N><<<grid, THREADS, 0, stream>>>(streams, n2, b, qp, dc,       \
                                              pulses, sums, plen, nbands)
  if (max_len <= THREADS)
    PVQ_LAUNCH(1);
  else if (max_len <= 2 * THREADS)
    PVQ_LAUNCH(2);
  else if (max_len <= 4 * THREADS)
    PVQ_LAUNCH(4);
  else if (max_len <= 9 * THREADS)             // n = 64: 2049 positions
    PVQ_LAUNCH(9);
  else if (max_len <= 16 * THREADS)
    PVQ_LAUNCH(16);
  else
    return cudaErrorInvalidValue;
#undef PVQ_LAUNCH
  return cudaGetLastError();
}
