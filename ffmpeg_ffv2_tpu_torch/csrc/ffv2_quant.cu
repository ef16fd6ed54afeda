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
// A row is one n x n block's coefficient stream in coding order, [DC,
// AC...], and AC position j of band [lo, hi) is streams[row, 1 + j] (the
// last band's phantom position, past n * n - 1, reads 0).  Per (row, band)
// the work is
//  1. the band's largest magnitude and its three split sums (|x| >> 9 and
//     |x| & 511 squared and crossed, uint32 sums: JAX's int32 sums mod
//     2^32), and the prescale shift from the float32 exponent of the
//     maximum, as JAX does (the bit length below 2^24);
//  2. qp pulse steps: each position scores a = (xy + ax)^2 over b = yy +
//     2 y + 1, and the best under JAX's order (larger q = a // b, then the
//     larger cross product r * b_other, then the lower index) takes a
//     pulse; xy += ax and yy = b of the winner.  A position is a candidate
//     while y < qp - 1; when none is left (JAX's `ok` false) nothing
//     changes again and the loop ends.
// Pulses are y times the sign of the coefficient, cast to int8.
//
// Bound: operations, about 8 integer operations a position a step, qp
// steps a band (1530 rows x 4095 positions x 16 steps at 1080p yuv444p qp
// 16: 0.012 ms at 67 T/s); the chain is qp steps of the band's argmax.
// The bands differ 256-fold in length (8 to 2049 positions at n = 64).
// Design: a warp a (row, band), 8 a block, with the positions a lane
// (ITEMS) sized to the band's class, one launch a class present (kShapes:
// bands of <= 32, 64, 128, 160, 512, 544, 2080 positions take 1, 2, 4,
// 5, 16, 17, 65 a lane; the transform sizes stop at 64, whose longest
// band holds 2049, so longer bands are refused).  Where qp <= 128 and no
// magnitude is INT_MIN (every frame), the division is dropped: q then
// r * b_other ordered with no int32 wrap is the order of the fractions
// a / b, compared as a * b_other against a_other * b in 64 bits.  Nothing
// wraps there: the prescale keeps ax in [0, 256), so at step s < qp, xy
// <= 255 s and a <= (255 qp)^2 < 2^31; b <= (s + 1)^2 <= 2^14, so r *
// b_other < 2^28 (tests/test_torch_ffv2.py checks the equivalence on that
// range).  Then a step is one max of the positions with no pulse (they
// share b, so the largest ax wins: a key of ax and the index, redux.sync)
// and a butterfly over the few positions with pulses (a list in
// registers) (list_steps, for 16 or more positions a lane).  Otherwise
// (scan_steps: the bands of up to 160 positions, and any band in JAX's
// order with its division) every position is scored every step and a
// butterfly of shuffles picks the best.  No step needs a barrier.  JAX's
// order is a total one while r * b_other cannot wrap (b <= qp^2, so up to
// qp = 215), so any reduction tree picks JAX's winner; past that no tree
// but JAX's own is sure to.

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;       // (row, band)s a block
constexpr int MAX_BANDS = 16;
constexpr int FAST_QP = 128;
constexpr int LIST = 4;                 // list slots a lane (list_steps)
constexpr int SMALL_ITEMS = 8;          // past it, list_steps

// the classes of band lengths, in launch order (the one holding band 0
// writes the DC): the longest band of the class and its positions a lane
struct Shape {
  int cap, items;
};
constexpr Shape kShapes[] = {{32, 1},   {64, 2},   {128, 4},   {160, 5},
                             {512, 16}, {544, 17}, {2080, 65}};
constexpr int NCLASS = sizeof(kShapes) / sizeof(kShapes[0]);

struct Bands {
  int start[MAX_BANDS + 1];
};

// the bands of one class, in order
struct Class {
  int count;
  int band[MAX_BANDS];
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
// jnp.abs on int32: INT_MIN stays
__device__ __forceinline__ int wabs(int v) { return v < 0 ? wsub(0, v) : v; }
// AC position j of a row (0 past the stream: the phantom position).  The
// load itself is clamped into the row and never skipped, so a thread's
// loads of its positions issue together instead of one branch each.
__device__ __forceinline__ int coeff(const int* s, int n2, int j) {
  const int v = s[min(1 + j, n2 - 1)];
  return 1 + j < n2 ? v : 0;
}
// jnp's // on int32 (b != 0: b = yy + 2 y + 1 >= 1)
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if (a % b != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}

// a position's score a / b and its index; no candidate is (-1, 1), which
// loses to every candidate in both orders and stops the loop if it wins
struct Cand {
  int a, b, i;
};

__device__ __forceinline__ Cand none() { return Cand{-1, 1, INT_MAX}; }

// l beats r: JAX's order (tpu.py:270-274); FAST: the same order as the
// fractions, where nothing wraps (the note above)
template <bool FAST>
__device__ __forceinline__ bool better(const Cand& l, const Cand& r) {
  if (FAST) {
    const long long cl = (long long)l.a * r.b, cr = (long long)r.a * l.b;
    if (cl != cr) return cl > cr;
    return l.i < r.i;
  }
  const int ql = floor_div(l.a, l.b), qr = floor_div(r.a, r.b);
  if (ql != qr) return ql > qr;
  const int cl = wmul(wsub(l.a, wmul(ql, l.b)), r.b);
  const int cr = wmul(wsub(r.a, wmul(qr, r.b)), l.b);
  if (cl != cr) return cl > cr;
  return l.i < r.i;
}

// the best of the warp's lanes (every lane gets it)
template <bool FAST>
__device__ __forceinline__ Cand xor_best(Cand c) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Cand o;
    o.a = __shfl_xor_sync(0xffffffffu, c.a, off);
    o.b = __shfl_xor_sync(0xffffffffu, c.b, off);
    o.i = __shfl_xor_sync(0xffffffffu, c.i, off);
    if (better<FAST>(o, c)) c = o;
  }
  return c;
}

// 2 + (ax << 12 | 4095 - p) for position p with no pulse yet (the largest
// key is the largest ax, then the lowest p); 1 for a position that is never
// a candidate (qp < 2); 0 for one that has pulses (or lies past the band)
__device__ __forceinline__ unsigned zero_key(int ax, int p) {
  return 2u + ((unsigned)ax << 12 | (unsigned)(4095 - p));
}

// The pulse steps in the order without division (qp <= 128, every
// magnitude >= 0) for more than SMALL_ITEMS positions a lane: the
// positions with no pulse share b = yy + 1 and score
// (xy + ax)^2, so their best is the largest ax (then the lowest index): one
// max of the keys a step (redux.sync).  The positions with pulses, at most
// one more a step, are a list, entry e on lane e % 32, slot e / 32 (LIST
// slots: 128 entries), scored in full and reduced by a butterfly.  The
// winner is the better of the two.  Positions never pulsed write 0, the
// list writes its counts.
template <int ITEMS>
__device__ __forceinline__ void list_steps(const int (&ax)[ITEMS], int lane,
                                           int L, int qp, const int* s,
                                           int n2, int lo, int8_t* out) {
  unsigned key[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = lane + k * 32;
    key[k] = p < L ? (qp >= 2 ? zero_key(ax[k], p) : 1u) : 0u;
  }
  int lpos[LIST], lax[LIST], ly[LIST];
#pragma unroll
  for (int j = 0; j < LIST; ++j) lpos[j] = lax[j] = ly[j] = 0;
  int m = 0, xy = 0, yy = 0;
  for (int step = 0; step < qp; ++step) {
    unsigned acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) acc[k & 3] = max(acc[k & 3], key[k]);
    const unsigned k0 = __reduce_max_sync(
        0xffffffffu, max(max(acc[0], acc[1]), max(acc[2], acc[3])));
    Cand best = none();
    int bax = 0;
    if (k0 >= 2) {
      bax = (int)((k0 - 2) >> 12);
      const int sx = xy + bax;
      best = Cand{sx * sx, yy + 1, 4095 - (int)((k0 - 2) & 4095)};
    }
    bool listed = false;
    if (m > 0) {
      Cand c = none();
#pragma unroll
      for (int j = 0; j < LIST; ++j) {
        if (j * 32 < m && j * 32 + lane < m && ly[j] < qp - 1) {
          const int sx = xy + lax[j];
          const Cand t{sx * sx, yy + 2 * ly[j] + 1, lpos[j]};
          if (better<true>(t, c)) c = t;
        }
      }
      c = xor_best<true>(c);
      if (better<true>(c, best)) {
        best = c;
        listed = true;
      }
    }
    if (best.a < 0) break;                     // JAX's ok is false
    if (listed) {                              // one more pulse
      int has = 0, hax = 0;
#pragma unroll
      for (int j = 0; j < LIST; ++j) {
        if (j * 32 + lane < m && lpos[j] == best.i) {
          ++ly[j];
          has = 1;
          hax = lax[j];
        }
      }
      bax = __shfl_sync(0xffffffffu, hax,
                        __ffs(__ballot_sync(0xffffffffu, has)) - 1);
    } else {                                   // a new entry, its first
#pragma unroll
      for (int j = 0; j < LIST; ++j) {
        if (j == m >> 5 && lane == (m & 31)) {
          lpos[j] = best.i;
          lax[j] = bax;
          ly[j] = 1;
        }
      }
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
        if (lane + k * 32 == best.i) key[k] = 0;
      ++m;
    }
    xy += bax;
    yy = best.b;                               // yy + 2 (y + 1) - 1
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = lane + k * 32;
    if (p < L && key[k] != 0) out[p] = 0;
  }
#pragma unroll
  for (int j = 0; j < LIST; ++j) {
    if (j * 32 + lane < m) {
      const int v = coeff(s, n2, lo + lpos[j]);
      out[lpos[j]] = (int8_t)(ly[j] * ((v > 0) - (v < 0)));
    }
  }
}

// The pulse steps with every position scored every step, in the order
// without division (FAST) or in JAX's with it: the best by a butterfly of
// shuffles.  Up to SMALL_ITEMS positions a lane keep their magnitudes and
// counts in registers; past that (a large band in JAX's order: a band
// holding INT_MIN or a qp past 128) the counts live in local memory and
// the magnitudes are read again, so the rare path costs the kernel no
// registers.
template <bool FAST, int ITEMS>
__device__ __forceinline__ void scan_steps(const int (&ax)[ITEMS], int lane,
                                           int L, int qp, int shift,
                                           const int* s, int n2, int lo,
                                           int8_t* out) {
  constexpr bool REG = ITEMS <= SMALL_ITEMS;
  int y[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) y[k] = 0;
  int xy = 0, yy = 0;
  for (int step = 0; step < qp; ++step) {
    Cand best = none();
#pragma unroll(REG ? ITEMS : 1)
    for (int k = 0; k < ITEMS; ++k) {
      const int p = lane + k * 32;
      if (p < L && y[k] < qp - 1) {
        int a;
        if constexpr (REG)
          a = ax[k];
        else
          a = wabs(coeff(s, n2, lo + p)) >> shift;
        const int sx = wadd(xy, a);
        const Cand c{wmul(sx, sx), wadd(wadd(yy, wmul(2, y[k])), 1), p};
        if (better<FAST>(c, best)) best = c;   // ties keep the lower index
      }
    }
    best = xor_best<FAST>(best);
    if (FAST ? best.a < 0 : floor_div(best.a, best.b) < 0)
      break;                                   // JAX's ok is false
#pragma unroll(REG ? ITEMS : 1)
    for (int k = 0; k < ITEMS; ++k)
      if (lane + k * 32 == best.i) ++y[k];
    xy = wadd(xy, wabs(coeff(s, n2, lo + best.i)) >> shift);
    yy = best.b;                               // yy + 2 (y + 1) - 1
  }
#pragma unroll(REG ? ITEMS : 1)
  for (int k = 0; k < ITEMS; ++k) {
    const int p = lane + k * 32;
    if (p < L) {
      const int v = coeff(s, n2, lo + p);
      out[p] = (int8_t)(y[k] * ((v > 0) - (v < 0)));
    }
  }
}

template <int ITEMS>
__global__ void __launch_bounds__(BLOCK)
    pvq_class(const int* __restrict__ streams, int NB, int n2,
              const __grid_constant__ Bands bands,
              const __grid_constant__ Class cls, int qp, int* __restrict__ dc,
              int8_t* __restrict__ pulses, int* __restrict__ sums, int plen,
              int nbands) {
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * WARPS + threadIdx.x / 32;
  if (g >= NB * cls.count) return;            // the whole warp leaves
  const int row = g / cls.count, band = cls.band[g % cls.count];
  const int lo = bands.start[band], L = bands.start[band + 1] - lo;
  const int* __restrict__ s = streams + (long long)row * n2;
  if (band == 0 && lane == 0) dc[row] = s[0];

  // 1. magnitudes, the band's maximum, the split sums
  int ax[ITEMS];
  int mx = INT_MIN, neg = 0;
  unsigned hh = 0, hl = 0, ll = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = lane + k * 32;
    const int v = coeff(s, n2, lo + p);
    const int a = p < L ? wabs(v) : 0;
    ax[k] = a;
    if (p < L) {
      mx = max(mx, a);
      neg |= a < 0;
      const unsigned h = (unsigned)(a >> 9), l = (unsigned)(a & 511);
      hh += h * h;
      hl += h * l;
      ll += l * l;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    neg |= __shfl_xor_sync(0xffffffffu, neg, off);
    hh += __shfl_xor_sync(0xffffffffu, hh, off);
    hl += __shfl_xor_sync(0xffffffffu, hl, off);
    ll += __shfl_xor_sync(0xffffffffu, ll, off);
  }
  if (lane == 0) {
    int* out = sums + ((long long)row * nbands + band) * 3;
    out[0] = (int)hh;
    out[1] = (int)hl;
    out[2] = (int)ll;
  }
  // tpu.py:244-246: the bit length from the float32 exponent
  const int bl = (__float_as_int((float)max(mx, 1)) >> 23) - 126;
  const int shift = max(bl - 8, 0);

  // 2. the pulse steps
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) ax[k] >>= shift;
  int8_t* out = pulses + (long long)row * plen + (lo - bands.start[0]);
  if (qp <= FAST_QP && !neg) {
    if constexpr (ITEMS <= SMALL_ITEMS)
      scan_steps<true, ITEMS>(ax, lane, L, qp, shift, s, n2, lo, out);
    else
      list_steps<ITEMS>(ax, lane, L, qp, s, n2, lo, out);
  } else {
    scan_steps<false, ITEMS>(ax, lane, L, qp, shift, s, n2, lo, out);
  }
}

// the class of a band of `len` positions (an index of kShapes), -1 past
// the longest class
int class_of(int len) {
  for (int c = 0; c < NCLASS; ++c)
    if (len <= kShapes[c].cap) return c;
  return -1;
}

}  // namespace

// K18's class of a band of `len` positions (-1: refused) and a class's
// positions a lane, for the tools that label and time the classes
extern "C" int ffv2_pvq_class_of(int len) {
  return len < 0 ? -1 : class_of(len);
}

extern "C" int ffv2_pvq_class_items(int c) {
  return c >= 0 && c < NCLASS ? kShapes[c].items : 0;
}

// streams: int32 [NB, n2] in coding order; band_starts: nbands + 1 AC
// offsets in host memory (dsp.band_starts, the last one may pass n2 - 1:
// the phantom position); dc: int32 [NB]; pulses: int8 [NB, plen] with
// plen = band_starts[nbands] - band_starts[0]; sums: int32 [NB, nbands, 3].
// One kernel launch a class of band lengths present (4 at n = 64), each
// counted in ffv2_kernel_launches.
extern "C" cudaError_t ffv2_pvq(const int* streams, int NB, int n2,
                                const int* band_starts, int nbands, int qp,
                                int* dc, int8_t* pulses, int* sums, int plen,
                                cudaStream_t stream) {
  if (nbands < 1 || nbands > MAX_BANDS || NB < 0 || qp < 0)
    return cudaErrorInvalidValue;
  Bands b;
  for (int i = 0; i <= nbands; ++i) b.start[i] = band_starts[i];
  Class cls[NCLASS] = {};
  for (int i = 0; i < nbands; ++i) {
    const int c = ffv2_pvq_class_of(b.start[i + 1] - b.start[i]);
    if (c < 0) return cudaErrorInvalidValue;
    cls[c].band[cls[c].count++] = i;
  }
  if (plen != b.start[nbands] - b.start[0]) return cudaErrorInvalidValue;
  if (NB == 0) return cudaGetLastError();
  for (int c = 0; c < NCLASS; ++c) {
    if (!cls[c].count) continue;
    const long long warps = (long long)NB * cls[c].count;
    const int grid = (int)((warps + WARPS - 1) / WARPS);
#define PVQ_LAUNCH(C)                                                     \
  pvq_class<kShapes[C].items><<<grid, BLOCK, 0, stream>>>(                \
      streams, NB, n2, b, cls[c], qp, dc, pulses, sums, plen, nbands)
    static_assert(NCLASS == 7, "a case of the switch a class");
    switch (c) {
      case 0: PVQ_LAUNCH(0); break;
      case 1: PVQ_LAUNCH(1); break;
      case 2: PVQ_LAUNCH(2); break;
      case 3: PVQ_LAUNCH(3); break;
      case 4: PVQ_LAUNCH(4); break;
      case 5: PVQ_LAUNCH(5); break;
      default: PVQ_LAUNCH(6); break;
    }
#undef PVQ_LAUNCH
    count_launch();
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
