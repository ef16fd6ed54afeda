// K19 lap: FFV2's lapped biorthogonal pre- and postfilter across the
// superblock boundaries of its Q12 coefficient planes.
//
// Replaces ffmpeg_ffv2_tpu/ffv2/tpu.py:_jx_lap_prefilter (:77) and
// _jx_lap_postfilter (:100) as _jx_frame_hor and _jx_frame_ver (:122-150)
// apply them with a radius of 32: XLA on the TPU, no Pallas body.  There
// the slabs [b0 - 16, b0 + 16) of every boundary b0 = sb, 2 sb, ... are
// stacked and filtered as one elementwise chain over the stack, then
// scattered back.
//
// Here one thread takes a (plane, boundary, line): it loads the line's 32
// slab samples into registers, runs the 32-tap lifting there (every array
// index a constant once the loops unroll) and stores the slab back in
// place.  The slabs of two boundaries do not overlap while sb >= 32, so
// the threads of a launch write disjoint words; a launch that crosses one
// boundary (the sharded front's 32-row halo slabs, sb = 16) may take sb
// down to 16.  A launch filters one
// direction; the prefilter is the horizontal launch (across vertical
// boundaries, along rows) then the vertical one, the postfilter the
// reverse, one after the other on one stream.  In the vertical launch a
// warp takes 32 neighbouring columns, so each of its 32 loads and stores
// is one 128-byte line; in the horizontal one a warp takes 32 rows and
// each thread reads its own 128-byte line (L1 serves all but its first
// load).
//
// Bound: device memory, each slab word read once and written once
// (256 bytes a line), about 24 MB a direction for a 1080p yuv444p frame.
//
// Arithmetic is JAX's int32 with wraparound: products and sums in uint32
// (no signed-overflow UB), >> arithmetic, << on the bits, and c_div is
// |a| // |b| (floor division) with the sign applied, |INT_MIN| wrapping to
// INT_MIN as jnp.abs does.

#include "common.cuh"

namespace {

constexpr int RADIUS = 32;
constexpr int HALF = RADIUS / 2;
constexpr int THREADS = 128;

// dsp.LAP_PARAMS[32] (ffv2.c:lap_filt_params_32)
__constant__ int LAP32[46] = {
    91,  70,  68,  67,  67,  67,  67,  66,  66,  67,  67,  66,
    67,  67,  67,  70,  -32, -41, -42, -41, -40, -38, -36, -34,
    -32, -29, -24, -19, -14, -9,  -5,  58,  52,  50,  48,  45,
    43,  40,  38,  35,  32,  29,  24,  18,  13,  8};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
// (t * p + 32) >> 6 in int32
__device__ __forceinline__ int scale_round(int t, int p) {
  return wadd(wmul(t, p), 32) >> 6;
}

// jnp.abs(a) // abs(b) with the sign of a / b applied (tpu.py:_jx_c_div)
__device__ __forceinline__ int c_div(int a, int b) {
  const int aa = a < 0 ? wsub(0, a) : a;       // |INT_MIN| stays INT_MIN
  const int ab = b < 0 ? -b : b;
  int q = aa / ab;
  if (aa % ab != 0 && aa < 0) --q;             // floor, as jnp's //
  return ((a >= 0) == (b >= 0)) ? q : wsub(0, q);
}

template <bool FWD>
__device__ __forceinline__ void lift(int (&x)[RADIUS]) {
  constexpr int size = RADIUS, h = HALF;
  int t[size];
#pragma unroll
  for (int i = 0; i < h; ++i) t[size - 1 - i] = wsub(x[i], x[size - 1 - i]);
#pragma unroll
  for (int i = 0; i < h; ++i) t[h - 1 - i] = wsub(x[h - 1 - i], t[h + i] >> 1);
  if (FWD) {
#pragma unroll
    for (int i = h; i < size; ++i) {
      const int v = wmul(t[i], LAP32[i - h]) >> 6;
      t[i] = wadd(v, v > 0);
    }
#pragma unroll
    for (int i = size - 1; i > h; --i) {
      t[i] = wadd(t[i], scale_round(t[i - 1], LAP32[i - 1]));
      t[i - 1] = wadd(t[i - 1], scale_round(t[i], LAP32[i + h - 2]));
    }
#pragma unroll
    for (int i = 0; i < h; ++i) {
      t[i] = wadd(t[i], t[size - 1 - i] >> 1);
      x[i] = t[i];
    }
#pragma unroll
    for (int i = 0; i < h; ++i) x[h + i] = wsub(t[h - 1 - i], t[h + i]);
  } else {
#pragma unroll
    for (int i = h; i < size - 1; ++i) {
      t[i] = wsub(t[i], scale_round(t[i + 1], LAP32[i + h - 1]));
      t[i + 1] = wsub(t[i + 1], scale_round(t[i], LAP32[i]));
    }
#pragma unroll
    for (int i = size - 1; i >= h; --i)
      t[i] = c_div((int)((unsigned)t[i] << 6), LAP32[i - h]);
#pragma unroll
    for (int i = 0; i < h; ++i) {
      t[i] = wadd(t[i], t[size - 1 - i] >> 1);
      x[i] = t[i];
    }
#pragma unroll
    for (int i = h; i < size; ++i) x[i] = wsub(t[size - 1 - i], t[i]);
  }
}

// c: int32 [P, H, W]; boundaries at sb, 2 sb, ... below the extent that
// the direction crosses (W for the horizontal launch, H for the vertical).
template <bool FWD>
__global__ void __launch_bounds__(THREADS)
    lap_kernel(int* __restrict__ c, int H, int W, int sb, int vertical,
               int nb, int lines, long long total) {
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= total) return;
  const int line = (int)(g % lines);
  const long long pb = g / lines;
  const int b0 = ((int)(pb % nb) + 1) * sb;
  const long long p = pb / nb;
  int* base;
  long long stride;
  if (vertical) {
    base = c + (p * H + (b0 - HALF)) * W + line;
    stride = W;
  } else {
    base = c + (p * H + line) * W + (b0 - HALF);
    stride = 1;
  }
  int x[RADIUS];
#pragma unroll
  for (int k = 0; k < RADIUS; ++k) x[k] = base[k * stride];
  lift<FWD>(x);
#pragma unroll
  for (int k = 0; k < RADIUS; ++k) base[k * stride] = x[k];
}

template <bool FWD>
cudaError_t launch(int* c, int P, int H, int W, int sb, int vertical,
                   cudaStream_t stream) {
  if (sb < HALF || P < 0 || H < 0 || W < 0) return cudaErrorInvalidValue;
  const int extent = vertical ? H : W;
  const int nb = extent > 0 ? (extent - 1) / sb : 0;
  // every slab inside the extent, and two slabs apart (a halo's 32-row
  // slab has one boundary at sb = 16)
  if ((nb > 1 && sb < RADIUS) || (nb > 0 && nb * sb + HALF > extent))
    return cudaErrorInvalidValue;
  const int lines = vertical ? W : H;
  const long long total = (long long)P * nb * lines;
  if (total > 0)
    lap_kernel<FWD><<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                      0, stream>>>(c, H, W, sb, vertical, nb, lines, total);
  return cudaGetLastError();
}

}  // namespace

// c: int32 [P, H, W], filtered in place in one direction (vertical = 0:
// across the vertical boundaries, along rows; 1: across the horizontal
// ones, along columns).
extern "C" cudaError_t ffv2_lap_pre(int* c, int P, int H, int W, int sb,
                                    int vertical, cudaStream_t stream) {
  return launch<true>(c, P, H, W, sb, vertical, stream);
}

extern "C" cudaError_t ffv2_lap_post(int* c, int P, int H, int W, int sb,
                                     int vertical, cudaStream_t stream) {
  return launch<false>(c, P, H, W, sb, vertical, stream);
}
