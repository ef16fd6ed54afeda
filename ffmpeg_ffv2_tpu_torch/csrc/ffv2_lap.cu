// K19 lap: FFV2's lapped biorthogonal pre- and postfilter across the
// superblock boundaries of its Q12 coefficient planes.
//
// Replaces ffmpeg_ffv2_tpu/ffv2/tpu.py:_jx_lap_prefilter (:77) and
// _jx_lap_postfilter (:100) as _jx_frame_hor and _jx_frame_ver (:122-150)
// apply them with a radius of 32: XLA on the TPU, no Pallas body.  There
// the slabs [b0 - 16, b0 + 16) of every boundary b0 = sb, 2 sb, ... are
// stacked and filtered as one elementwise chain over the stack, then
// scattered back; the prefilter is the horizontal direction (across the
// vertical boundaries, along rows) then the vertical one, the postfilter
// the reverse.
//
// Here one launch filters a whole call, both directions or one, as a
// table of tiles (ffv2/device.py:lap_tiles, int32 [n, 5]: y0, x0, h, w,
// role) that covers the union of the slabs exactly once; block (i, p)
// takes tile i of plane p:
// - a band tile (ROLE_V) is the 32 rows of a horizontal boundary's slab
//   times a piece of at most 64 columns; with ROLE_H as well its first 32
//   columns are a vertical boundary's slab;
// - a row tile (ROLE_H alone) is up to 64 rows outside every horizontal
//   slab (all rows in the one-direction horizontal mode) times one
//   vertical slab's 32 columns.
// The block loads its tile into shared memory with coalesced 128-byte row
// segments (each thread's 32 loads issued before any is used), lifts it
// there, and writes it back once.  A band tile runs the horizontal lift
// on each of its 32 rows (one thread a row) and the vertical lift on each
// column (one thread a column), in the direction's order; a row tile runs
// the horizontal lift on each row.  The row stride in shared memory is
// odd (w | 1), so a thread a row and a thread a column both read distinct
// banks.  A band piece with no vertical slab (every piece in the
// one-direction vertical mode) needs no transposition: a thread a column
// lifts it straight from device memory, a warp's loads 128-byte rows.
//
// Order: a tile needs nothing outside itself, so the blocks run in any
// order.  The vertical lift of a column of a band reads only that band's
// 32 rows, after (prefilter) or before (postfilter) their horizontal
// lift, and the horizontal lift of a row reads and writes only that row's
// slab columns: in a band tile those are the tile's own first 32 columns,
// and rows outside the bands are touched by their row tile alone.  The
// slabs of two boundaries do not overlap while sb >= 32; a call that
// crosses one boundary (the sharded front's 32-row halo slabs, sb = 16)
// may take sb down to 16.  The host checks both (device.py:_check_slabs).
//
// Bound: device memory, each word of the union read once and written
// once: 36.4 MB for a 1080p yuv444p frame at sb 64 (3 planes of 1920 x
// 1088: 29 vertical and 16 horizontal slabs), which this design moves;
// the direction-at-a-time design it replaced moved 47.8 MB (the slabs'
// crossings twice).  The lift is ~300 integer operations a line, well
// under the card's rate.
//
// Arithmetic is JAX's int32 with wraparound: products and sums in uint32
// (no signed-overflow UB), >> arithmetic, << on the bits, and c_div is
// |a| // |b| (floor division) with the sign applied, |INT_MIN| wrapping to
// INT_MIN as jnp.abs does.  The parameters are a constant expression, so
// at every (unrolled, constant) index they are immediates and the
// postfilter's divisions by them compile to multiply-high sequences.

#include "common.cuh"

namespace {

constexpr int RADIUS = 32;
constexpr int HALF = RADIUS / 2;
constexpr int THREADS = 64;              // two warps a tile
constexpr int BAND_COLS = 64;            // a band tile's widest piece
constexpr int ROW_ROWS = 64;             // a row tile's tallest piece
constexpr int SEGS = 64;                 // 32-word row segments a tile
constexpr int SMEM_WORDS = ROW_ROWS * (RADIUS + 1);   // >= 32 * 65
constexpr int ROLE_H = 1;                // ffv2/device.py:LAP_ROLE_H
constexpr int ROLE_V = 2;                // ffv2/device.py:LAP_ROLE_V
constexpr int TILE_INTS = 5;

static_assert(SMEM_WORDS >= RADIUS * (BAND_COLS + 1), "band tile fits");
static_assert(SEGS == 2 * RADIUS && SEGS == ROW_ROWS, "segment map");

// dsp.LAP_PARAMS[32] (ffv2.c:lap_filt_params_32)
__host__ __device__ constexpr int lap32(int i) {
  constexpr int LAP32[46] = {
      91,  70,  68,  67,  67,  67,  67,  66,  66,  67,  67,  66,
      67,  67,  67,  70,  -32, -41, -42, -41, -40, -38, -36, -34,
      -32, -29, -24, -19, -14, -9,  -5,  58,  52,  50,  48,  45,
      43,  40,  38,  35,  32,  29,  24,  18,  13,  8};
  return LAP32[i];
}

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
      const int v = wmul(t[i], lap32(i - h)) >> 6;
      t[i] = wadd(v, v > 0);
    }
#pragma unroll
    for (int i = size - 1; i > h; --i) {
      t[i] = wadd(t[i], scale_round(t[i - 1], lap32(i - 1)));
      t[i - 1] = wadd(t[i - 1], scale_round(t[i], lap32(i + h - 2)));
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
      t[i] = wsub(t[i], scale_round(t[i + 1], lap32(i + h - 1)));
      t[i + 1] = wsub(t[i + 1], scale_round(t[i], lap32(i)));
    }
#pragma unroll
    for (int i = size - 1; i >= h; --i)
      t[i] = c_div((int)((unsigned)t[i] << 6), lap32(i - h));
#pragma unroll
    for (int i = 0; i < h; ++i) {
      t[i] = wadd(t[i], t[size - 1 - i] >> 1);
      x[i] = t[i];
    }
#pragma unroll
    for (int i = h; i < size; ++i) x[i] = wsub(t[size - 1 - i], t[i]);
  }
}

// The 32 samples at s[0], s[step], ..., s[31 step] (shared or device
// memory), lifted in place.
template <bool FWD>
__device__ __forceinline__ void lift_line(int* s, int step) {
  int x[RADIUS];
#pragma unroll
  for (int k = 0; k < RADIUS; ++k) x[k] = s[k * step];
  lift<FWD>(x);
#pragma unroll
  for (int k = 0; k < RADIUS; ++k) s[k * step] = x[k];
}

// The horizontal lift of the tile's first 32 columns, a thread a row.
template <bool FWD>
__device__ __forceinline__ void lift_rows(int* s, int stride, int rows) {
  if ((int)threadIdx.x < rows) lift_line<FWD>(s + threadIdx.x * stride, 1);
}

// The vertical lift of the band's 32 rows, a thread a column.
template <bool FWD>
__device__ __forceinline__ void lift_cols(int* s, int stride, int cols) {
  if ((int)threadIdx.x < cols) lift_line<FWD>(s + threadIdx.x, stride);
}

// c: int32 [P, H, W] in place; tiles: int32 [n, 5] (y0, x0, h, w, role).
template <bool FWD>
__global__ void __launch_bounds__(THREADS)
    lap_tiles_kernel(int* __restrict__ c, const int* __restrict__ tiles,
                     int H, int W) {
  __shared__ int s[SMEM_WORDS];
  const int* t = tiles + (long long)blockIdx.x * TILE_INTS;
  const int y0 = t[0], x0 = t[1], h = t[2], w = t[3], role = t[4];
  const bool band = role & ROLE_V;
  // the table's invariants (device.py:lap_tiles): never leave the plane
  // or the shared tile
  if (y0 < 0 || x0 < 0 || h <= 0 || w <= 0 || y0 + h > H || x0 + w > W ||
      !(role & (ROLE_H | ROLE_V)) ||
      (band ? h != RADIUS || w > BAND_COLS || ((role & ROLE_H) && w < RADIUS)
            : h > ROW_ROWS || w != RADIUS))
    return;
  int* base = c + ((long long)blockIdx.y * H + y0) * W + x0;
  if (role == ROLE_V) {
    // a band piece without a vertical slab: a thread a column straight
    // from device memory (a warp's loads are 128-byte rows), no staging
    if ((int)threadIdx.x < w) lift_line<FWD>(base + threadIdx.x, W);
    return;
  }
  const int stride = w | 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // segment j of a warp: a band tile's row j, columns 32 warp + lane; a
  // row tile's row warp + 2 j, column lane
  int v[SEGS / 2];
#pragma unroll
  for (int j = 0; j < SEGS / 2; ++j) {
    const int r = band ? j : warp + 2 * j;
    const int col = band ? 32 * warp + lane : lane;
    if (r < h && col < w) v[j] = base[(long long)r * W + col];
  }
#pragma unroll
  for (int j = 0; j < SEGS / 2; ++j) {
    const int r = band ? j : warp + 2 * j;
    const int col = band ? 32 * warp + lane : lane;
    if (r < h && col < w) s[r * stride + col] = v[j];
  }
  __syncthreads();
  if (FWD) {
    if (role & ROLE_H) lift_rows<true>(s, stride, h);
    __syncthreads();
    if (band) lift_cols<true>(s, stride, w);
  } else {
    if (band) lift_cols<false>(s, stride, w);
    __syncthreads();
    if (role & ROLE_H) lift_rows<false>(s, stride, h);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SEGS / 2; ++j) {
    const int r = band ? j : warp + 2 * j;
    const int col = band ? 32 * warp + lane : lane;
    if (r < h && col < w) base[(long long)r * W + col] = s[r * stride + col];
  }
}

template <bool FWD>
cudaError_t launch(int* c, const int* tiles, int n_tiles, int P, int H,
                   int W, cudaStream_t stream) {
  if (n_tiles < 0 || P < 0 || P > 65535 || H < 0 || W < 0)
    return cudaErrorInvalidValue;
  if (n_tiles > 0 && P > 0)
    lap_tiles_kernel<FWD><<<dim3((unsigned)n_tiles, (unsigned)P), THREADS,
                            0, stream>>>(c, tiles, H, W);
  return cudaGetLastError();
}

}  // namespace

// c: int32 [P, H, W], filtered in place over the tiles of
// ffv2/device.py:lap_tiles(H, W, sb, mode) (int32 [n_tiles, 5] on the
// card): both directions in the filter's order, or one.
extern "C" cudaError_t ffv2_lap_pre(int* c, const int* tiles, int n_tiles,
                                    int P, int H, int W,
                                    cudaStream_t stream) {
  return launch<true>(c, tiles, n_tiles, P, H, W, stream);
}

extern "C" cudaError_t ffv2_lap_post(int* c, const int* tiles, int n_tiles,
                                     int P, int H, int W,
                                     cudaStream_t stream) {
  return launch<false>(c, tiles, n_tiles, P, H, W, stream);
}
