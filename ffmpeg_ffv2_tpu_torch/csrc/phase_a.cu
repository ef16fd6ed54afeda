// Phase A of the FFV1 encoder: every sample's context and folded residual,
// for every slice crop of every coded plane of a frame, in one launch.
//
// Replaces none: ffmpeg_ffv2_tpu/ffv1/tpu.py:122 plane_context_diff is XLA
// with no Pallas body.  The port ran it as a chain of ~550-820
// elementwise torch calls a frame (crops, stacks, the neighbour shifts,
// ten threshold compares a quantizer row, the median, the fold), whose
// launches held the host for ~11 ms a 1080p frame.
//
// Bound: device memory.  Each sample is read once (int32) and each
// sample's context and residual are written once (int32): 37.3 MB at
// 1080p 4:2:0, 11 us at 3.35 TB/s.  The arithmetic has no serial
// dependency: the encoder's predictor reads original samples.
// Design: a descriptor table built once a session (ffv1/phase_a.py
// PhaseAPlan) and kept on the device: the five 256-entry quantizer rows
// (indexed by d & 0xFF, as FFmpeg's quant tables are), a job a (slice,
// plane) crop (plane, origin, size, output offset and row pitch), then a
// block a tile of a job.  A frame passes only its plane pointers and row
// pitches as launch arguments.  A block of 256 threads takes a tile of
// TILE_H rows by TILE_W columns of one crop: it stages the tile with a
// 2-row top halo, a 2-column left halo and a 1-column right halo in
// shared memory, filled so that plain reads of the neighbours give
// FFV1's borders (neighbours() in ffv1/phase_a.py): rows above the crop
// are 0, column -1 holds the sample above column 0 (the guard of L at x
// = 0, LL at x = 1 and, a row down, LT at x = 0), column -2 is 0 (LL at
// x = 0) and column w repeats column w - 1 (RT at x = w - 1).  Each warp
// then takes a row of 32 samples at a time, a lane a column, and stores
// 32 consecutive words of each output.  The output pitch and offset lay
// out YUV's per-slice plane concatenation, RGB's line interleave and a
// plain stack alike.

#include "common.cuh"

namespace {

constexpr int QT_WORDS = 5 * 256;
constexpr int JOB_WORDS = 8;
constexpr int TILE_W = 32;
constexpr int TILE_H = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SW = TILE_W + 3;     // staged columns: x0 - 2 .. x0 + TILE_W
constexpr int MAX_PLANES = 4;

struct Planes {
  const int* ptr[MAX_PLANES];
  long long pitch[MAX_PLANES];     // words a row
};

__device__ __forceinline__ int wrap16(int v) {
  return ((v + 32768) & 0xFFFF) - 32768;
}

__global__ void __launch_bounds__(THREADS)
phase_a_kernel(const int* __restrict__ table, int n_jobs, Planes planes,
               int bits, int five, int wrap, int* __restrict__ ctx,
               int* __restrict__ diff) {
  __shared__ int q[5][256];
  __shared__ int s[TILE_H + 2][SW];
  const int2 blk = reinterpret_cast<const int2*>(
      table + QT_WORDS + n_jobs * JOB_WORDS)[blockIdx.x];
  const int* job = table + QT_WORDS + blk.x * JOB_WORDS;
  const int p = job[0], jx = job[1], jy = job[2], w = job[3], h = job[4];
  const int dst_off = job[5], dst_pitch = job[6];
  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int y0 = blk.y / tiles_x * TILE_H;
  const int x0 = blk.y % tiles_x * TILE_W;

  const int nq = five ? 5 : 3;
  for (int i = threadIdx.x; i < nq * 256; i += THREADS)
    q[i >> 8][i & 255] = table[i];

  const int* src = planes.ptr[p];
  const long long pitch = planes.pitch[p];
  for (int i = threadIdx.x; i < (TILE_H + 2) * SW; i += THREADS) {
    const int r = i / SW, c = i - r * SW;
    const int y = y0 - 2 + r, x = x0 - 2 + c;
    int yy = y, xx = min(x, w - 1);
    if (x == -1) {                 // the guard: the sample above column 0
      yy = y - 1;
      xx = 0;
    }
    int v = 0;
    // rows at or past h are never read by a sample of the crop
    if (yy >= 0 && y < h && x != -2) {
      v = src[(jy + yy) * pitch + jx + xx];
      if (wrap) v = wrap16(v);
    }
    s[r][c] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = x0 + lane, c = lane + 2;
  if (x >= w) return;
  const int mask = (1 << bits) - 1, half = 1 << (bits - 1);
  for (int r = warp; r < TILE_H && y0 + r < h; r += WARPS) {
    const int rr = r + 2;
    const int cur = s[rr][c], T = s[rr - 1][c], L = s[rr][c - 1];
    const int LT = s[rr - 1][c - 1], RT = s[rr - 1][c + 1];
    int cx = q[0][(L - LT) & 255] + q[1][(LT - T) & 255] +
             q[2][(T - RT) & 255];
    if (five)
      cx += q[3][(s[rr][c - 2] - L) & 255] + q[4][(s[rr - 2][c] - T) & 255];
    // mid_pred(L, L + T - LT, T)
    const int g = L + T - LT;
    const int pred = min(max(min(L, g), T), max(L, g));
    int d = cur - pred;
    if (cx < 0) {
      cx = -cx;
      d = -d;
    }
    d = ((d + half) & mask) - half;
    const long long o = dst_off + (long long)(y0 + r) * dst_pitch + x;
    ctx[o] = cx;
    diff[o] = d;
  }
}

}  // namespace

extern "C" cudaError_t ffv2_phase_a(
    const int* table, int n_jobs, int n_blocks, const int* p0,
    const int* p1, const int* p2, const int* p3, long long pitch0,
    long long pitch1, long long pitch2, long long pitch3, int bits, int five,
    int wrap, int* ctx, int* diff, cudaStream_t stream) {
  if (n_blocks <= 0) return cudaGetLastError();
  const Planes planes = {{p0, p1, p2, p3}, {pitch0, pitch1, pitch2, pitch3}};
  phase_a_kernel<<<n_blocks, THREADS, 0, stream>>>(table, n_jobs, planes,
                                                   bits, five, wrap, ctx,
                                                   diff);
  return cudaGetLastError();
}
