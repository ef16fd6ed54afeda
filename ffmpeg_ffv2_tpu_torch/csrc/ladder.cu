// Run-index ladder: the run index each Golomb-Rice run event climbs from.
//
// Port of a lax.scan, ffmpeg_ffv2_tpu/ffv1/device_rice.py:run_index_scan;
// no Pallas counterpart.  Per lane (one slice) the index 0..40 is carried
// across that slice's compacted events: reset to 0 at each plane's first
// event, climbed over the run's count (the largest k <= 40 with P[k] <=
// count + P[i], P the prefix sums of 1 << LOG2_RUN), then kept on a line
// flush or stepped down by one otherwise (ffv1enc_template.c:60-64).  An
// invalid event passes the index through.
//
// Bound: a lane's events form one dependent chain (51626 events in the
// longest slice of a 1080p yuv420p16 frame, on 30 lanes), and the bytes
// are 11 an event (the count, three flags, the output).
// Design: each valid event is a map of the 41 states {0..40}, and maps
// compose, so a lane's chain is a prefix over maps, cut into chunks of
// CHUNK events:
//  1. chunk_maps: a block stages GROUP chunks' counts and flags in shared
//     memory (coalesced), then 41 threads a chunk each walk one start
//     state through it and write the chunk's 41-entry map (bytes);
//  2. chunk_carries: a block a lane applies the maps in order to index 0
//     (staged in shared memory a tile at a time): each chunk's carry-in;
//  3. replay: a block stages 32 chunks, one lane of its first warp walks
//     each chunk from its carry-in, writing the index before each event
//     over the staged count, and the block stores them coalesced.
// The chain falls from n_ev links to 2 CHUNK + n_ev / CHUNK.  Every phase
// climbs in one lookup: a 540-entry table (k, P[k], P[k - 1]) for t <
// P[24] = 540, and past it the closed form k = 16 + floor(log2(t - 284))
// (P[j] = 284 + 2^(j - 16) for j >= 24), capped at 40.  A walker carries
// P[i] beside i, so no lookup of P sits on the chain.  Each lane stops at
// its event count n_ev (the slots past it are capacity, not events, and
// are not written).  Counts are run lengths (>= 0): they are clamped to
// [0, 2^26] off the chain (2^26 climbs past P[40] from any index).

#include "common.cuh"

namespace {

constexpr int CHUNK = 128;            // events a chunk
constexpr int MAPW = 48;              // bytes a chunk map (41 used)
constexpr int GROUP = 3;              // chunks a chunk_maps block
constexpr int STATES = 41;
constexpr int REPLAY = 32;            // chunks a replay block
constexpr int TILE = 256;             // maps a chunk_carries tile
constexpr int SMALL = 540;            // P[24]: the table's extent
constexpr int CSTRIDE = CHUNK + 1;    // staged counts, conflict-free rows
constexpr int FSTRIDE = CHUNK + 4;    // staged flag bytes

__constant__ int kP[42] = {
    0,      1,      2,       3,       4,       6,       8,      10,
    12,     16,     20,      24,      28,      36,      44,     52,
    60,     76,     92,      124,     156,     220,     284,    412,
    540,    796,    1308,    2332,    4380,    8476,    16668,  33052,
    65820,  131356, 262428,  524572,  1048860, 2097436, 4194588, 8388892,
    16777500, 33554716};

// tab[t] for t < SMALL: k | P[k] << 6 | P[max(k - 1, 0)] << 16.
__device__ void fill_table(int* tab) {
  for (int t = threadIdx.x; t < SMALL; t += blockDim.x) {
    int k = 0;
#pragma unroll
    for (int j = 1; j <= 24; ++j) k += kP[j] <= t;
    tab[t] = k | kP[k] << 6 | kP[max(k - 1, 0)] << 16;
  }
}

// One event of the walk: the state (i, pi = P[i]) after the event; fl is
// bit 0 flush, bit 1 valid, bit 2 reset.  Branch-free: the walkers of a
// warp take different branches of the table and of the flags.
__device__ __forceinline__ void climb(const int* tab, int c, int fl, int& i,
                                      int& pi) {
  const int t = c + ((fl & 4) ? 0 : pi);
  const int e = tab[min(t, SMALL - 1)];
  const int kb = min(47 - __clz(max(t - 284, 1)), 40);
  const bool big = t >= SMALL;
  const int k = big ? kb : (e & 63);
  const int pk = big ? 284 + (1 << (kb - 16)) : ((e >> 6) & 1023);
  const int pk1 = big ? (kb > 24 ? 284 + (1 << (kb - 17)) : 412) : (e >> 16);
  const bool keep = fl & 1;
  const int ni = keep ? k : max(k - 1, 0);
  const int np = keep ? pk : pk1;
  const bool valid = fl & 2;
  i = valid ? ni : i;
  pi = valid ? np : pi;
}

// Stage chunks [k0, k0 + nk) of a lane into shared memory: counts (clamped)
// with stride CSTRIDE, flag bytes with stride FSTRIDE; events at or past n
// are staged invalid.
__device__ void stage(const int* __restrict__ count,
                      const unsigned char* __restrict__ flush,
                      const unsigned char* __restrict__ valid,
                      const unsigned char* __restrict__ reset, int n, int k0,
                      int nk, int* s_cnt, unsigned char* s_fl) {
  const int e0 = k0 * CHUNK;
  for (int j = threadIdx.x; j < nk * CHUNK; j += blockDim.x) {
    const int e = e0 + j, ch = j / CHUNK, p = j % CHUNK;
    int c = 0, f = 0;
    if (e < n) {
      c = min(max(count[e], 0), 1 << 26);
      f = (flush[e] ? 1 : 0) | (valid[e] ? 2 : 0) | (reset[e] ? 4 : 0);
    }
    s_cnt[ch * CSTRIDE + p] = c;
    s_fl[ch * FSTRIDE + p] = (unsigned char)f;
  }
}

struct Lane {
  const int* count;
  const unsigned char *flush, *valid, *reset;
  int n;
};

__device__ __forceinline__ Lane lane_of(const int* count,
                                        const unsigned char* flush,
                                        const unsigned char* valid,
                                        const unsigned char* reset,
                                        const int* n_ev, int lane, int E) {
  const size_t off = (size_t)lane * E;
  return Lane{count + off, flush + off, valid + off, reset + off,
              min(max(n_ev[lane], 0), E)};
}

__global__ void __launch_bounds__(128)
    chunk_maps(const int* __restrict__ count,
               const unsigned char* __restrict__ flush,
               const unsigned char* __restrict__ valid,
               const unsigned char* __restrict__ reset,
               const int* __restrict__ n_ev, int E, int nch_cap,
               unsigned char* __restrict__ maps) {
  __shared__ int tab[SMALL];
  __shared__ int s_cnt[GROUP * CSTRIDE];
  __shared__ unsigned char s_fl[GROUP * FSTRIDE];
  const int lane = blockIdx.y, k0 = blockIdx.x * GROUP;
  const Lane ln = lane_of(count, flush, valid, reset, n_ev, lane, E);
  // maps of the chunks that lie wholly below n and are not the last one
  const int nmaps = max((ln.n + CHUNK - 1) / CHUNK - 1, 0);
  if (k0 >= nmaps) return;
  fill_table(tab);
  stage(ln.count, ln.flush, ln.valid, ln.reset, ln.n, k0,
        min(GROUP, nmaps - k0), s_cnt, s_fl);
  __syncthreads();
  const int ch = threadIdx.x / STATES, s = threadIdx.x % STATES;
  if (ch >= GROUP || k0 + ch >= nmaps) return;
  const int* c = s_cnt + ch * CSTRIDE;
  const unsigned char* f = s_fl + ch * FSTRIDE;
  int i = s, pi = kP[s];
#pragma unroll 4
  for (int p = 0; p < CHUNK; ++p) climb(tab, c[p], f[p], i, pi);
  maps[((size_t)lane * nch_cap + k0 + ch) * MAPW + s] = (unsigned char)i;
}

__global__ void __launch_bounds__(TILE)
    chunk_carries(const unsigned char* __restrict__ maps,
                  const int* __restrict__ n_ev, int E, int nch_cap,
                  int* __restrict__ carries) {
  __shared__ uint4 s_map[TILE * MAPW / 16];
  const int lane = blockIdx.x;
  const int n = min(max(n_ev[lane], 0), E);
  const int nch = (n + CHUNK - 1) / CHUNK;
  const uint4* src = reinterpret_cast<const uint4*>(
      maps + (size_t)lane * nch_cap * MAPW);
  const unsigned char* tile = reinterpret_cast<const unsigned char*>(s_map);
  int* out = carries + (size_t)lane * nch_cap;
  int cur = 0;
  for (int t0 = 0; t0 < nch; t0 += TILE) {
    // the maps of chunks t0 .. t0 + nt - 1 (the last chunk has none)
    const int nt = min(TILE, nch - 1 - t0);
    __syncthreads();
    for (int j = threadIdx.x; j < nt * MAPW / 16; j += blockDim.x)
      s_map[j] = src[(size_t)t0 * MAPW / 16 + j];
    __syncthreads();
    if (threadIdx.x == 0) {
      const int m = min(TILE, nch - t0);
      for (int k = 0; k < m; ++k) {
        out[t0 + k] = cur;
        if (k < nt) cur = tile[k * MAPW + cur];
      }
    }
  }
}

__global__ void __launch_bounds__(128)
    replay(const int* __restrict__ count,
           const unsigned char* __restrict__ flush,
           const unsigned char* __restrict__ valid,
           const unsigned char* __restrict__ reset,
           const int* __restrict__ n_ev, int E, int nch_cap,
           const int* __restrict__ carries, int* __restrict__ out) {
  __shared__ int tab[SMALL];
  __shared__ int s_cnt[REPLAY * CSTRIDE];
  __shared__ unsigned char s_fl[REPLAY * FSTRIDE];
  const int lane = blockIdx.y, k0 = blockIdx.x * REPLAY;
  const Lane ln = lane_of(count, flush, valid, reset, n_ev, lane, E);
  const int nch = (ln.n + CHUNK - 1) / CHUNK;
  if (k0 >= nch) return;
  const int nk = min(REPLAY, nch - k0);
  fill_table(tab);
  stage(ln.count, ln.flush, ln.valid, ln.reset, ln.n, k0, nk, s_cnt, s_fl);
  __syncthreads();
  if (threadIdx.x < nk) {
    int* c = s_cnt + threadIdx.x * CSTRIDE;
    const unsigned char* f = s_fl + threadIdx.x * FSTRIDE;
    int i = carries[(size_t)lane * nch_cap + k0 + threadIdx.x];
    int pi = kP[i];
#pragma unroll 4
    for (int p = 0; p < CHUNK; ++p) {
      const int fl = f[p];
      const int cnt = c[p];
      c[p] = ((fl & 6) == 6) ? 0 : i;   // a valid reset climbs from 0
      climb(tab, cnt, fl, i, pi);
    }
  }
  __syncthreads();
  int* o = out + (size_t)lane * E + k0 * CHUNK;
  const int m = min(nk * CHUNK, ln.n - k0 * CHUNK);
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    o[j] = s_cnt[(j / CHUNK) * CSTRIDE + j % CHUNK];
}

}  // namespace

// count: int32 (lanes, E); flush, valid, reset: bool (one byte) (lanes, E);
// n_ev: int32 (lanes,).  out: for each of a lane's first n_ev slots, the
// index before the climb (after the reset) of a valid event, the carried
// index otherwise; slots at or past n_ev are left untouched.  scratch:
// ffv2_ladder_scratch_bytes(lanes, E) bytes (the chunk maps, then the
// carries).  Three kernel launches on the stream, each counted in
// ffv2_kernel_launches.
extern "C" long long ffv2_ladder_scratch_bytes(int lanes, int E) {
  const long long nch = (E + CHUNK - 1) / CHUNK;
  return (long long)lanes * nch * (MAPW + 4);
}

// events a chunk, for the tools that give the kernels' chain
extern "C" int ffv2_ladder_chunk() { return CHUNK; }

extern "C" cudaError_t ffv2_ladder(const int* count, const void* flush,
                                   const void* valid, const void* reset,
                                   const int* n_ev, int lanes, int E,
                                   int* out, void* scratch,
                                   long long scratch_bytes,
                                   cudaStream_t stream) {
  if (lanes < 0 || E < 0 || lanes > 65535 ||
      scratch_bytes < ffv2_ladder_scratch_bytes(lanes, E))
    return cudaErrorInvalidValue;
  if (lanes == 0 || E == 0) return cudaGetLastError();
  const int nch = (E + CHUNK - 1) / CHUNK;
  auto* maps = static_cast<unsigned char*>(scratch);
  int* carries = reinterpret_cast<int*>(maps + (size_t)lanes * nch * MAPW);
  const auto* fl = static_cast<const unsigned char*>(flush);
  const auto* va = static_cast<const unsigned char*>(valid);
  const auto* rs = static_cast<const unsigned char*>(reset);
  chunk_maps<<<dim3((nch + GROUP - 1) / GROUP, lanes), 128, 0, stream>>>(
      count, fl, va, rs, n_ev, E, nch, maps);
  count_launch();
  chunk_carries<<<lanes, TILE, 0, stream>>>(maps, n_ev, E, nch, carries);
  count_launch();
  replay<<<dim3((nch + REPLAY - 1) / REPLAY, lanes), 128, 0, stream>>>(
      count, fl, va, rs, n_ev, E, nch, carries, out);
  count_launch();
  return cudaGetLastError();
}
