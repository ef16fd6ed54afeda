// Run-index ladder: the run index each Golomb-Rice run event climbs from.
//
// Port of a lax.scan, ffmpeg_ffv2_tpu/ffv1/device_rice.py:run_index_scan;
// no Pallas counterpart.  Per lane (one slice) the index 0..40 is carried
// across that slice's compacted events: reset to 0 at each plane's first
// event, climbed over the run's count (while count >= 1 << LOG2_RUN[i]),
// then kept on a line flush or stepped down by one otherwise
// (ffv1enc_template.c:60-64).
//
// Bound: latency of one dependent chain per lane, as long as the lane's
// events (a few hundred to tens of thousands a slice at 1080p); the bytes
// are 12 per event.
// Design: one thread per lane; the 42-entry prefix table P of 1 << LOG2_RUN
// sits in shared memory, and the climb is a short forward search in P
// (P[j] <= count + P[i], j <= 40, the closed form of
// device_rice.ladder_step).  Each lane stops at its event count n_ev (the
// slots past it are capacity, not events, and are not written).  Events
// are read BATCH at a time, so the chain waits on memory once per BATCH
// events.

#include "common.cuh"

namespace {

constexpr int BATCH = 16;

__constant__ int kLog2Run[41] = {
    0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 5, 5, 6,
    6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24};

// flags: bit 0 line flush, bit 1 valid, bit 2 reset (the plane's first
// event).  out: for each of the lane's first n_ev slots, the index before
// the climb (after the reset) of a valid event, the carried index
// otherwise; slots at or past n_ev are left untouched.
__global__ void ladder_kernel(const int* __restrict__ count,
                              const int* __restrict__ flags,
                              const int* __restrict__ n_ev, int lanes, int E,
                              int* __restrict__ out) {
  __shared__ int P[42];
  if (threadIdx.x == 0) {
    P[0] = 0;
    for (int i = 0; i < 41; ++i) P[i + 1] = P[i] + (1 << kLog2Run[i]);
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int n = min(max(n_ev[lane], 0), E);
  const int* c = count + (size_t)lane * E;
  const int* f = flags + (size_t)lane * E;
  int* o = out + (size_t)lane * E;
  int idx = 0;
  for (int e0 = 0; e0 < n; e0 += BATCH) {
    int cs[BATCH], fs[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      cs[j] = e0 + j < n ? c[e0 + j] : 0;
      fs[j] = e0 + j < n ? f[e0 + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (e0 + j >= n) break;
      if (!(fs[j] & 2)) {
        o[e0 + j] = idx;
        continue;
      }
      const int i_in = (fs[j] & 4) ? 0 : idx;
      const int t = cs[j] + P[i_in];
      int k = i_in;
      while (k < 40 && P[k + 1] <= t) ++k;
      o[e0 + j] = i_in;
      idx = (fs[j] & 1) ? k : max(k - 1, 0);
    }
  }
}

}  // namespace

extern "C" cudaError_t ffv2_ladder(const int* count, const int* flags,
                                   const int* n_ev, int lanes, int E,
                                   int* out, cudaStream_t stream) {
  if (lanes > 0 && E > 0)
    ladder_kernel<<<(lanes + 127) / 128, 128, 0, stream>>>(count, flags,
                                                           n_ev, lanes, E,
                                                           out);
  return cudaGetLastError();
}
