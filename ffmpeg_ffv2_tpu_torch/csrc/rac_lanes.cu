// K7 rac_lanes: the lane range coder of the hybrid encoder over unpacked
// (sv, bit, mode) ops, writing one staged event per step.
//
// Replaces the TPU kernel body ffmpeg_ffv2_tpu/ffv1/pallas_coder.py:
// _coder_kernel (rac_pallas_lanes), which computes the lax.scan
// ffmpeg_ffv2_tpu/ffv1/tpu_coder.py:rac_scan_lanes: per lane the carry
// (low, range, pending, pending count) starts at (0, 0xFF00, -1, 0); per
// step an op, a flush (1: low += 0xFF, 2: none; both set range 0xFF) or a
// NOP, then the renormalisation, whose emission is staged as (first byte
// or -1, fill count, fill value).  The fill value is written at every
// step (0xFF where low <= 0xFF00, else 0), emitting or not, as the scan
// writes it.  The TPU kernel carries the state between grid steps in VMEM
// scratch; CUDA blocks run in no order, so here a lane's carry stays in
// one block for the whole stream.
//
// Bound: latency of each lane's serial range chain, one step after the
// other (about 0.45 M steps per 1080p slice); the bytes (3 int32 in, 3
// int32 out per step and lane) take far less time at the card's memory
// rate.  On this card a branch on a value just computed costs a warp some
// 50 cycles (tools/latency.cu), so only the range stays on the chain, with
// no branch: the rest of a step is either known before the step (its
// factors) or not needed by the next one (low, the pending byte, the
// emission).  One block per lane, three warps, one stage of STAGE steps at
// a time, as in K4 (rac_render.cu):
// - Warp 1 (the producer) streams the lane's column of (sv, bit, mode)
//   (4-byte words `lanes` apart) into a ring of NSTAGE stages in shared
//   memory as each step's four factors (K4's decomposition: a NOP has f =
//   256, the flushes f = 0 and c = 0xFF00); steps past `steps` become
//   NOPs.  It publishes a stage through a ready word and refills it once
//   the coder has released it.
// - Warp 0 (the coder) runs the range chain, IMAD -> IADD -> SHF -> LOP3 a
//   step, and writes each step's low increment with its renormalisation
//   flag in bit 31 to the stage's event list in shared memory, a store at
//   a fixed index every step.
// - Warp 2 (the settler) works one stage behind, 32 steps at a time, one
//   step a thread.  Low only grows by the increments between two
//   renormalisations, and after one its low byte is 0, so a warp prefix
//   sum of the increments gives every step's low from the last
//   renormalisation before it in the window (or the window's carry), with
//   no serial pass.  The pending byte and its count follow the same way:
//   a renormalisation either resets them (low <= 0xFF00, low >= 0x10000,
//   or the lane's first) or adds one to the count, so each step's comes
//   from the last reset before it (a ballot and a shuffle) and the count
//   of the others since (a popcount).  Each thread stores its step's
//   (first, fcount, fval).
// The step count comes from the caller (no padding to a power of two).
// All arithmetic is int32: range * f + c < 2^24, low < 2^17, and >> on the
// non-negative low is the scan's arithmetic shift.  As K4, the kernel
// takes a coder's op stream: sv in 1..255 on an op step, so that the range
// is at least 0x100 before every step.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int STAGE = 512;   // steps a stage (8 KB of factors)
constexpr int NSTAGE = 4;    // stages in the ring
constexpr int UNROLL = 16;   // coder steps between two loop branches

// One step (sv, bit, mode) as two multiply-adds on the old range, with r1 =
// (range * sv) >> 8 and range - r1 = (range * (256 - sv) + 255) >> 8:
//   range' = (range * f + c) >> 8,  low' = low + ((range * g + h) >> 8);
//   op, bit 1:  f = sv,       c = 0,      g = 256 - sv, h = 255;
//   op, bit 0:  f = 256 - sv, c = 255,    g = 0,        h = 0;
//   flush 1:    f = 0,        c = 0xFF00, g = 0,        h = 0xFF00;
//   flush 2:    f = 0,        c = 0xFF00, g = 0,        h = 0;
//   NOP (any other mode):     f = 256, c = g = h = 0.
// A step renormalises exactly when range * f + c < 0x10000.
__device__ __forceinline__ int4 factors(int sv, int bit, int m) {
  const bool op = m == MODE_OP;
  const bool one = bit != 0;
  const bool flush = m == MODE_FLUSH1 || m == MODE_FLUSH2;
  int4 q;
  q.x = op ? (one ? sv : 256 - sv) : (flush ? 0 : 256);
  q.y = op ? (one ? 0 : 255) : (flush ? 0xFF00 : 0);
  q.z = op && one ? 256 - sv : 0;
  q.w = op ? (one ? 255 : 0) : (m == MODE_FLUSH1 ? 0xFF00 : 0);
  return q;
}

// Warp 1: stage k of the lane's first `steps` steps into ring slot k %
// NSTAGE once the coder has released stage k - NSTAGE.
__device__ void produce(const int* __restrict__ sv,
                        const int* __restrict__ bit,
                        const int* __restrict__ mode, int steps, int lanes,
                        int l, int nstages, int lane, int4* ring,
                        volatile int* ready, volatile int* released) {
  constexpr int PER = STAGE / 32;
  for (int k = 0; k < nstages; ++k) {
    if (k >= NSTAGE)
      while (*released < k - NSTAGE + 1) {
      }
    __threadfence_block();
    int4* dst = ring + (k % NSTAGE) * STAGE;
    const int first = k * STAGE + lane;
    int s_[PER], b_[PER], m_[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = first + 32 * u;
      const size_t at = (size_t)i * lanes + l;
      const bool in = i < steps;
      s_[u] = in ? __ldg(sv + at) : 0;
      b_[u] = in ? __ldg(bit + at) : 0;
      m_[u] = in ? __ldg(mode + at) : MODE_NOP;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u)
      dst[32 * u + lane] = factors(s_[u], b_[u], m_[u]);
    __threadfence_block();
    __syncwarp();
    if (lane == 0) ready[k % NSTAGE] = k + 1;
  }
}

// m ? a : b bit by bit, one LOP3 (ptxas would split the select into two).
__device__ __forceinline__ int select_bits(int m, int a, int b) {
  int r;
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;" : "=r"(r) : "r"(m), "r"(a), "r"(b));
  return r;
}

// One coder step on the factors q = (f, c, g, h): the new range (shifted
// up by 8 where it falls below 0x100: m all ones), and the step's event
// word, its low increment with m's sign in bit 31.
__device__ __forceinline__ int code_step(int& rng, int4 q) {
  const int t = rng * q.x + q.y;
  const int inc = (rng * q.z + q.w) >> 8;
  const int m = (t - 0x10000) >> 31;
  rng = select_bits(m, t & ~0xFF, t >> 8);
  return select_bits((int)0x80000000, m, inc);
}

// The settler's carry between windows: low after the last step, the
// pending byte (-1 before the lane's first renormalisation) and its count.
struct Settle {
  int low = 0, pending = -1, pcount = 0;
};

// 32 steps, one on each thread t with its event word w; a step below
// `steps` (in) stores its staged (first, fcount, fval) at index `at` of
// the three outputs.  A renormalisation at step j sets low to (low_j &
// 0xFF) << 8, whose low byte is 0, so the low of a step after it in the
// window is that plus the increments since, and its own low byte is
// theirs alone.
__device__ __forceinline__ void settle32(Settle& c, int w, int t, bool in,
                                         int* __restrict__ first,
                                         int* __restrict__ fcount,
                                         int* __restrict__ fval, size_t at) {
  const bool r = w < 0;                       // the step renormalises
  int sum = w & 0x7FFFFFFF;                   // increments up to step t
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, sum, d);
    sum += t >= d ? y : 0;
  }
  const unsigned below = (1u << t) - 1;
  const unsigned rmask = __ballot_sync(FULL, r);
  const unsigned rb = rmask & below;
  const int rp = (31 - __clz(rb)) & 31;       // the last before t, if any
  // (every thread takes part in every shuffle, so none sits in a select)
  const int sum_rp = __shfl_sync(FULL, sum, rp);
  // low - (low after the renormalisation at rp): the increments since, or
  // low whole where no step before t in the window renormalised
  const int s = rb ? sum - sum_rp : c.low + sum;
  const int after = (s & 0xFF) << 8;          // low after t's, if it is one
  const int after_rp = __shfl_sync(FULL, after, rp);
  const int low = s + (rb ? after_rp : 0);
  const bool cc = low <= 0xFF00;              // no carry: fill 0xFF
  const bool cd = low >= 0x10000;             // a carry: fill 0
  const bool cb = r && rb == 0 && c.pending < 0;   // the lane's first
  const bool reset = r && (cb || cc || cd);
  const unsigned zmask = __ballot_sync(FULL, reset);
  const unsigned band = rmask & ~zmask;       // the count grows by one
  const int hi = low >> 8;
  const int set = cb ? hi : hi & 0xFF;        // the pending byte after it
  const unsigned zb = zmask & below;
  const int R = (31 - __clz(zb)) & 31;        // the last reset before t
  const int set_R = __shfl_sync(FULL, set, R);
  const int pend = zb ? set_R : c.pending;
  const unsigned since = zb ? ~((2u << R) - 1) : FULL;
  const int pcount = __popc(band & below & since) + (zb ? 0 : c.pcount);
  const bool emit = reset && !cb;
  if (in) {
    first[at] = emit ? ((cc ? pend : pend + 1) & 0xFF) : -1;
    fcount[at] = emit ? pcount : 0;
    fval[at] = cc ? 0xFF : 0;
  }
  c.low = __shfl_sync(FULL, r ? after : low, 31);
  const int Z = (31 - __clz(zmask)) & 31;
  const int zpend = __shfl_sync(FULL, set, Z);
  const unsigned zsince = zmask ? ~((2u << Z) - 1) : FULL;
  c.pcount = __popc(band & zsince) + (zmask ? 0 : c.pcount);
  c.pending = zmask ? zpend : c.pending;
}

__global__ void __launch_bounds__(96)
rac_lanes_kernel(const int* __restrict__ sv, const int* __restrict__ bit,
                 const int* __restrict__ mode, int steps, int lanes,
                 int* __restrict__ first, int* __restrict__ fcount,
                 int* __restrict__ fval) {
  __shared__ int4 ring[NSTAGE * STAGE];
  __shared__ int ev[2][STAGE];   // a stage's event words, 2 stages
  __shared__ int ready[NSTAGE], ev_ready[2];
  __shared__ int released, settled;
  const int l = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nstages = (steps + STAGE - 1) / STAGE;
  if (threadIdx.x < NSTAGE) ready[threadIdx.x] = 0;
  if (threadIdx.x < 2) ev_ready[threadIdx.x] = 0;
  if (threadIdx.x == 0) released = settled = 0;
  __syncthreads();
  if (warp == 1) {
    produce(sv, bit, mode, steps, lanes, l, nstages, lane, ring, ready,
            &released);
    return;
  }
  if (warp == 2) {  // the settler
    volatile int* vev_ready = ev_ready;
    Settle c;
    for (int k = 0; k < nstages; ++k) {
      while (vev_ready[k & 1] != k + 1) {
      }
      __threadfence_block();
      const int* e = ev[k & 1];
      // two windows a pass: the second's prefix sum overlaps the first's
      // carries
#pragma unroll 2
      for (int j = 0; j < STAGE; j += 32) {
        const int i = k * STAGE + j + lane;
        settle32(c, e[j + lane], lane, i < steps, first, fcount, fval,
                 (size_t)i * lanes + l);
      }
      __syncwarp();
      if (lane == 0) *(volatile int*)&settled = k + 1;
    }
    return;
  }
  volatile int* vready = ready;
  volatile int* vreleased = &released;
  volatile int* vsettled = &settled;
  int rng = 0xFF00;
  for (int k = 0; k < nstages; ++k) {
    while (vready[k % NSTAGE] != k + 1) {
    }
    // the settler is done with the event list of stage k - 2
    while (*vsettled < k - 1) {
    }
    __threadfence_block();
    const int4* q = ring + (k % NSTAGE) * STAGE;
    int* e = ev[k & 1];
    int4 a[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) a[u] = q[u];
#pragma unroll 1
    for (int i = 0; i < STAGE; i += UNROLL) {
      // the next group (the stage's first again after its last, unused)
      const int j = (i + UNROLL) & (STAGE - 1);
      int4 b[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) b[u] = q[j + u];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) e[i + u] = code_step(rng, a[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) a[u] = b[u];
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      ((volatile int*)ev_ready)[k & 1] = k + 1;
      *vreleased = k + 1;
    }
  }
}

}  // namespace

extern "C" cudaError_t ffv2_rac_lanes(const int* sv, const int* bit,
                                      const int* mode, int steps, int lanes,
                                      int* first, int* fcount, int* fval,
                                      cudaStream_t stream) {
  if (steps > 0 && lanes > 0)
    rac_lanes_kernel<<<lanes, 96, 0, stream>>>(sv, bit, mode, steps, lanes,
                                               first, fcount, fval);
  return cudaGetLastError();
}
