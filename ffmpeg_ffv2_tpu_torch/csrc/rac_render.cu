// K4 rac_render: the range coder and the packet-byte render of each slice.
//
// Replaces three TPU kernel bodies:
//   ffmpeg_ffv2_tpu/ffv1/pallas_coder.py:_coder_kernel_packed
//     (rac_pallas_packed): the (low, range, pending, pcount) recursion,
//     one lane per slice, writing staged (first, fcount, fval) events;
//   ffmpeg_ffv2_tpu/ffv1/render_pallas.py:_compact_kernel and
//     _place_bytes_kernel (render_bytes_pallas): compaction of the staged
//     events and placement of the bytes with fill runs of at most 1023.
// The staged intermediate and both render kernels exist because TPU lanes
// cannot store to data-dependent addresses; the render kernels carry a
// write position from grid step to grid step.
//
// Bound: latency of the coder's serial recursion, one op after the other
// per slice (~0.45 M ops per 1080p slice); 30 slices leave the card almost
// idle, and the bytes moved (4 per op in, ~1 per 17 ops out) are small.
// On this card a branch on a value just computed costs a warp some 50
// cycles (tools/latency.cu), so the design keeps branches off the chain.
// One block per slice, three warps, one stage of STAGE ops at a time:
// - Warp 1 (the producer) streams the slice's op words from global memory
//   into a ring of NSTAGE stages in shared memory, and turns each op word
//   into the four factors of its step (below), so that the coder decodes
//   nothing; ops past `steps` become NOPs.  It publishes a stage through
//   a ready word and refills it once the coder has released it.
// - Warp 0 (the coder) runs the range recursion with no branch: each step
//   is two multiply-adds, and the renormalisation's shift of the range is
//   a mask made by arithmetic.  A step's low increment is summed, and at
//   each renormalisation the sum since the last one is written to the
//   stage's event list in shared memory (a store every step, whose index
//   moves on only at a renormalisation).  The chain of a step is IMAD ->
//   IADD -> SHF -> LOP3.
// - Warp 2 (the settler) takes each stage's event list one stage behind
//   the coder and runs the rest of the renormalisation in order: low,
//   the pending byte and its count, the emitted byte (a predicated store
//   from lane 0) and fill runs of any length (all 32 lanes), straight to
//   bytes[s, :].  The coder never waits on it while it keeps up.
// Nothing passes between blocks, writes past buf_cap are dropped while
// the true length is still counted, and the wrapper zero-fills the rows,
// so bytes past the length are 0.

#include "common.cuh"

namespace {

constexpr int STAGE = 512;   // ops a stage (8 KB of factors)
constexpr int NSTAGE = 4;    // stages in the ring

// One op word [mode:2 | bit:1 | sv:8] as two multiply-adds on the old
// range, with r1 = (range * sv) >> 8 and range - r1 = (range * (256 - sv)
// + 255) >> 8:
//   range' = (range * f + c) >> 8,  low' = low + ((range * g + h) >> 8);
//   op, bit 1:  f = sv,       c = 0,      g = 256 - sv, h = 255;
//   op, bit 0:  f = 256 - sv, c = 255,    g = 0,        h = 0;
//   flush 1:    f = 0,        c = 0xFF00, g = 0,        h = 0xFF00;
//   flush 2:    f = 0,        c = 0xFF00, g = 0,        h = 0;
//   NOP:        f = 256,      c = 0,      g = 0,        h = 0.
// The range is at least 0x100 before every step, a NOP keeps it, and sv
// is at least 1 in a coder's op stream, so a step renormalises exactly
// when range * f + c < 0x10000.
__device__ __forceinline__ int4 factors(int w) {
  const int m = (w >> 9) & 3;
  const int sv = w & 0xFF;
  const bool one = (w >> 8) & 1;
  const bool op = m == MODE_OP;
  int4 q;
  q.x = op ? (one ? sv : 256 - sv) : (m == MODE_NOP ? 256 : 0);
  q.y = op ? (one ? 0 : 255) : (m == MODE_NOP ? 0 : 0xFF00);
  q.z = op && one ? 256 - sv : 0;
  q.w = op ? (one ? 255 : 0) : (m == MODE_FLUSH1 ? 0xFF00 : 0);
  return q;
}

// Warp 1: stage k of the slice's first `steps` ops into ring slot k %
// NSTAGE once the coder has released stage k - NSTAGE.
__device__ void produce(const int* __restrict__ ops, int steps, int nstages,
                        int lane, int4* ring, volatile int* ready,
                        volatile int* released) {
  constexpr int PER = STAGE / 32;
  for (int k = 0; k < nstages; ++k) {
    if (k >= NSTAGE)
      while (*released < k - NSTAGE + 1) {
      }
    __threadfence_block();
    int4* dst = ring + (k % NSTAGE) * STAGE;
    const int first = k * STAGE + lane;
    int w[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = first + 32 * u;
      w[u] = i < steps ? __ldg(ops + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) dst[32 * u + lane] = factors(w[u]);
    __threadfence_block();
    __syncwarp();
    if (lane == 0) ready[k % NSTAGE] = k + 1;
  }
}

// A store of the byte v to p where ok holds, with no branch.
__device__ __forceinline__ void store_if(unsigned char* p, int v, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q st.global.u8 [%0], %1;\n}\n" ::"l"(p),
      "r"(v), "r"((unsigned)ok)
      : "memory");
}

// The coder's state: the range, and the low increments summed since the
// last renormalisation.
struct Chain {
  int rng = 0xFF00, sum = 0;
};

// m ? a : b bit by bit, one LOP3 (ptxas would split the select into two).
__device__ __forceinline__ int select_bits(int m, int a, int b) {
  int r;
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;" : "=r"(r) : "r"(m), "r"(a), "r"(b));
  return r;
}

// One step on the factors q = (f, c, g, h): the low increment of the old
// range joins the sum; where the new range falls below 0x100 (m all ones)
// it is shifted up by 8 and the sum goes to ev[n], n moving on.
__device__ __forceinline__ void step(Chain& c, int4 q, int* ev, int& n) {
  const int t = c.rng * q.x + q.y;
  c.sum += (c.rng * q.z + q.w) >> 8;
  const int m = (t - 0x10000) >> 31;
  c.rng = select_bits(m, t & ~0xFF, t >> 8);
  ev[n] = c.sum;
  n -= m;
  c.sum &= ~m;
}

// The settler's state.
struct Settle {
  int low = 0, pending = -1, pcount = 0, pos = 0;
};

// The rest of one renormalisation, whose step added `inc` to low since the
// last: settle the pending byte, emit it with its fill run where the
// carry is known.  Its decisions are masks (all ones or 0) made by
// arithmetic; lane 0 stores the byte at the write position by a
// predicated store at every renormalisation: the emitted byte, or 0
// where nothing is emitted (a later emit overwrites it, and bytes past the
// length are 0).  Only a fill run (a pending count above 0 at an emit,
// rare) branches; its bytes lie past every position lane 0 has written.
// A slice's byte count is at most its step count, so it fits an int.
__device__ __forceinline__ void settle(Settle& c, int inc, unsigned char* out,
                                       int buf_cap, int lane) {
  const int low = c.low + inc, pending = c.pending, pcount = c.pcount;
  const int cb = pending >> 31;              // no pending byte yet
  const int cc = ~((0xFF00 - low) >> 31);    // low <= 0xFF00: no carry
  const int cd = (0xFFFF - low) >> 31;       // low >= 0x10000: a carry
  const int emit = ~cb & (cc | cd);
  store_if(out + c.pos, (pending - cd) & emit, lane == 0 && c.pos < buf_cap);
  if (__builtin_expect(emit & pcount, 0)) {  // pcount > 0 at an emit
    const int end = min(c.pos + 1 + pcount, buf_cap);
    for (int q = c.pos + 1 + lane; q < end; q += 32)
      out[q] = (unsigned char)cc;            // 0xFF, or 0 after a carry
  }
  c.pos += emit & (1 + pcount);
  const int hi = low >> 8, to_hi = cb | cc;
  c.pending = (to_hi & hi) | (~to_hi & ((cd & hi & 0xFF) | (~cd & pending)));
  c.pcount = (cb & pcount) | (~cb & ~(cc | cd) & (pcount + 1));
  c.low = (low & 0xFF) << 8;
}

constexpr int UNROLL = 16;   // coder steps between two loop branches

__global__ void __launch_bounds__(96)
rac_render_kernel(const int* __restrict__ opw, int op_stride, int steps,
                  unsigned char* __restrict__ bytes, int buf_cap,
                  int* __restrict__ lengths) {
  __shared__ int4 ring[NSTAGE * STAGE];
  __shared__ int ev[2][STAGE];   // a stage's renormalisations, 2 stages
  __shared__ int ev_n[2];
  __shared__ int ready[NSTAGE], ev_ready[2];
  __shared__ int released, settled;
  const int s = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nstages = (steps + STAGE - 1) / STAGE;
  if (threadIdx.x < NSTAGE) ready[threadIdx.x] = 0;
  if (threadIdx.x < 2) ev_ready[threadIdx.x] = 0;
  if (threadIdx.x == 0) released = settled = 0;
  __syncthreads();
  const int* ops = opw + (size_t)s * op_stride;
  if (warp == 1) {
    produce(ops, steps, nstages, lane, ring, ready, &released);
    return;
  }
  if (warp == 2) {  // the settler
    volatile int* vev_ready = ev_ready;
    volatile int* vev_n = ev_n;
    unsigned char* out = bytes + (size_t)s * buf_cap;
    Settle c;
    for (int k = 0; k < nstages; ++k) {
      while (vev_ready[k & 1] != k + 1) {
      }
      __threadfence_block();
      const int n = vev_n[k & 1];
      const int* e = ev[k & 1];
#pragma unroll 1
      for (int i = 0; i < n; ++i) settle(c, e[i], out, buf_cap, lane);
      __syncwarp();
      if (lane == 0) *(volatile int*)&settled = k + 1;
    }
    if (lane == 0) lengths[s] = c.pos;
    return;
  }
  volatile int* vready = ready;
  volatile int* vreleased = &released;
  volatile int* vsettled = &settled;
  Chain c;
  for (int k = 0; k < nstages; ++k) {
    while (vready[k % NSTAGE] != k + 1) {
    }
    // the settler is done with the event list of stage k - 2
    while (*vsettled < k - 1) {
    }
    __threadfence_block();
    const int4* q = ring + (k % NSTAGE) * STAGE;
    int* e = ev[k & 1];
    int n = 0;
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
      for (int u = 0; u < UNROLL; ++u) step(c, a[u], e, n);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) a[u] = b[u];
    }
    __syncwarp();
    if (lane == 0) {
      ev_n[k & 1] = n;
      __threadfence_block();
      ((volatile int*)ev_ready)[k & 1] = k + 1;
      *vreleased = k + 1;
    }
  }
}

}  // namespace

extern "C" cudaError_t ffv2_rac_render(const int* opw, int op_stride,
                                       int steps, int S, unsigned char* bytes,
                                       int buf_cap, int* lengths,
                                       cudaStream_t stream) {
  if (S > 0)
    rac_render_kernel<<<S, 96, 0, stream>>>(opw, op_stride, steps, bytes,
                                            buf_cap, lengths);
  return cudaGetLastError();
}
