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
// scratch; CUDA blocks run in no order, so here the carry stays in the
// registers of the lane's thread for the whole stream.
//
// Bound: the serial chain of each lane, one step after the other (about
// 0.4 M steps per 1080p slice); the bytes (3 int32 in, 3 int32 out per
// step and lane) take far less time at the card's memory rate.  Design:
// one thread per lane, 32 lanes a block (30 slices at 1080p: one warp);
// row-major (steps, lanes) input makes a warp's loads of one step one
// coalesced transaction, and the loads do not depend on the carry, so each
// thread loads CHUNK steps ahead of the recursion into registers.  The
// step count comes from the caller (no padding to a power of two).  All
// arithmetic is int32: range * sv < 2^24, and >> on the non-negative low
// is the scan's arithmetic shift.

#include "common.cuh"

namespace {

constexpr int LANES_PER_BLOCK = 32;
constexpr int CHUNK = 8;

__global__ void rac_lanes_kernel(const int* __restrict__ sv,
                                 const int* __restrict__ bit,
                                 const int* __restrict__ mode, int steps,
                                 int lanes, int* __restrict__ first,
                                 int* __restrict__ fcount,
                                 int* __restrict__ fval) {
  const int l = blockIdx.x * LANES_PER_BLOCK + threadIdx.x;
  if (l >= lanes) return;
  int low = 0, rng = 0xFF00, pending = -1, pcount = 0;
  for (int i0 = 0; i0 < steps; i0 += CHUNK) {
    int s_[CHUNK], b_[CHUNK], m_[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const size_t at = (size_t)(i0 + k) * lanes + l;
      const bool in = i0 + k < steps;
      s_[k] = in ? sv[at] : 0;
      b_[k] = in ? bit[at] : 0;
      m_[k] = in ? mode[at] : MODE_NOP;
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (i0 + k >= steps) break;
      const int m = m_[k];
      const bool is_op = m == MODE_OP;
      const bool is_flush = m == MODE_FLUSH1 || m == MODE_FLUSH2;
      int low1 = low, rng1 = rng;
      if (is_op) {
        const int r1 = (rng * s_[k]) >> 8;
        if (b_[k] != 0) {
          low1 = low + rng - r1;
          rng1 = r1;
        } else {
          rng1 = rng - r1;
        }
      } else if (is_flush) {
        if (m == MODE_FLUSH1) low1 = low + 0xFF;
        rng1 = 0xFF;
      }
      const bool renorm = rng1 < 0x100 && (is_op || is_flush);
      const bool cb = pending < 0;
      const bool cc = low1 <= 0xFF00;
      const bool cd = low1 >= 0x10000;
      const bool emit = renorm && !cb && (cc || cd);
      const size_t at = (size_t)(i0 + k) * lanes + l;
      first[at] = emit ? ((cc ? pending : pending + 1) & 0xFF) : -1;
      fcount[at] = emit ? pcount : 0;
      fval[at] = cc ? 0xFF : 0x00;
      if (renorm) {
        if (cb || cc)
          pending = low1 >> 8;
        else if (cd)
          pending = (low1 >> 8) & 0xFF;
        if (!cb) pcount = (cc || cd) ? 0 : pcount + 1;
        low = (low1 & 0xFF) << 8;
        rng = rng1 << 8;
      } else {
        low = low1;
        rng = rng1;
      }
    }
  }
}

}  // namespace

extern "C" cudaError_t ffv2_rac_lanes(const int* sv, const int* bit,
                                      const int* mode, int steps, int lanes,
                                      int* first, int* fcount, int* fval,
                                      cudaStream_t stream) {
  if (steps > 0 && lanes > 0)
    rac_lanes_kernel<<<(lanes + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK,
                       LANES_PER_BLOCK, 0, stream>>>(sv, bit, mode, steps,
                                                     lanes, first, fcount,
                                                     fval);
  return cudaGetLastError();
}
