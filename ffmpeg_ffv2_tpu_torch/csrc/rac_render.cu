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
// per slice (~0.4 M ops per 1080p slice); 30 slices leave the card almost
// idle.  Design: one thread per slice (one block each) runs the recursion
// of pallas_coder.py:121-165 over its op words and writes each emitted
// first byte, then its fcount fill bytes, straight into its row of
// bytes[s, :].  Nothing passes between blocks, fill runs have no cap (the
// render_bytes fallback for fcount > 1023 is not needed), writes past
// buf_cap are dropped while the true length is still counted, and the
// wrapper zero-fills the rows, so bytes past the length are 0.

#include "common.cuh"

namespace {

__global__ void rac_render_kernel(const int* __restrict__ opw, int op_stride,
                                  int steps, int S,
                                  unsigned char* __restrict__ bytes,
                                  int buf_cap, int* __restrict__ lengths) {
  const int s = blockIdx.x;
  if (s >= S || threadIdx.x != 0) return;
  const int* ops = opw + (size_t)s * op_stride;
  unsigned char* out = bytes + (size_t)s * buf_cap;
  int low = 0, rng = 0xFF00, pending = -1, pcount = 0;
  long long pos = 0;
  for (int i = 0; i < steps; ++i) {
    const int w = ops[i];
    const int m = (w >> 9) & 3;
    if (m == MODE_NOP) continue;
    if (m == MODE_OP) {
      const int r1 = (rng * (w & 0xFF)) >> 8;
      if ((w >> 8) & 1) {
        low += rng - r1;
        rng = r1;
      } else {
        rng -= r1;
      }
    } else {  // terminate: flush 1 adds 0xFF to low, both set range 0xFF
      if (m == MODE_FLUSH1) low += 0xFF;
      rng = 0xFF;
    }
    if (rng >= 0x100) continue;  // no renormalisation this step
    const bool cb = pending < 0;
    const bool cc = low <= 0xFF00;
    const bool cd = low >= 0x10000;
    if (!cb && (cc || cd)) {  // emit the pending byte and its fill run
      if (pos < buf_cap) out[pos] = (cc ? pending : pending + 1) & 0xFF;
      ++pos;
      const unsigned char fill = cc ? 0xFF : 0x00;
      const long long end = pos + pcount;
      for (long long q = pos; q < end && q < buf_cap; ++q) out[q] = fill;
      pos = end;
    }
    if (cb || cc)
      pending = low >> 8;
    else if (cd)
      pending = (low >> 8) & 0xFF;
    if (!cb) pcount = (cc || cd) ? 0 : pcount + 1;
    low = (low & 0xFF) << 8;
    rng <<= 8;
  }
  lengths[s] = (int)min(pos, (long long)0x7FFFFFFF);
}

}  // namespace

extern "C" cudaError_t ffv2_rac_render(const int* opw, int op_stride,
                                       int steps, int S, unsigned char* bytes,
                                       int buf_cap, int* lengths,
                                       cudaStream_t stream) {
  if (S > 0)
    rac_render_kernel<<<S, 1, 0, stream>>>(opw, op_stride, steps, S, bytes,
                                           buf_cap, lengths);
  return cudaGetLastError();
}
