// K3 expand: stream-order per-pixel sv words -> per-slice rac op words.
//
// Replaces ffmpeg_ffv2_tpu/ffv1/expand_pallas.py:_expand_kernel
// (expand_pallas).  The TPU kernel walks 4096-op chunks in grid order and
// carries an SMEM record pointer from chunk to chunk; within a chunk it
// moves records to their op positions with a log-shift distribute and a
// segmented fill, because TPU lanes cannot store to data-dependent
// addresses.
//
// Bound: device memory.  At 1080p ~3.1 M pixel records write ~4 op words
// each (one int32 per op) after reading the diff, the op offset and up to
// W packed sv words per record.
// Design: one thread per record.  A pixel record (s, i) writes its
// event_count(diff) op words at base[s, i] = hpad + exclusive_cumsum of
// the counts, which the wrapper computes with torch.cumsum as
// build_expand_window does (expand_pallas.py:276-279); the per-record base
// replaces the record pointer, so no state passes between blocks.  Header
// records take positions < hlen[s]; the three tail records write the
// terminator (sv 129, bit 0) and the two flush ops at total[s] + 0..2.
// The wrapper zero-fills the output, so every other position is a NOP.
// Ops at or past op_cap are dropped (the encoder retries with a larger
// op_cap).  Op k of a pixel reads byte k of its emission-order sv words
// (0 past the W words carried).

#include "common.cuh"

namespace {

__global__ void expand_kernel(const int* __restrict__ words, int W,
                              const int* __restrict__ diff,
                              const int* __restrict__ base,
                              const int* __restrict__ svp,
                              const int* __restrict__ btp,
                              const int* __restrict__ hlen,
                              const int* __restrict__ total, int S, int npix,
                              int hpad, int op_cap, int* __restrict__ opw) {
  const long long nrec = (long long)hpad + npix + 3;
  const long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (g >= S * nrec) return;
  const int s = (int)(g / nrec);
  int r = (int)(g % nrec);
  int* out = opw + (size_t)s * op_cap;
  if (r < hpad) {  // slice prefix: keyframe bit and headers
    if (r < hlen[s] && r < op_cap) {
      const int h = s * hpad + r;
      out[r] = (svp[h] & 0xFF) | (btp[h] << 8) | (MODE_OP << 9);
    }
    return;
  }
  r -= hpad;
  if (r < npix) {  // pixel: put_symbol ops in emission order
    const size_t px = (size_t)s * npix + r;
    const int d = diff[px];
    const int a = d < 0 ? -d : d;
    const int e = exponent_of(a);
    const int count = d ? 2 * e + 3 : 1;
    const int b0 = base[px];
    for (int k = 0; k < count; ++k) {
      const int pos = b0 + k;
      if (pos < 0 || pos >= op_cap) break;
      int bit;
      if (k == 0)
        bit = d == 0;
      else if (k <= e)
        bit = 1;
      else if (k == e + 1)
        bit = 0;
      else if (k <= 2 * e + 1)
        bit = (a >> (2 * e + 1 - k)) & 1;
      else
        bit = d < 0;
      const int wsel = k >> 2;
      const int sv =
          wsel < W ? (words[((size_t)wsel * S + s) * npix + r] >> ((k & 3) * 8)) &
                         0xFF
                   : 0;
      out[pos] = sv | (bit << 8) | (MODE_OP << 9);
    }
    return;
  }
  r -= npix;  // tail: terminator, flush 1, flush 2
  const int pos = total[s] + r;
  if (pos >= 0 && pos < op_cap)
    out[pos] = r == 0 ? ((MODE_OP << 9) | 129)
                      : (r == 1 ? MODE_FLUSH1 << 9 : MODE_FLUSH2 << 9);
}

}  // namespace

extern "C" cudaError_t ffv2_expand(const int* words, int W, const int* diff,
                                   const int* base, const int* svp,
                                   const int* btp, const int* hlen,
                                   const int* total, int S, int npix,
                                   int hpad, int op_cap, int* opw,
                                   cudaStream_t stream) {
  const long long n = (long long)S * ((long long)hpad + npix + 3);
  if (n > 0) {
    const int threads = 256;
    expand_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    stream>>>(words, W, diff, base, svp, btp, hlen, total, S,
                              npix, hpad, op_cap, opw);
  }
  return cudaGetLastError();
}
