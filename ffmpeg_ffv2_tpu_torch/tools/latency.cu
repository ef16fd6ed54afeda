// Dependent-chain latencies of one warp on the card, in SM clock cycles a
// link (clock64 around n links), for the chains that bound the serial
// kernels:
//   0  IADD3 -> LDS.U8: K2's and K6's table lookup (page + state, then the
//      byte of the 512-byte table in shared memory);
//   1  IMAD -> IADD -> SHF -> LOP3: K4's coder step as rac_render.cu
//      computes it (t = range * f + c; the sign of t - 0x10000 as a mask;
//      the new range t & ~0xFF or t >> 8, selected by one LOP3);
//   2  IMAD -> ISETP -> a branch over a block that is not run: the cost of
//      a branch on a value just computed, which K4's coder avoids;
//   3  K5's row, vlc.cu's chain_row (copied below) on inputs that differ
//      from link to link (16 rows of a table in shared memory, live and
//      not): bias -> the folded value -> drift + v, halved by a flag -> the
//      drift tests -> the selects of bias and drift.
// Built and run by tools/latency.py; not a kernel of any encoder path.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int select_bits(int m, int a, int b) {
  int r;
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;" : "=r"(r) : "r"(m), "r"(a), "r"(b));
  return r;
}

// vlc.cu's chain_row.
__device__ __forceinline__ int chain_row(int4 p, int half, int count,
                                         int& drift, int& bias) {
  const int c1 = p.y;
  const bool live = p.w != 0;
  const int hm = p.w & half;
  const int sgn = (2 * drift + count) >> 31;
  const int u = ((p.x - bias) & p.w) ^ hm;
  const int d1 = (drift + u - hm) >> p.z;
  const bool neg = live && d1 <= -c1;
  const bool pos = live && d1 > 0;
  const int dn = max(d1 + c1, 1 - c1), dp = min(d1 - c1, 0);
  const int bm = max(bias - 1, -128), bp = min(bias + 1, 127);
  drift = neg ? dn : (pos ? dp : d1);
  bias = neg ? bm : (pos ? bp : bias);
  return (int)((unsigned)(u - hm) << 2) | (sgn & 2) | (int)live;
}

template <int K>
__global__ void chain(const int* in, int n, long long* cyc, int* sink) {
  __shared__ unsigned char tab[1024];
  __shared__ int4 rows[16];
  __shared__ int words[16][32];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    tab[i] = (unsigned char)(in[i] & 0xFF);
  // K5's rows: 8-bit values, counts 2..121, three in four live, no halving
  if (threadIdx.x < 16) {
    const int r = in[128 + threadIdx.x];
    rows[threadIdx.x] = make_int4((r & 0xFF) - 128, 2 + (r >> 8 & 0x77),
                                  0, (r >> 16 & 3) ? 0xFF : 0);
  }
  __syncthreads();
  int x = in[threadIdx.x] & 0xFF;
  const int a = in[64] | 1, b = in[65], off = in[66] & 0x100;
  int drift = 0, bias = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; i += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (K == 0) x = tab[off + x];
      if (K == 1) {
        const int t = x * a + b;
        const int m = (t - 0x10000) >> 31;
        x = select_bits(m, t & ~0xFF, t >> 8);
      }
      if (K == 3) {
        const int4 p = rows[u];
        words[u][threadIdx.x] = chain_row(p, 0x80, x, drift, bias);
        x = p.y;
      }
      if (K == 2) {
        x = x * a + b;
        // a loop, so that the block is branched over, not predicated
        if (__builtin_expect(x == 0x7fffffff, 0))
          for (int k = 0; k < b; ++k) sink[64 + (k & 31)] = x;
      }
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) cyc[K] = t1 - t0;
  sink[threadIdx.x] += x + drift + bias + words[threadIdx.x & 15][0];
}

}  // namespace

// cyc[0..3]: the cycles of n links of each chain (n a multiple of 16);
// in: 1024 ints (table bytes, in[64..66] the operands, in[128..143] K5's
// rows).
extern "C" cudaError_t ffv2_latency(const int* in, int n, long long* cyc,
                                    int* sink, cudaStream_t stream) {
  chain<0><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  chain<1><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  chain<2><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  chain<3><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  return cudaGetLastError();
}
