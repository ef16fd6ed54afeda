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
//      drift tests -> the selects of bias and drift;
//   4  the ladder's climb (csrc/ladder.cu's climb, copied below) on counts
//      and flags that differ from link to link: the table entry of t =
//      count + P[i] (or the closed form past it), the selects of the next
//      index and its P;
//   5  one level of K18's argmax butterfly (csrc/ffv2_quant.cu, the order
//      without division): three shuffles, two 64-bit products, the
//      compares and the selects.
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

// ladder.cu's climb (with its 540-entry table in shared memory).
__device__ __forceinline__ void climb(const int* tab, int c, int fl, int& i,
                                      int& pi) {
  const int t = c + ((fl & 4) ? 0 : pi);
  const int e = tab[min(t, 539)];
  const int kb = min(47 - __clz(max(t - 284, 1)), 40);
  const bool big = t >= 540;
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

// ffv2_quant.cu's butterfly level on (a, b, i), the order without division.
__device__ __forceinline__ void argmax_level(int& a, int& b, int& i,
                                             int off) {
  const int oa = __shfl_xor_sync(0xffffffffu, a, off);
  const int ob = __shfl_xor_sync(0xffffffffu, b, off);
  const int oi = __shfl_xor_sync(0xffffffffu, i, off);
  const long long cl = (long long)oa * b, cr = (long long)a * ob;
  if (cl > cr || (cl == cr && oi < i)) {
    a = oa;
    b = ob;
    i = oi;
  }
}

template <int K>
__global__ void chain(const int* in, int n, long long* cyc, int* sink) {
  __shared__ unsigned char tab[1024];
  __shared__ int4 rows[16];
  __shared__ int words[16][32];
  __shared__ int ltab[540];
  __shared__ int2 events[16];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    tab[i] = (unsigned char)(in[i] & 0xFF);
  // the climb's table entries (any values in range: the chain's cost
  // does not depend on them) and 16 events: counts below and above 540,
  // every flag pattern
  for (int i = threadIdx.x; i < 540; i += blockDim.x)
    ltab[i] = (in[i] & 15) | (in[i] & 511) << 6 | (in[i + 1] & 511) << 16;
  if (threadIdx.x < 16)
    events[threadIdx.x] = make_int2(in[256 + threadIdx.x] & 0x3FFF,
                                    threadIdx.x & 7);
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
  int li = 0, lpi = 0, ca = x, cb = 1 + (x & 63), ci = threadIdx.x;
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
      if (K == 4) {
        const int2 ev = events[u];
        climb(ltab, ev.x, ev.y, li, lpi);
      }
      if (K == 5) argmax_level(ca, cb, ci, 1 << (u % 5));
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
  sink[threadIdx.x] += x + drift + bias + words[threadIdx.x & 15][0] + li +
                       lpi + ca + cb + ci;
}

}  // namespace

// cyc[0..5]: the cycles of n links of each chain (n a multiple of 16);
// in: 1024 ints (table bytes, in[64..66] the operands, in[128..143] K5's
// rows, in[256..271] the ladder's counts).
extern "C" cudaError_t ffv2_latency(const int* in, int n, long long* cyc,
                                    int* sink, cudaStream_t stream) {
  chain<0><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  chain<1><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  chain<2><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  chain<3><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  chain<4><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  chain<5><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  return cudaGetLastError();
}
