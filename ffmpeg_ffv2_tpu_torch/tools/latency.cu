// Dependent-chain latencies of one warp on the card, in SM clock cycles a
// link (clock64 around n links), for the chains that bound the serial
// kernels:
//   0  IADD3 -> LDS.U8: K2's and K6's table lookup (page + state, then the
//      byte of the 512-byte table in shared memory);
//   1  IMAD -> IADD -> SHF -> LOP3: K4's coder step as rac_render.cu
//      computes it (t = range * f + c; the sign of t - 0x10000 as a mask;
//      the new range t & ~0xFF or t >> 8, selected by one LOP3);
//   2  IMAD -> ISETP -> a branch over a block that is not run: the cost of
//      a branch on a value just computed, which K4's coder avoids.
// Built and run by tools/latency.py; not a kernel of any encoder path.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int select_bits(int m, int a, int b) {
  int r;
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;" : "=r"(r) : "r"(m), "r"(a), "r"(b));
  return r;
}

template <int K>
__global__ void chain(const int* in, int n, long long* cyc, int* sink) {
  __shared__ unsigned char tab[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    tab[i] = (unsigned char)(in[i] & 0xFF);
  __syncthreads();
  int x = in[threadIdx.x] & 0xFF;
  const int a = in[64] | 1, b = in[65], off = in[66] & 0x100;
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
  sink[threadIdx.x] += x;
}

}  // namespace

// cyc[0..2]: the cycles of n links of each chain (n a multiple of 16);
// in: 1024 ints (table bytes, and in[64..66] the operands).
extern "C" cudaError_t ffv2_latency(const int* in, int n, long long* cyc,
                                    int* sink, cudaStream_t stream) {
  chain<0><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  chain<1><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  chain<2><<<1, 32, 0, stream>>>(in, n, cyc, sink);
  return cudaGetLastError();
}
