// K8 sort and K9 rowsort: the multi-operand bitonic row sort.
//
// Replaces the TPU kernel bodies ffmpeg_ffv2_tpu/ops/sort_pallas.py:
// _sort_kernel (_sort_flat: grid (phase, chunk) in order on one core, LOCAL
// phases run a span of the stage table on a VMEM-resident chunk, CROSS
// phases one sub-stage j >= chunk log2 as half-chunk exchanges, in place
// on the aliased output across grid steps) and _rowsort_kernel
// (_sort_vmem: the whole stage table on one VMEM-resident row a grid step).
//
// The operands arrive stacked as one contiguous (n, B, M) int32 buffer and
// are sorted in place, so any operand count passes as one pointer.  Sub-
// stage (k, j) pairs element g with g ^ (1 << j); the pair sorts ascending
// iff bit k + 1 of the lower index is 0 and swaps only where the keys
// (operand 0, then operand 1 if num_keys == 2; signed int32) are strictly
// out of order, as sort_pallas._exchange does.
//
// CUDA blocks run in no order, so a phase boundary is a kernel boundary on
// the caller's stream: the launcher walks the plan's phase table (host
// memory, ops/sort.py:plan) and launches one kernel per phase.
// - local kernel: one block per (chunk, row) holds 2^Lc elements of all n
//   operands in dynamic shared memory and runs a span of the stage table
//   (device memory, k << 8 | j) with __syncthreads() between sub-stages;
// - cross kernel: one thread per pair runs one sub-stage j >= Lc straight
//   on device memory.
// K9 (ffv2_rowsort) gets Lc = L when a whole row fits in shared memory:
// one local phase, one block per row.  Otherwise it runs the same phase
// schedule as K8, with blockIdx.y as the row.
//
// Bound: device memory.  Every phase reads and writes all n operands, so
// a sort moves (local phases + cross phases) * 2 * n * B * M * 4 bytes;
// at (1, 2^22) x 10 with Lc = 12 that is 66 passes.  The network's
// M * L * (L + 1) / 4 compare-exchanges a row are cheap beside that.  The
// chunk is as large as the card's opt-in shared memory allows, so that
// most sub-stages run on chip; merging cross sub-stages is later work.

#include "common.cuh"

namespace {

constexpr int CROSS_THREADS = 256;
constexpr int LOCAL_THREADS = 1024;
constexpr int PHASE_LOCAL = 0;

template <int NK>
__device__ __forceinline__ bool lex_lt(int a0, int a1, int b0, int b1) {
  return NK == 1 ? a0 < b0 : (a0 < b0 || (a0 == b0 && a1 < b1));
}

template <int NK>
__global__ void sort_local_kernel(int* __restrict__ x, int n, int B,
                                  long long M, int Lc,
                                  const int* __restrict__ stages, int s0,
                                  int s1) {
  extern __shared__ int s[];
  const int C = 1 << Lc;
  const long long base = (long long)blockIdx.x * C;
  const long long ostride = (long long)B * M;
  int* row = x + (long long)blockIdx.y * M + base;
  for (int i = 0; i < n; ++i)
    for (int e = threadIdx.x; e < C; e += blockDim.x)
      s[i * C + e] = row[i * ostride + e];
  __syncthreads();
  const int half = C >> 1;
  for (int t = s0; t < s1; ++t) {
    const int kj = stages[t];
    const int k = kj >> 8, j = kj & 0xFF;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int lo = ((p >> j) << (j + 1)) | (p & ((1 << j) - 1));
      const int hi = lo | (1 << j);
      const bool asc = (((base + lo) >> (k + 1)) & 1) == 0;
      const int l0 = s[lo], h0 = s[hi];
      const int l1 = NK == 2 ? s[C + lo] : 0;
      const int h1 = NK == 2 ? s[C + hi] : 0;
      const bool swap = asc ? lex_lt<NK>(h0, h1, l0, l1)
                            : lex_lt<NK>(l0, l1, h0, h1);
      if (swap)
        for (int i = 0; i < n; ++i) {
          const int a = s[i * C + lo];
          s[i * C + lo] = s[i * C + hi];
          s[i * C + hi] = a;
        }
    }
    __syncthreads();
  }
  for (int i = 0; i < n; ++i)
    for (int e = threadIdx.x; e < C; e += blockDim.x)
      row[i * ostride + e] = s[i * C + e];
}

template <int NK>
__global__ void sort_cross_kernel(int* __restrict__ x, int n, int B,
                                  long long M, int k, int j) {
  const long long p = blockIdx.x * (long long)CROSS_THREADS + threadIdx.x;
  if (p >= M / 2) return;
  const long long lo = ((p >> j) << (j + 1)) | (p & ((1LL << j) - 1));
  const long long hi = lo + (1LL << j);
  const bool asc = ((lo >> (k + 1)) & 1) == 0;
  const long long ostride = (long long)B * M;
  int* row = x + (long long)blockIdx.y * M;
  const int l0 = row[lo], h0 = row[hi];
  const int l1 = NK == 2 ? row[ostride + lo] : 0;
  const int h1 = NK == 2 ? row[ostride + hi] : 0;
  const bool swap = asc ? lex_lt<NK>(h0, h1, l0, l1)
                        : lex_lt<NK>(l0, l1, h0, h1);
  if (!swap) return;
  for (int i = 0; i < n; ++i) {
    int* r = row + i * ostride;
    const int a = r[lo];
    r[lo] = r[hi];
    r[hi] = a;
  }
}

template <int NK>
cudaError_t run_plan(int* x, int n, int B, int M, int Lc,
                     const int* phases, int n_phases, const int* stages,
                     cudaStream_t stream) {
  const int C = 1 << Lc;
  const size_t smem = (size_t)n * C * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      sort_local_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int local_threads = C / 2 < LOCAL_THREADS ? C / 2 : LOCAL_THREADS;
  const dim3 local_grid(M / C, B);
  const dim3 cross_grid(
      (unsigned)(((long long)M / 2 + CROSS_THREADS - 1) / CROSS_THREADS), B);
  for (int p = 0; p < n_phases; ++p) {
    const int typ = phases[3 * p], a = phases[3 * p + 1],
              b = phases[3 * p + 2];
    if (typ == PHASE_LOCAL)
      sort_local_kernel<NK><<<local_grid, local_threads, smem, stream>>>(
          x, n, B, M, Lc, stages, a, b);
    else
      sort_cross_kernel<NK><<<cross_grid, CROSS_THREADS, 0, stream>>>(
          x, n, B, M, a, b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t sort_entry(int* x, int n, int B, int M, int num_keys, int Lc,
                       const int* phases, int n_phases, const int* stages,
                       cudaStream_t stream) {
  if (n < 1 || B < 1 || M < 2 || Lc < 1 || (1 << Lc) > M ||
      (num_keys != 1 && num_keys != 2) || num_keys > n)
    return cudaErrorInvalidValue;
  return num_keys == 1
             ? run_plan<1>(x, n, B, M, Lc, phases, n_phases, stages, stream)
             : run_plan<2>(x, n, B, M, Lc, phases, n_phases, stages, stream);
}

}  // namespace

// K8: one long row (B == 1 past the JAX op's VMEM budget), hierarchical.
extern "C" cudaError_t ffv2_sort(int* x, int n, int B, int M, int num_keys,
                                 int Lc, const int* phases, int n_phases,
                                 const int* stages, cudaStream_t stream) {
  return sort_entry(x, n, B, M, num_keys, Lc, phases, n_phases, stages,
                    stream);
}

// K9: batched rows (or a short row); one block a row when Lc == L.
extern "C" cudaError_t ffv2_rowsort(int* x, int n, int B, int M,
                                    int num_keys, int Lc, const int* phases,
                                    int n_phases, const int* stages,
                                    cudaStream_t stream) {
  return sort_entry(x, n, B, M, num_keys, Lc, phases, n_phases, stages,
                    stream);
}
