// K8 sort and K9 rowsort: the multi-operand bitonic row sort.
//
// Replaces the TPU kernel bodies ffmpeg_ffv2_tpu/ops/sort_pallas.py:
// _sort_kernel (_sort_flat: grid (phase, chunk) in order on one core, LOCAL
// phases run a span of the stage table on a VMEM-resident chunk, CROSS
// phases one sub-stage j >= chunk log2 as half-chunk exchanges, in place
// on the aliased output across grid steps) and _rowsort_kernel
// (_sort_vmem: the whole stage table on one VMEM-resident row a grid step).
//
// Sub-stage (k, j) pairs element g with g ^ (1 << j); the pair sorts
// ascending iff bit k + 1 of the lower index is 0 and swaps only where the
// keys (operand 0, then operand 1 if num_keys == 2; signed int32) are
// strictly out of order, as sort_pallas._exchange does.
//
// Bound: device memory.  Each pass over the rows moves every word an
// element carries, so the design cuts both the words and the passes:
// - Words.  The swap decision reads the keys only, so the element's
//   original column can ride through the network in place of the payloads
//   (index mode, n > num_keys + 1: W = num_keys + 1 words an element) and
//   a gather fetches each payload by it at the end; its order among equal
//   keys is the network's, exactly as if the payloads had ridden.  With at
//   most one payload the operands ride themselves (direct mode, W = n).
//   W <= 3 either way, so the chunk 2^Lc (ops/sort.py:words_and_chunk:
//   the W padded planes in the block's opt-in shared memory, at most
//   2^14) is 2^13 or 2^14 elements, or smaller (down to 2^10) where the
//   rows hold fewer chunks than the card has SMs.
// - Passes.  A phase boundary is a kernel boundary on the caller's stream
//   (CUDA blocks run in no order); the launcher walks the phase table
//   (host memory, ops/sort.py:plan_merged) and launches one kernel per
//   phase:
//   * local kernel: one block per (chunk, row) holds 2^Lc elements of the
//     W words in dynamic shared memory and runs a span of the stage table
//     (device memory, k << 8 | j).  It is bound by its shared-memory
//     traffic and instructions, not by device memory, so the sub-stages
//     run in register groups: up to RL = 4 consecutive j of one k between
//     two barriers, each thread holding the 16 elements that differ in the
//     group's bits (C / 16 threads, at most 1024).  The first
//     phase reads the keys straight from the caller's operands (a device
//     table of their pointers, any n) and makes the column; the last
//     writes the keys into the output.
//   * merged kernel: one group of up to R = 4 consecutive cross sub-stages
//     j, j - 1, .., j - R + 1 (all >= Lc) of one k in one pass: each thread
//     holds the 2^R elements that differ only in those bits in registers
//     (consecutive threads take consecutive low bits, so every load and
//     store is coalesced) and runs the R sub-stages there; the direction,
//     bit k + 1, is the same for all of them.
//   * gather kernel (index mode): out[i][b][m] = op_i[b][col[b][m]] for
//     each payload i, one payload per grid z, so the blocks in flight
//     gather from one payload's rows at a time and its sectors stay in L2.
// At (1, 2^22) x 10: W = 2, Lc = 14, 9 local and 12 merged passes of
// 32 MB each way, then the gather of 8 payloads.

#include "common.cuh"

namespace {

constexpr int MERGED_THREADS = 256;
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_PER_THREAD = 4;   // one int4 of columns a thread
constexpr int RL = 4;      // local register group: 16 elements a thread
constexpr int MAX_R = 4;   // merged cross sub-stages (ops/sort.py:MERGE_R)
constexpr int MAX_DEVICES = 64;
constexpr int PHASE_LOCAL = 0;
constexpr int PHASE_MERGED = 2;

template <int NK>
__device__ __forceinline__ bool lex_lt(int a0, int a1, int b0, int b1) {
  return NK == 1 ? a0 < b0 : (a0 < b0 || (a0 == b0 && a1 < b1));
}

// Chunk-local index e at its padded place in a shared-memory plane: one
// word of padding every 32 keeps the strided register groups free of bank
// conflicts.
__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

// The elements e < 16 of a thread's register group whose bit b is set.
__device__ __forceinline__ unsigned bit_set_mask(int b) {
  switch (b) {
    case 0: return 0xAAAAu;
    case 1: return 0xCCCCu;
    case 2: return 0xF0F0u;
    default: return 0xFF00u;
  }
}

// Compare-exchange of register bit B over a thread's 2^R elements; bit e
// of desc is 1 where the pair whose lower element is e sorts descending.
template <int NK, int W, int R, int B>
__device__ __forceinline__ void exchange_bit(int (&v)[W][1 << R],
                                             unsigned desc_mask) {
#pragma unroll
  for (int e = 0; e < (1 << R); ++e) {
    if (e & (1 << B)) continue;
    const int f = e | (1 << B);
    const bool desc = (desc_mask >> e) & 1;
    const bool swap =
        desc ? lex_lt<NK>(v[0][e], v[NK - 1][e], v[0][f], v[NK - 1][f])
             : lex_lt<NK>(v[0][f], v[NK - 1][f], v[0][e], v[NK - 1][e]);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int a = v[w][e], c = v[w][f];
      v[w][e] = swap ? c : a;
      v[w][f] = swap ? a : c;
    }
  }
}

// One chunk of one row: words w < W read from the operand table `src`
// (first phase; in index mode word W - 1 is the column) or from x, sorted
// through stages [s0, s1), written to keys_out (keys) and x (the rest).
// The stages run in groups of up to R consecutive j of one k: each of the
// C >> R threads loads the 2^R elements that differ only in the group's
// register bits lo .. lo + R - 1, runs the group's sub-stages in
// registers, and stores them back; one barrier a group.
template <int NK, int W>
__global__ void __launch_bounds__(1024)
sort_local_kernel(const long long* __restrict__ src, bool make_column,
                  int* __restrict__ x, int* __restrict__ keys_out,
                  long long ostride, long long M, int Lc,
                  const int* __restrict__ stages, int s0, int s1) {
  constexpr int R = RL;
  constexpr int E = 1 << R;
  constexpr int V = E / 4;  // int4 vectors a thread moves per plane
  extern __shared__ int s[];
  const int C = 1 << Lc;
  const int T = C >> R;  // blockDim.x
  const int P = C + (C >> 5);  // a padded plane
  const long long base = (long long)blockIdx.x * C;
  const long long roff = (long long)blockIdx.y * M + base;
  const int t = threadIdx.x;
  {
    // every load of the chunk in flight before the first store
    int4 a[W][V];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (make_column && w == W - 1) continue;
      const int4* in4 = reinterpret_cast<const int4*>(
          src ? reinterpret_cast<const int*>(src[w]) + roff
              : x + w * ostride + roff);
#pragma unroll
      for (int u = 0; u < V; ++u) a[w][u] = in4[t + u * T];
    }
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int q = t + u * T;
        int* d = s + w * P + pad(4 * q);  // 4 q .. 4 q + 3: one run of 32
        if (make_column && w == W - 1) {
          const int c = (int)base + 4 * q;
          d[0] = c;
          d[1] = c + 1;
          d[2] = c + 2;
          d[3] = c + 3;
        } else {
          d[0] = a[w][u].x;
          d[1] = a[w][u].y;
          d[2] = a[w][u].z;
          d[3] = a[w][u].w;
        }
      }
  }
  __syncthreads();
  for (int i = s0; i < s1;) {
    const int k = stages[i] >> 8, jhi = stages[i] & 0xFF;
    const int lo = jhi - R + 1 > 0 ? jhi - R + 1 : 0;
    int r = 1;
    while (i + r < s1 && r <= jhi - lo &&
           stages[i + r] == ((k << 8) | (jhi - r)))
      ++r;
    const int b0 = (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + R));
    // direction: bit k + 1 of an element's index, above the chunk, among
    // the register bits, or in b0
    const int kb = k + 1;
    unsigned desc =
        ((kb >= Lc ? base >> kb : (long long)b0 >> kb) & 1) ? ~0u : 0u;
    if (kb < Lc && kb >= lo && kb < lo + R) desc = bit_set_mask(kb - lo);
    int v[W][E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int a = pad(b0 | (e << lo));
#pragma unroll
      for (int w = 0; w < W; ++w) v[w][e] = s[w * P + a];
    }
    for (int q = 0; q < r; ++q) {
      switch (jhi - q - lo) {
        case 0: exchange_bit<NK, W, R, 0>(v, desc); break;
        case 1: exchange_bit<NK, W, R, 1>(v, desc); break;
        case 2: exchange_bit<NK, W, R, 2>(v, desc); break;
        default: exchange_bit<NK, W, R, 3>(v, desc); break;
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int a = pad(b0 | (e << lo));
#pragma unroll
      for (int w = 0; w < W; ++w) s[w * P + a] = v[w][e];
    }
    __syncthreads();
    i += r;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    int4* out4 = reinterpret_cast<int4*>((w < NK ? keys_out : x) +
                                         w * ostride + roff);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int q = t + u * T;
      const int* d = s + w * P + pad(4 * q);
      out4[q] = make_int4(d[0], d[1], d[2], d[3]);
    }
  }
}

// Cross sub-stages j, j - 1, .., j - R + 1 of stage k in registers.
template <int NK, int W, int R>
__global__ void __launch_bounds__(MERGED_THREADS)
sort_merged_kernel(int* __restrict__ x, long long ostride, long long M,
                   int k, int j) {
  constexpr int E = 1 << R;
  const long long t = (long long)blockIdx.x * MERGED_THREADS + threadIdx.x;
  if (t >= (M >> R)) return;
  const int jl = j - R + 1;  // the group's lowest bit
  const long long base = (t & ((1LL << jl) - 1)) | ((t >> jl) << (j + 1));
  const bool asc = ((base >> (k + 1)) & 1) == 0;
  int* row = x + (long long)blockIdx.y * M + base;
  int v[W][E];
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int w = 0; w < W; ++w)
      v[w][e] = row[w * ostride + ((long long)e << jl)];
#pragma unroll
  for (int b = R - 1; b >= 0; --b) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e & (1 << b)) continue;
      const int f = e | (1 << b);
      const bool swap =
          asc ? lex_lt<NK>(v[0][f], v[NK - 1][f], v[0][e], v[NK - 1][e])
              : lex_lt<NK>(v[0][e], v[NK - 1][e], v[0][f], v[NK - 1][f]);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int a = v[w][e], c = v[w][f];
        v[w][e] = swap ? c : a;
        v[w][f] = swap ? a : c;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
#pragma unroll
    for (int w = 0; w < W; ++w)
      row[w * ostride + ((long long)e << jl)] = v[w][e];
}

// out[i][b][m] = op_i[b][col[b][m]] for payload i = nk + blockIdx.z.
__global__ void __launch_bounds__(GATHER_THREADS)
sort_gather_kernel(const long long* __restrict__ src,
                   const int* __restrict__ col, int* __restrict__ out,
                   int nk, long long ostride, long long M) {
  const int i = nk + blockIdx.z;
  const long long m =
      ((long long)blockIdx.x * GATHER_THREADS + threadIdx.x) *
      GATHER_PER_THREAD;
  if (m >= M) return;
  const long long roff = (long long)blockIdx.y * M;
  const int* op = reinterpret_cast<const int*>(src[i]) + roff;
  const int4 c = *reinterpret_cast<const int4*>(col + roff + m);
  int4 r;
  r.x = __ldg(op + c.x);
  r.y = __ldg(op + c.y);
  r.z = __ldg(op + c.z);
  r.w = __ldg(op + c.w);
  *reinterpret_cast<int4*>(out + i * ostride + roff + m) = r;
}

template <int NK, int W, int R>
void launch_merged(int* x, long long ostride, int B, int M, int k, int j,
                   cudaStream_t stream) {
  const long long threads = (long long)M >> R;
  const dim3 grid(
      (unsigned)((threads + MERGED_THREADS - 1) / MERGED_THREADS), B);
  sort_merged_kernel<NK, W, R><<<grid, MERGED_THREADS, 0, stream>>>(
      x, ostride, M, k, j);
}

template <int NK, int W>
cudaError_t run_plan(const long long* table, int n, int B, int M, int Lc,
                     const int* phases, int n_phases, const int* stages,
                     int* x, int* out, cudaStream_t stream) {
  const int C = 1 << Lc;
  const size_t smem = (size_t)W * (C + (C >> 5)) * sizeof(int);
  // the opt-in shared memory, set once per device for this instance
  static size_t smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || smem_set[dev] < smem) {
    err = cudaFuncSetAttribute(sort_local_kernel<NK, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_set[dev] = smem;
  }
  const bool index = W < n;
  const long long ostride = (long long)B * M;
  const int local_threads = C >> RL;
  const dim3 local_grid(M / C, B);
  for (int p = 0; p < n_phases; ++p) {
    const int typ = phases[4 * p], a = phases[4 * p + 1],
              b = phases[4 * p + 2], count = phases[4 * p + 3];
    if (typ == PHASE_LOCAL) {
      sort_local_kernel<NK, W>
          <<<local_grid, local_threads, smem, stream>>>(
          p == 0 ? table : nullptr, index && p == 0, x,
          p == n_phases - 1 ? out : x, ostride, M, Lc, stages, a, b);
    } else {
      switch (count) {
        case 1: launch_merged<NK, W, 1>(x, ostride, B, M, a, b, stream); break;
        case 2: launch_merged<NK, W, 2>(x, ostride, B, M, a, b, stream); break;
        case 3: launch_merged<NK, W, 3>(x, ostride, B, M, a, b, stream); break;
        case 4: launch_merged<NK, W, 4>(x, ostride, B, M, a, b, stream); break;
      }
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (index) {
    const dim3 grid(
        (unsigned)(M / (GATHER_THREADS * GATHER_PER_THREAD)), B, n - NK);
    sort_gather_kernel<<<grid, GATHER_THREADS, 0, stream>>>(
        table, x + NK * ostride, out, NK, ostride, M);
    err = cudaGetLastError();
  }
  return err;
}

cudaError_t sort_entry(const long long* ptrs, long long* table, int n, int B,
                       int M, int num_keys, int W, int Lc,
                       const int* phases, int n_phases, const int* stages,
                       int* x, int* out, cudaStream_t stream) {
  const int want_w = n > num_keys + 1 ? num_keys + 1 : n;
  // C >> RL threads a local block, at most 1024
  if (n < 1 || B < 1 || B > 65535 || M < 1024 || (M & (M - 1)) ||
      Lc < 10 || Lc - RL > 10 || (1 << Lc) > M ||
      (num_keys != 1 && num_keys != 2) || num_keys > n || W != want_w ||
      n - num_keys > 65535 || n_phases < 1 ||
      phases[0] != PHASE_LOCAL || phases[4 * (n_phases - 1)] != PHASE_LOCAL)
    return cudaErrorInvalidValue;
  for (int p = 0; p < n_phases; ++p) {
    const int typ = phases[4 * p], count = phases[4 * p + 3];
    if (typ != PHASE_LOCAL &&
        (typ != PHASE_MERGED || count < 1 || count > MAX_R ||
         phases[4 * p + 2] - count + 1 < Lc))
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaMemcpyAsync(table, ptrs, n * sizeof(long long),
                                    cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return err;
  if (num_keys == 1 && W == 1)
    return run_plan<1, 1>(table, n, B, M, Lc, phases, n_phases, stages, x,
                          out, stream);
  if (num_keys == 1 && W == 2)
    return run_plan<1, 2>(table, n, B, M, Lc, phases, n_phases, stages, x,
                          out, stream);
  if (num_keys == 2 && W == 2)
    return run_plan<2, 2>(table, n, B, M, Lc, phases, n_phases, stages, x,
                          out, stream);
  return run_plan<2, 3>(table, n, B, M, Lc, phases, n_phases, stages, x,
                        out, stream);
}

}  // namespace

// K8: one long row (B == 1 past the JAX op's VMEM budget), hierarchical.
// ptrs: the n operand pointers (host); table: n words of device memory
// for them; x: the (W, B, M) working buffer (out itself in direct mode);
// out: the (n, B, M) output.
extern "C" cudaError_t ffv2_sort(const long long* ptrs, long long* table,
                                 int n, int B, int M, int num_keys, int W,
                                 int Lc, const int* phases, int n_phases,
                                 const int* stages, int* x, int* out,
                                 cudaStream_t stream) {
  return sort_entry(ptrs, table, n, B, M, num_keys, W, Lc, phases, n_phases,
                    stages, x, out, stream);
}

// K9: batched rows (or a short row); one block a row when Lc == L.
extern "C" cudaError_t ffv2_rowsort(const long long* ptrs, long long* table,
                                    int n, int B, int M, int num_keys, int W,
                                    int Lc, const int* phases,
                                    int n_phases, const int* stages, int* x,
                                    int* out, cudaStream_t stream) {
  return sort_entry(ptrs, table, n, B, M, num_keys, W, Lc, phases, n_phases,
                    stages, x, out, stream);
}
