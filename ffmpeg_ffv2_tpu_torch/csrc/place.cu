// K1 place: scatter the two cell channels into the tile-major cell layout.
//
// Replaces ffmpeg_ffv2_tpu/ops/place_pallas.py:_place_kernel
// (place_sorted_pallas), which places destination-SORTED elements chunk by
// chunk with a monotone log-shift because TPU lanes cannot store to
// data-dependent addresses, and carries an SMEM element pointer from one
// grid step to the next.
//
// Bound: device memory.  N ~ 3.1 M elements at 1080p read 12 bytes each
// and write 8 bytes to scattered cells; there is no arithmetic to speak of.
// Design: one thread per element stores straight to its destination.  The
// destinations of real elements are unique (layout_plan), so the stores
// never race and no order between blocks is needed, and the destination
// sort that fed the TPU kernel is gone.  The wrapper fills the outputs
// first (ch1 with 0, ch2 with INT32_MAX); sentinel and out-of-range
// destinations are dropped, as jax's scatter mode="drop" drops them.

#include "common.cuh"

__global__ void place_cells_kernel(const int* __restrict__ dest,
                                   const int* __restrict__ ch1,
                                   const int* __restrict__ orig, long long n,
                                   long long cells, int* __restrict__ ch1c,
                                   int* __restrict__ ch2c) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int d = dest[k];
  if (d < 0 || d >= cells) return;  // INT32_MAX sentinels land here too
  ch1c[d] = ch1[k];
  ch2c[d] = orig[k];
}

extern "C" cudaError_t ffv2_place_cells(const int* dest, const int* ch1,
                                        const int* orig, long long n,
                                        long long cells, int* ch1c,
                                        int* ch2c, cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    place_cells_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        dest, ch1, orig, n, cells, ch1c, ch2c);
  }
  return cudaGetLastError();
}
