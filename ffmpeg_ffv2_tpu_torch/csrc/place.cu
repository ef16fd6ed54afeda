// K1 place: lay the two cell channels out in the tile-major cell layout.
//
// Replaces ffmpeg_ffv2_tpu/ops/place_pallas.py:_place_kernel
// (place_sorted_pallas), which places destination-SORTED elements chunk by
// chunk with a monotone log-shift because TPU lanes cannot store to
// data-dependent addresses, and carries an SMEM element pointer from one
// grid step to the next.
//
// Bound: device memory.  At 1080p ~3.1 M elements are read (8 bytes each)
// and both (cellrows, 128) int32 channels are written once (~42 MB).
// Design: output-centric, two kernels on one stream, no fill pass.  A
// slot (tile T, lane l) holds one run of consecutive elements in element
// order (one sub-block of one group), at cells (cell_bases[T] + j) * 128
// + l for j < its length <= cell_caps[T] (layout_plan, unclamped: the
// geometry dest was computed from).
//  1. place_slots_kernel, one thread a slot: the slot's first element is
//     group_first[g] + tile_rank0[T] for g = lane_rows[slot]; the slot is
//     real iff dest of that element is the slot's first cell (dest values
//     are unique, so this one read tells an empty slot, whose lane_rows
//     is 0, from group 0).  It writes the slot's (first element, length)
//     and, for the tile's rows, the row's tile.
//  2. place_rows_kernel, one block of 128 threads (one a lane) a band of
//     ROWS rows: each thread walks its lane down the band, reading its
//     run's next elements sequentially (its lines stay in L1), and each
//     warp stores 128 contiguous bytes a row and channel: the element, or
//     the fill (0 in ch1c, INT32_MAX in ch2c) past the run, in a tile's
//     unused rows and past the last tile.  Cells at or past cellrows * 128
//     are dropped, as scatter_cells drops them.

#include <climits>

#include "common.cuh"

namespace {

constexpr int LANES = 128;
constexpr int ROWS = 32;    // rows a block of the row pass
constexpr int BATCH = 8;    // rows whose loads a thread keeps in flight

__global__ void __launch_bounds__(LANES)
place_slots_kernel(const int* __restrict__ dest, int n,
                   const int* __restrict__ lane_rows,
                   const int* __restrict__ group_first,
                   const int* __restrict__ group_size, int G,
                   const int* __restrict__ tile_rank0,
                   const int* __restrict__ bases,
                   const int* __restrict__ caps, int cellrows,
                   int2* __restrict__ runs, int* __restrict__ row_tile) {
  const int T = blockIdx.x, l = threadIdx.x, slot = T * LANES + l;
  const int cap = caps[T], base = bases[T];
  int2 run = make_int2(0, 0);
  const int g = lane_rows[slot];
  if (cap > 0 && g >= 0 && g < G) {
    const int len = group_size[g] - tile_rank0[T];
    const int first = group_first[g] + tile_rank0[T];
    if (len > 0 && first < n && dest[first] == base * LANES + l)
      run = make_int2(first, min(len, cap));
  }
  runs[slot] = run;
  for (int r = l; r < cap && base + r < cellrows; r += LANES)
    row_tile[base + r] = T;
}

__global__ void __launch_bounds__(LANES)
place_rows_kernel(const int* __restrict__ ch1, const int* __restrict__ orig,
                  const int* __restrict__ bases,
                  const int* __restrict__ caps, int tiles,
                  const int2* __restrict__ runs,
                  const int* __restrict__ row_tile, int cellrows,
                  int* __restrict__ ch1c, int* __restrict__ ch2c) {
  const int l = threadIdx.x;
  // rows the tiles cover; past them every cell is fill
  const long long used =
      tiles > 0 ? (long long)bases[tiles - 1] + caps[tiles - 1] : 0;
  const int r0 = blockIdx.x * ROWS;
  for (int b = 0; b < ROWS; b += BATCH) {
    int src[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int row = r0 + b + k;
      src[k] = -1;
      if (row < cellrows && row < used) {
        const int T = row_tile[row];
        const int2 run = runs[T * LANES + l];
        const int j = row - bases[T];
        if (j < run.y) src[k] = run.x + j;
      }
    }
    int v1[BATCH], v2[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      v1[k] = src[k] >= 0 ? ch1[src[k]] : 0;
      v2[k] = src[k] >= 0 ? orig[src[k]] : INT_MAX;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int row = r0 + b + k;
      if (row < cellrows) {
        ch1c[(size_t)row * LANES + l] = v1[k];
        ch2c[(size_t)row * LANES + l] = v2[k];
      }
    }
  }
}

}  // namespace

extern "C" cudaError_t ffv2_place_cells(
    const int* dest, const int* ch1, const int* orig, int n,
    const int* lane_rows, const int* group_first, const int* group_size,
    int G, const int* tile_rank0, const int* bases, const int* caps,
    int tiles, int cellrows, int* runs, int* row_tile, int* ch1c, int* ch2c,
    cudaStream_t stream) {
  if (cellrows <= 0) return cudaGetLastError();
  int2* runs2 = reinterpret_cast<int2*>(runs);
  if (tiles > 0)
    place_slots_kernel<<<tiles, LANES, 0, stream>>>(
        dest, n, lane_rows, group_first, group_size, G, tile_rank0, bases,
        caps, cellrows, runs2, row_tile);
  place_rows_kernel<<<(cellrows + ROWS - 1) / ROWS, LANES, 0, stream>>>(
      ch1, orig, bases, caps, tiles, runs2, row_tile, cellrows, ch1c, ch2c);
  return cudaGetLastError();
}
