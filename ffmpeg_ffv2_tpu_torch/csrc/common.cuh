// Shared definitions of the port's CUDA kernels.
#pragma once

#include <cuda_runtime.h>

// The kernel launches of the launchers that make more than one a call
// (ffv2_ladder, ffv2_pvq), each counted where it is made; read through
// ffv2_kernel_launches (errors.cu).
extern long long ffv2_kernels_launched;
inline void count_launch() { ++ffv2_kernels_launched; }

// rac op word layout [mode:2 | bit:1 | sv:8] at bits [10:9], [8], [7:0]
// (ffmpeg_ffv2_tpu/ffv1/expand_pallas.py module docstring).
constexpr int MODE_NOP = 0;
constexpr int MODE_OP = 1;
constexpr int MODE_FLUSH1 = 2;
constexpr int MODE_FLUSH2 = 3;

// floor(log2(a)) for a >= 1, -1 for 0 (device_coder.exponent).
__device__ __forceinline__ int exponent_of(int a) {
  return a ? 31 - __clz(a) : -1;
}
