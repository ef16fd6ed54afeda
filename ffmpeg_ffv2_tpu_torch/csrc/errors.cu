// CUDA error strings and the launch count of the multi-kernel launchers,
// for the Python wrappers (ffmpeg_ffv2_tpu_torch/_build.py).
#include "common.cuh"

long long ffv2_kernels_launched = 0;

extern "C" const char* ffv2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" long long ffv2_kernel_launches() { return ffv2_kernels_launched; }
