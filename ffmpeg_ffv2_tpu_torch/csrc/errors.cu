// CUDA error strings for the Python wrappers (ffmpeg_ffv2_tpu_torch/_build.py).
#include <cuda_runtime.h>

extern "C" const char* ffv2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
