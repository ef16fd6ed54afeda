"""ffmpeg_ffv2_tpu_torch -- the FFV1 device encoder on PyTorch and CUDA.

A port of the JAX/TPU package ``ffmpeg_ffv2_tpu`` to PyTorch on NVIDIA
Hopper GPUs.  It imports the jax-free host side of ``ffmpeg_ffv2_tpu``
(params, headers, the native runtime, CRC) and never jax.

``ffv1.device_coder.DeviceFFV1Encoder`` encodes frames with the range
coder through four hand-written CUDA kernels (``csrc/*.cu``, built on
first use by ``_build``): K1 place, K2 adapt, K3 expand and K4 rac_render.
"""
