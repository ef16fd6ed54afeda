"""Data-movement kernels (PyTorch/CUDA port of ffmpeg_ffv2_tpu.ops)."""
