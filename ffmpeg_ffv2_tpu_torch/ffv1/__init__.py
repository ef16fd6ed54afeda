"""FFV1 device encoder (PyTorch/CUDA port of ffmpeg_ffv2_tpu.ffv1)."""
