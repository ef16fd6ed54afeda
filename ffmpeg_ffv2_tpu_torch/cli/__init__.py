"""Copy of ``ffmpeg_ffv2_tpu/cli``: ``python -m ffmpeg_ffv2_tpu_torch.cli``."""
