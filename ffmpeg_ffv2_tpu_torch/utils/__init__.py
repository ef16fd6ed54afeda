"""Copy of ``ffmpeg_ffv2_tpu/utils/__init__.py``."""

from .psnr import tiny_psnr_line, psnr_u8
