"""Copy of ``ffmpeg_ffv2_tpu/container/__init__.py``."""

from .avi import AviReader, AviWriter
from .matroska import MatroskaReader, MatroskaWriter
from .rawvideo import RawVideoReader, RawVideoWriter
