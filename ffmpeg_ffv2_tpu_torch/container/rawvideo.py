"""Copy of ``ffmpeg_ffv2_tpu/container/rawvideo.py``.

Raw video "container": fixed-size frames of a known pixel format.

The rawvideo (de)muxer counterpart — frame boundaries are implied by the
format geometry, as in the reference's rawvideo demuxer.
"""

from __future__ import annotations

import numpy as np

from ..core.frame import VideoFrame
from ..core.pixfmt import get_pix_fmt


class RawVideoReader:
    def __init__(self, path: str, pix_fmt: str, width: int, height: int):
        self.pix_fmt = get_pix_fmt(pix_fmt)
        self.width = width
        self.height = height
        probe = VideoFrame.alloc(self.pix_fmt, width, height)
        itemsize = 1 if self.pix_fmt.bits <= 8 else 2
        self.frame_size = sum(p.size for p in probe.planes) * itemsize
        self._fh = open(path, "rb")

    def __iter__(self):
        return self

    def __next__(self) -> VideoFrame:
        data = self._fh.read(self.frame_size)
        if len(data) < self.frame_size:
            self._fh.close()
            raise StopIteration
        return VideoFrame.from_bytes(data, self.pix_fmt, self.width,
                                     self.height)

    def close(self):
        self._fh.close()


class RawVideoWriter:
    def __init__(self, path: str):
        self._fh = open(path, "wb")

    def write(self, frame: VideoFrame):
        self._fh.write(frame.to_bytes())

    def close(self):
        self._fh.close()
