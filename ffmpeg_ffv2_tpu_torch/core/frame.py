"""Copy of ``ffmpeg_ffv2_tpu/core/frame.py``, with ``to_device`` on torch.

VideoFrame — the framework's frame carrier (the AVFrame counterpart).

A frame is a list of per-plane arrays (numpy on host, torch tensors on
the device) plus its pixel format and display metadata.  Unlike AVFrame's
refcounted raw buffers (libavutil/frame.h:295), arrays own their storage
and device placement is explicit — `to_device()` / `to_host()` move the payload.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction

import numpy as np

from .pixfmt import PixelFormat, get_pix_fmt


def _host(p) -> np.ndarray:
    """A plane as a numpy array: a tensor (on any device) copied down."""
    return p.cpu().numpy() if hasattr(p, "cpu") else np.asarray(p)


@dataclass
class VideoFrame:
    planes: list                      # [h, w] arrays in coding order
    pix_fmt: PixelFormat
    width: int
    height: int
    pts: int | None = None
    keyframe: bool = True
    sample_aspect_ratio: Fraction = Fraction(0, 1)
    interlaced: bool = False
    top_field_first: bool = False
    metadata: dict = field(default_factory=dict)

    @classmethod
    def alloc(cls, pix_fmt: str | PixelFormat, width: int, height: int):
        fmt = get_pix_fmt(pix_fmt) if isinstance(pix_fmt, str) else pix_fmt
        planes = []
        if fmt.colorspace == 0:
            planes.append(np.zeros((height, width), np.int32))
            if fmt.chroma_planes:
                cw = -(-width >> fmt.chroma_h_shift)
                ch = -(-height >> fmt.chroma_v_shift)
                planes += [np.zeros((ch, cw), np.int32) for _ in range(2)]
            if fmt.transparency:
                planes.append(np.zeros((height, width), np.int32))
        else:
            n = 3 + fmt.transparency
            planes = [np.zeros((height, width), np.int32) for _ in range(n)]
        return cls(planes, fmt, width, height)

    def to_device(self, device="cuda"):
        import torch
        self.planes = [torch.as_tensor(p, device=device)
                       for p in self.planes]
        return self

    def to_host(self):
        self.planes = [_host(p) for p in self.planes]
        return self

    def to_bytes(self) -> bytes:
        dt = np.uint8 if self.pix_fmt.bits <= 8 else np.dtype("<u2")
        return b"".join(_host(p).astype(dt).tobytes()
                        for p in self.planes)

    @classmethod
    def from_bytes(cls, data: bytes, pix_fmt: str | PixelFormat,
                   width: int, height: int):
        f = cls.alloc(pix_fmt, width, height)
        dt = np.dtype(np.uint8 if f.pix_fmt.bits <= 8 else "<u2")
        off = 0
        for i, p in enumerate(f.planes):
            n = p.size
            f.planes[i] = np.frombuffer(data, dt, n, off) \
                .reshape(p.shape).astype(np.int32)
            off += n * dt.itemsize
        return f
