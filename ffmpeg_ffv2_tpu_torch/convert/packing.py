"""Copy of ``ffmpeg_ffv2_tpu/convert/packing.py``.

Packed RGB <-> coding-order planar conversion.

FFV1 codes RGB as planar g, b, r(, a) regardless of the source packing
(ffv1enc_template.c:encode_rgb_frame reads bgr0/rgb32 as 32-bit words and
rgb48/rgba64 as LE 16-bit triples); these helpers are the packing boundary
between file IO and the codec API.
"""

from __future__ import annotations

import numpy as np


def unpack_bgr0(data: bytes, w: int, h: int):
    """bgr0 (a.k.a. 0RGB32 little-endian: B,G,R,X bytes) -> [g, b, r]."""
    arr = np.frombuffer(data, np.uint8).reshape(h, w, 4)
    return [arr[..., 1].astype(np.int64), arr[..., 0].astype(np.int64),
            arr[..., 2].astype(np.int64)]


def pack_bgr0(planes, fill: int = 0) -> bytes:
    """[g, b, r] -> B,G,R,X bytes; X mirrors the decoder's alpha slot
    (zeros when no alpha is coded, ffv1dec_template.c:178)."""
    g, b, r = planes[:3]
    h, w = np.asarray(g).shape
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = np.asarray(b) & 0xFF
    out[..., 1] = np.asarray(g) & 0xFF
    out[..., 2] = np.asarray(r) & 0xFF
    out[..., 3] = fill
    return out.tobytes()


def unpack_rgb32(data: bytes, w: int, h: int):
    """rgb32 (BGRA bytes on LE) -> [g, b, r, a]."""
    arr = np.frombuffer(data, np.uint8).reshape(h, w, 4)
    return [arr[..., 1].astype(np.int64), arr[..., 0].astype(np.int64),
            arr[..., 2].astype(np.int64), arr[..., 3].astype(np.int64)]


def pack_rgb32(planes) -> bytes:
    g, b, r, a = planes[:4]
    h, w = np.asarray(g).shape
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = np.asarray(b) & 0xFF
    out[..., 1] = np.asarray(g) & 0xFF
    out[..., 2] = np.asarray(r) & 0xFF
    out[..., 3] = np.asarray(a) & 0xFF
    return out.tobytes()


def unpack_rgb48(data: bytes, w: int, h: int):
    """rgb48le (R,G,B u16le) -> [g, b, r]."""
    arr = np.frombuffer(data, "<u2").reshape(h, w, 3)
    return [arr[..., 1].astype(np.int64), arr[..., 2].astype(np.int64),
            arr[..., 0].astype(np.int64)]


def pack_rgb48(planes) -> bytes:
    g, b, r = planes[:3]
    h, w = np.asarray(g).shape
    out = np.empty((h, w, 3), "<u2")
    out[..., 0] = np.asarray(r) & 0xFFFF
    out[..., 1] = np.asarray(g) & 0xFFFF
    out[..., 2] = np.asarray(b) & 0xFFFF
    return out.tobytes()
