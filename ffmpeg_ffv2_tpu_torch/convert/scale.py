"""Copy of ``ffmpeg_ffv2_tpu/convert/scale.py``.

Pixel format conversions matching swscale's neighbor+bitexact output.

Covers the conversions the FATE matrix routes through swscale before/after
FFV1 coding (tests/fate/vcodec.mak:173-186).  Verified byte-identical to
``-sws_flags neighbor+bitexact +accurate_rnd``:

* depth expansion 8->N is a plain left shift,
* chroma upsampling under "neighbor" replicates the top-left sample of
  each 2x2/2x1 block.

The YUV<->RGB conversions (bgr0/rgb48 variants) live in
``convert/yuv_rgb.py``: the table-driven yuv2rgb path, the rgb->yuv
matrices with the ordered 8x8 dither, and the planar-RGB neighbor-pick
chroma path — byte-exact vs the reference scaler and used end-to-end by
the RGB FATE tests (tests/test_fate_ffv1.py, tests/test_convert_parity.py).
"""

from __future__ import annotations

import numpy as np


def yuv420p_to_yuv422p10_neighbor(y, u, v):
    """[y, u, v] 8-bit -> 10-bit 4:2:2 (vertical chroma 2x nearest)."""
    y10 = np.asarray(y).astype(np.int64) << 2
    u10 = np.repeat(np.asarray(u).astype(np.int64) << 2, 2, axis=0)
    v10 = np.repeat(np.asarray(v).astype(np.int64) << 2, 2, axis=0)
    h = np.asarray(y).shape[0]
    return [y10, u10[:h], v10[:h]]


def yuv420p_to_yuv444p16_neighbor(y, u, v):
    """[y, u, v] 8-bit 4:2:0 -> 16-bit 4:4:4 (2x2 nearest chroma)."""
    y16 = np.asarray(y).astype(np.int64) << 8
    h, w = np.asarray(y).shape

    def up(c):
        c = np.repeat(np.repeat(np.asarray(c).astype(np.int64) << 8, 2,
                                axis=0), 2, axis=1)
        return c[:h, :w]

    return [y16, up(u), up(v)]


def yuv422p10_to_yuv420p_neighbor(y, u, v):
    """Inverse direction (FATE decode side): >>2 + even chroma rows."""
    return [np.asarray(y).astype(np.int64) >> 2,
            np.asarray(u).astype(np.int64)[0::2] >> 2,
            np.asarray(v).astype(np.int64)[0::2] >> 2]


def yuv444p16_to_yuv420p_neighbor(y, u, v):
    return [np.asarray(y).astype(np.int64) >> 8,
            np.asarray(u).astype(np.int64)[0::2, 0::2] >> 8,
            np.asarray(v).astype(np.int64)[0::2, 0::2] >> 8]
