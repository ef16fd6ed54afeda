"""The frame pool of the 10-bit 4:2:2 cells: FATE's vsynth1 source as an
SDI capture hands it over.

The RGB24 frames are ``videogen.rgb_frames``'s (FFmpeg's
``tests/videogen.c``) at the configuration's size, from frame ``seed %
videogen.STARTS`` on.  They are converted with ``tests/utils.c``'s BT.601
integer coefficients (``rgb24_to_yuv420p``) carried to 10 bits: each sum
is shifted 2 bits less, so the two low bits carry the products'
fractions and are not zero.  Chroma is averaged over each horizontal pair
of pixels only (4:2:2: full height, half width; an odd width repeats its
last column).  The planes are uint16 with the sample in the low 10 bits,
as an SDI card's v210 unpacked.
"""

from __future__ import annotations

import numpy as np

from . import videogen
from .videogen import _fix      # tests/utils.c's FIX, at SCALE bits

BITS = 10
SCALE = 8                   # tests/utils.c's SCALEBITS


def rgb24_to_yuv422p10(rgb: np.ndarray) -> list:
    """tests/utils.c:rgb24_to_yuv420p's arithmetic at 10 bits, with
    chroma over horizontal pairs: [Y, U, V] uint16."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    s = SCALE - (BITS - 8)
    lum = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
           + (1 << (s - 1))) >> s
    if rgb.shape[1] % 2:
        r, g, b = (np.concatenate([c, c[:, -1:]], axis=1) for c in (r, g, b))
    # a pair's sum carries one bit more than a pixel
    r1, g1, b1 = (c[:, 0::2] + c[:, 1::2] for c in (r, g, b))
    s += 1
    mid = 1 << (BITS - 1)
    cb = ((-_fix(0.16874) * r1 - _fix(0.33126) * g1 + _fix(0.50000) * b1
           + (1 << (s - 1)) - 1) >> s) + mid
    cr = ((_fix(0.50000) * r1 - _fix(0.41869) * g1 - _fix(0.08131) * b1
           + (1 << (s - 1)) - 1) >> s) + mid
    return [c.astype(np.uint16) for c in (lum, cb, cr)]


def pool(seed: int, n: int, config: dict) -> list:
    """``n`` consecutive yuv422p10 frames [Y, U, V] of the clip at the
    configuration's size, from the frame that ``seed`` picks."""
    start = seed % videogen.STARTS
    return [rgb24_to_yuv422p10(f) for f in
            videogen.rgb_frames(config["width"], config["height"], start, n)]
