"""Copy of ``ffmpeg_ffv2_tpu/testsrc/rotozoom.py``.

Rotozoom synthetic source (vsynth2) — port of tests/rotozoom.c.

Rotates/zooms a 256x256 P6 texture with fixed-point trig and bilinear
interpolation; output is 352x288x50 yuv420p via the shared exact RGB->YUV
conversion.  The texture read replicates the reference byte-for-byte: skip
15 header bytes, then read 256 rows x 768 bytes (regardless of actual PNM
header length).
"""

from __future__ import annotations

import numpy as np

from .videogen import rgb24_to_yuv420p

FIXP = 1 << 16
MY_PI = 205887


def _int_pow(a: int, p: int) -> int:
    v = FIXP
    for _ in range(p):
        v = v * a
        v = _c_div(v, FIXP)
    return v


def _c_div(a: int, b: int) -> int:
    """C-style truncating integer division."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _int_sin(a: int) -> int:
    if a < 0:
        a = MY_PI - a
    a %= 2 * MY_PI
    if a >= MY_PI * 3 // 2:
        a -= 2 * MY_PI
    if a >= MY_PI // 2:
        a = MY_PI - a
    return (a - _c_div(_int_pow(a, 3), 6) + _c_div(_int_pow(a, 5), 120)
            - _c_div(_int_pow(a, 7), 5040))


def _trig_tables():
    h_cos = np.zeros(360, dtype=np.int64)
    h_sin = np.zeros(360, dtype=np.int64)
    for i in range(360):
        radian = 2 * i * MY_PI // 360
        h = 2 * FIXP + _int_sin(radian)
        h_cos[i] = _c_div(_c_div(h * _int_sin(radian + MY_PI // 2), 2), FIXP)
        h_sin[i] = _c_div(_c_div(h * _int_sin(radian), 2), FIXP)
    return h_cos, h_sin


def load_texture(pnm_path: str):
    """tabs (r, g, b) as uint8[256,256]; replicates the 15-byte header skip."""
    data = open(pnm_path, "rb").read()
    body = data[15:15 + 3 * 256 * 256]
    arr = np.frombuffer(body, dtype=np.uint8)
    arr = arr.reshape(256, 256, 3)
    return arr[..., 0], arr[..., 1], arr[..., 2]


def _ipol(tab: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    ix = (x >> 16)
    iy = (y >> 16)
    fx = x & 0xFFFF
    fy = y & 0xFFFF
    t = tab.astype(np.int64)
    s00 = t[iy & 255, ix & 255]
    s01 = t[iy & 255, (ix + 1) & 255]
    s10 = t[(iy + 1) & 255, ix & 255]
    s11 = t[(iy + 1) & 255, (ix + 1) & 255]
    s0 = (((1 << 16) - fx) * s00 + fx * s01) >> 8
    s1 = (((1 << 16) - fx) * s10 + fx * s11) >> 8
    return ((((1 << 16) - fy) * s0 + fy * s1) >> 24).astype(np.uint8)


def rotozoom_rgb_frames(pnm_path: str, w: int = 352, h: int = 288,
                        n_frames: int = 50):
    tab_r, tab_g, tab_b = load_texture(pnm_path)
    h_cos, h_sin = _trig_tables()

    jj, ii = np.mgrid[0:h, 0:w]
    jj = jj.astype(np.int64)
    ii = ii.astype(np.int64)

    for num in range(n_frames):
        c = int(h_cos[num % 360])
        s = int(h_sin[num % 360])
        xi = -(w // 2) * c
        yi = (w // 2) * s
        xj = -(h // 2) * s
        yj = -(h // 2) * c
        # x(i,j) = xj + s*j + xi + FIXP*w/2 + c*(i+1)
        x = xj + s * jj + xi + FIXP * w // 2 + c * (ii + 1)
        y = yj + c * jj + yi + FIXP * h // 2 - s * (ii + 1)
        rgb = np.stack([_ipol(tab_r, x, y), _ipol(tab_g, x, y),
                        _ipol(tab_b, x, y)], axis=-1)
        yield rgb


def rotozoom_frames(pnm_path: str, n_frames: int = 50, w: int = 352,
                    h: int = 288):
    """vsynth2 (with tests/reference.pnm) as (y, cb, cr) planes."""
    for rgb in rotozoom_rgb_frames(pnm_path, w, h, n_frames):
        yield rgb24_to_yuv420p(rgb)
