"""Copy of ``ffmpeg_ffv2_tpu/convert/yuv_rgb.py``, with its four tables.

YUV <-> RGB conversions, byte-exact with swscale under
``-sws_flags neighbor+bitexact +accurate_rnd`` (ITU-R BT.601 limited range,
neutral brightness/contrast/saturation — the FATE configuration).

Models were recovered against the reference scaler and verified exhaustively
(see tests):

* yuv420p -> bgr0: swscale's table-driven yuv2rgb — per-channel lookup
  tables with additive chroma index offsets (B[u,y], R[v,y],
  G = ext[D + du[u] + dv[v] + y]); output X byte = 255.
* yuv420p -> rgb48le: the high-depth packed writer (output.c:
  yuv2rgba64_1_c_template): R|G|B = clip_uintp2(coeff-sum, 30) >> 14 with
  int32 wraparound semantics.
* bgr0 -> yuv420p: input.c rgb16_32ToY/UV_half — linear matrices; chroma
  from the *odd* source row of each pair with horizontally *summed* pixel
  pairs (double-width coefficients, shift+1).
* rgb48le -> yuv420p: input.c rgb48ToY/UV_half + an ordered 8x8 dither on
  the 16->8 depth reduction; chroma from odd rows with (a+b+1)>>1 averaged
  pairs.

Constant tables live in the .npz files next to this module.
"""

from __future__ import annotations

import os

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_cache = {}


def _load(name):
    if name not in _cache:
        _cache[name] = np.load(os.path.join(_DIR, name))
    return _cache[name]


def yuv420p_to_bgr0(y, u, v) -> np.ndarray:
    """-> uint8 [h, w, 4] B,G,R,255."""
    z = _load("yuv2rgb_bgr0.npz")
    ext, du, dv, D = z["ext"], z["du"], z["dv"], int(z["D"])
    rtab, btab = z["rtab"], z["btab"]
    y = np.asarray(y).astype(np.int64)
    uu = np.repeat(np.repeat(np.asarray(u).astype(np.int64), 2, 0), 2, 1)
    vv = np.repeat(np.repeat(np.asarray(v).astype(np.int64), 2, 0), 2, 1)
    h, w = y.shape
    uu, vv = uu[:h, :w], vv[:h, :w]
    B = btab[uu, y]
    R = rtab[vv, y]
    G = ext[D + du[uu] + dv[vv] + y]
    return np.stack([B, G, R, np.full_like(B, 255)], -1).astype(np.uint8)


def _w32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


# yuv2rgb coefficients (ITU601 limited, yuv2rgb.c:800-845 derivation)
def _r16(x):
    return (x + (1 << 15)) >> 16


_YC = _r16((65536 * 255 // 219) << 13)
_YO = _r16((16 << 16) << 9)
_V2R = _r16(104597 << 13)
_U2B = _r16(132201 << 13)
_U2G = _r16(-25675 << 13)
_V2G = _r16(-53279 << 13)


def yuv420p_to_rgb48(y, u, v) -> np.ndarray:
    """-> uint16 [h, w, 3] R,G,B (little-endian on disk)."""
    y = np.asarray(y).astype(np.int64)
    uu = np.repeat(np.repeat(np.asarray(u).astype(np.int64), 2, 0), 2, 1)
    vv = np.repeat(np.repeat(np.asarray(v).astype(np.int64), 2, 0), 2, 1)
    h, w = y.shape
    uu, vv = uu[:h, :w], vv[:h, :w]
    Y1 = _w32(((y << 9) - _YO) * _YC + (1 << 13))
    U = (uu - 128) << 9
    V = (vv - 128) << 9
    clip = lambda x: np.clip(_w32(x), 0, (1 << 30) - 1) >> 14
    return np.stack([clip(V * _V2R + Y1), clip(V * _V2G + U * _U2G + Y1),
                     clip(U * _U2B + Y1)], -1).astype(np.uint16)


def bgr0_to_yuv420p(img: np.ndarray):
    """img uint8 [h, w, 4] B,G,R,X -> [y, u, v] planes."""
    z = _load("rgb2yuv_bgr0.npz")
    (Ay, By, Cy, Ey) = z["y"]
    (Au, Bu, Cu, Eu) = z["u"]
    (Av, Bv, Cv, Ev) = z["v"]
    SH = int(z["shift"])
    r = img[..., 2].astype(np.int64)
    g = img[..., 1].astype(np.int64)
    b = img[..., 0].astype(np.int64)
    y8 = (Ay * r + By * g + Cy * b + Ey) >> SH
    ro, go, bo = r[1::2], g[1::2], b[1::2]
    rs = ro[:, 0::2] + ro[:, 1::2]
    gs = go[:, 0::2] + go[:, 1::2]
    bs = bo[:, 0::2] + bo[:, 1::2]
    u8 = (Au * rs + Bu * gs + Cu * bs + Eu) >> (SH + 1)
    v8 = (Av * rs + Bv * gs + Cv * bs + Ev) >> (SH + 1)
    return [y8.astype(np.uint8), u8.astype(np.uint8), v8.astype(np.uint8)]


def rgb48_to_yuv420p(img: np.ndarray):
    """img uint16 [h, w, 3] R,G,B -> [y, u, v] planes."""
    z = _load("rgb2yuv_rgb48.npz")
    (SHy, Ay, By, Cy) = z["y"]
    (SHu, Au, Bu, Cu) = z["u"]
    (SHv, Av, Bv, Cv) = z["v"]
    yE, uE, vE = z["yE"], z["uE"], z["vE"]
    r = img[..., 0].astype(np.int64)
    g = img[..., 1].astype(np.int64)
    b = img[..., 2].astype(np.int64)
    h, w = r.shape
    y8 = (Ay * r + By * g + Cy * b
          + yE[np.arange(h) % 8][:, np.arange(w) % 8]) >> SHy
    ro, go, bo = r[1::2], g[1::2], b[1::2]
    rh = (ro[:, 0::2] + ro[:, 1::2] + 1) >> 1
    gh = (go[:, 0::2] + go[:, 1::2] + 1) >> 1
    bh = (bo[:, 0::2] + bo[:, 1::2] + 1) >> 1
    hc, wc = rh.shape
    iy, ix = np.arange(hc) % 8, np.arange(wc) % 8
    u8 = (Au * rh + Bu * gh + Cu * bh + uE[iy][:, ix]) >> SHu
    v8 = (Av * rh + Bv * gh + Cv * bh + vE[iy][:, ix]) >> SHv
    return [y8.astype(np.uint8), u8.astype(np.uint8), v8.astype(np.uint8)]


def gbrp16_to_yuv420p(g, b, r):
    """Planar 16-bit RGB (the FFV1 decoder's output format for rgb48
    content) -> yuv420p.  Planar RGB input computes chroma at full
    resolution (input.c:planar_rgb16_to_uv) and the neighbor scaler then
    *picks* the (odd row, odd col) sample of each 2x2 — no averaging —
    with an ordered 8x8 dither on the 16->8 reduction."""
    z = _load("rgb2yuv_gbrp16.npz")
    (SHy, Ay, By, Cy) = z["y"]
    (SHu, Au, Bu, Cu) = z["u"]
    (SHv, Av, Bv, Cv) = z["v"]
    yE, uE, vE = z["yE"], z["uE"], z["vE"]
    r = np.asarray(r).astype(np.int64)
    g = np.asarray(g).astype(np.int64)
    b = np.asarray(b).astype(np.int64)
    h, w = r.shape
    y8 = (Ay * r + By * g + Cy * b
          + yE[np.arange(h) % 8][:, np.arange(w) % 8]) >> SHy
    rs, gs, bs = r[1::2, 1::2], g[1::2, 1::2], b[1::2, 1::2]
    hc, wc = rs.shape
    iy, ix = np.arange(hc) % 8, np.arange(wc) % 8
    u8 = (Au * rs + Bu * gs + Cu * bs + uE[iy][:, ix]) >> SHu
    v8 = (Av * rs + Bv * gs + Cv * bs + vE[iy][:, ix]) >> SHv
    return [y8.astype(np.uint8), u8.astype(np.uint8), v8.astype(np.uint8)]
