"""Pixel-format conversions on the device: the counterpart of
``ffmpeg_ffv2_tpu/convert/tpu.py``.

The PyTorch versions of the byte-exact numpy models in ``yuv_rgb.py``
(this package's copy), on tensors on a CUDA device, or on the CPU where
the caller passes ``device="cpu"`` (``device="cuda"`` with no card
raises).  They compose with the encoder's phase A: ``fused_bgr0_phase_a``
converts a packed bgr0 frame to yuv420p and runs
``ffv1.phase_a.plane_context_diff`` on each plane without a trip to the
host, and the planes a conversion returns go into
``DeviceFFV1Encoder.encode`` or ``encode_batch`` as they are.  The JAX
package computes these in XLA with no Pallas body; here they are plain
PyTorch ops (gathers, shifts, strided slices), no kernel.

The arithmetic runs in int64, so the Python-int constants neither
overflow nor promote, and the int32 wraparound of swscale's rgb48 writer
(the numpy model's ``_w32``) is an explicit mask.  Inputs are numpy
arrays or tensors.  Outputs are tensors on ``device``: uint8 planes and
bgr0 frames, and rgb48 as int32 (h, w, 3) R, G, B in 0..65535 (torch's
uint16 has few ops; cast at the numpy boundary with
``.cpu().numpy().astype(np.uint16)``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ffv1.phase_a import _wrap16, plane_context_diff
from . import yuv_rgb as _host

I64 = torch.int64


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("convert: device='cuda' but torch sees no CUDA "
                           "device")
    return dev


def _i64(x, dev):
    """A numpy array or tensor -> int64 tensor on ``dev`` (copied up in its
    own type and widened there; numpy's uint16 is widened on the host,
    since torch's uint16 has few ops)."""
    if not torch.is_tensor(x):
        a = np.ascontiguousarray(x)
        x = torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint16
                            else a)
    return x.to(dev).to(I64)


@functools.lru_cache(maxsize=None)
def _table(name: str, key: str, device: str):
    return torch.as_tensor(np.asarray(_host._load(name)[key], np.int64),
                           device=device)


def _coeffs(name: str, key: str) -> tuple:
    return tuple(int(t) for t in _host._load(name)[key])


def _dither(name: str, key: str, h: int, w: int, dev):
    """The 8x8 ordered dither matrix tiled over (h, w)."""
    E = _table(name, key, str(dev))
    iy = torch.arange(h, device=dev) % 8
    ix = torch.arange(w, device=dev) % 8
    return E[iy[:, None], ix[None, :]]


def _upsample2(c, h: int, w: int):
    return c.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]


def _w32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _u8(*planes) -> tuple:
    return tuple(p.to(torch.uint8) for p in planes)


def yuv420p_to_bgr0(y, u, v, device="cuda"):
    """-> uint8 (h, w, 4) B, G, R, 255 (tpu.py:33)."""
    dev = _device(device)
    name = "yuv2rgb_bgr0.npz"
    ext, du, dv, rtab, btab = (_table(name, k, str(dev))
                               for k in ("ext", "du", "dv", "rtab", "btab"))
    D = int(_host._load(name)["D"])
    y = _i64(y, dev)
    h, w = y.shape
    uu = _upsample2(_i64(u, dev), h, w)
    vv = _upsample2(_i64(v, dev), h, w)
    B = btab[uu, y]
    R = rtab[vv, y]
    G = ext[D + du[uu] + dv[vv] + y]
    return torch.stack([B, G, R, torch.full_like(B, 255)],
                       -1).to(torch.uint8)


def yuv420p_to_rgb48(y, u, v, device="cuda"):
    """-> int32 (h, w, 3) R, G, B in 0..65535 (tpu.py:53): swscale's
    int32 sums, wrapped as int32 wraps."""
    dev = _device(device)
    y = _i64(y, dev)
    h, w = y.shape
    uu = _upsample2(_i64(u, dev), h, w)
    vv = _upsample2(_i64(v, dev), h, w)
    Y1 = _w32(((y << 9) - _host._YO) * _host._YC + (1 << 13))
    U = (uu - 128) << 9
    V = (vv - 128) << 9

    def clip(x):
        return torch.clamp(_w32(x), 0, (1 << 30) - 1) >> 14

    return torch.stack([clip(V * _host._V2R + Y1),
                        clip(V * _host._V2G + U * _host._U2G + Y1),
                        clip(U * _host._U2B + Y1)], -1).to(torch.int32)


def bgr0_to_yuv420p(img, device="cuda") -> tuple:
    """uint8 (h, w, 4) B, G, R, X -> uint8 (y, u, v) planes (tpu.py:73):
    chroma from the odd row of each pair, pixel pairs summed."""
    dev = _device(device)
    name = "rgb2yuv_bgr0.npz"
    Ay, By, Cy, Ey = _coeffs(name, "y")
    Au, Bu, Cu, Eu = _coeffs(name, "u")
    Av, Bv, Cv, Ev = _coeffs(name, "v")
    SH = int(_host._load(name)["shift"])
    img = _i64(img, dev)
    r, g, b = img[..., 2], img[..., 1], img[..., 0]
    y8 = (Ay * r + By * g + Cy * b + Ey) >> SH
    ro, go, bo = r[1::2], g[1::2], b[1::2]
    rs = ro[:, 0::2] + ro[:, 1::2]
    gs = go[:, 0::2] + go[:, 1::2]
    bs = bo[:, 0::2] + bo[:, 1::2]
    u8 = (Au * rs + Bu * gs + Cu * bs + Eu) >> (SH + 1)
    v8 = (Av * rs + Bv * gs + Cv * bs + Ev) >> (SH + 1)
    return _u8(y8, u8, v8)


def rgb48_to_yuv420p(img, device="cuda") -> tuple:
    """(h, w, 3) R, G, B 16-bit -> uint8 (y, u, v) planes (tpu.py:98):
    chroma from the odd row of each pair, pixel pairs averaged, an 8x8
    ordered dither on the 16 -> 8 bit reduction (tpu.py:92)."""
    dev = _device(device)
    name = "rgb2yuv_rgb48.npz"
    SHy, Ay, By, Cy = _coeffs(name, "y")
    SHu, Au, Bu, Cu = _coeffs(name, "u")
    SHv, Av, Bv, Cv = _coeffs(name, "v")
    img = _i64(img, dev)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    h, w = r.shape
    y8 = (Ay * r + By * g + Cy * b + _dither(name, "yE", h, w, dev)) >> SHy
    ro, go, bo = r[1::2], g[1::2], b[1::2]
    rh = (ro[:, 0::2] + ro[:, 1::2] + 1) >> 1
    gh = (go[:, 0::2] + go[:, 1::2] + 1) >> 1
    bh = (bo[:, 0::2] + bo[:, 1::2] + 1) >> 1
    hc, wc = rh.shape
    u8 = (Au * rh + Bu * gh + Cu * bh
          + _dither(name, "uE", hc, wc, dev)) >> SHu
    v8 = (Av * rh + Bv * gh + Cv * bh
          + _dither(name, "vE", hc, wc, dev)) >> SHv
    return _u8(y8, u8, v8)


def gbrp16_to_yuv420p(g, b, r, device="cuda") -> tuple:
    """Planar 16-bit RGB -> uint8 (y, u, v) planes (tpu.py:126): chroma
    picked at the (odd row, odd column) sample of each 2x2, with the
    8x8 ordered dither."""
    dev = _device(device)
    name = "rgb2yuv_gbrp16.npz"
    SHy, Ay, By, Cy = _coeffs(name, "y")
    SHu, Au, Bu, Cu = _coeffs(name, "u")
    SHv, Av, Bv, Cv = _coeffs(name, "v")
    r, g, b = _i64(r, dev), _i64(g, dev), _i64(b, dev)
    h, w = r.shape
    y8 = (Ay * r + By * g + Cy * b + _dither(name, "yE", h, w, dev)) >> SHy
    rs, gs, bs = r[1::2, 1::2], g[1::2, 1::2], b[1::2, 1::2]
    hc, wc = rs.shape
    u8 = (Au * rs + Bu * gs + Cu * bs
          + _dither(name, "uE", hc, wc, dev)) >> SHu
    v8 = (Av * rs + Bv * gs + Cv * bs
          + _dither(name, "vE", hc, wc, dev)) >> SHv
    return _u8(y8, u8, v8)


def fused_bgr0_phase_a(img, qt, bits: int, five: bool, device="cuda"):
    """A packed bgr0 frame -> yuv420p -> FFV1 phase A (context, folded
    diff) of each plane, on the device (tpu.py:152); ``qt`` is
    ``ffv1.phase_a.lut_for``'s (bases, thr, dlt)."""
    return [plane_context_diff(_wrap16(pl.to(torch.int32)), qt, bits, five)
            for pl in bgr0_to_yuv420p(img, device)]
