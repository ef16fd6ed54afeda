"""Elementwise put_symbol arithmetic of the device FFV1 encoder.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/device_coder.py:94-201``
(``lookup_packed``, ``exponent``, ``event_count``, ``slot_bit_grid``).
For coding depths <= 10 put_symbol_inline (ffv1enc.c:185-231) touches
each of a context's 32 state slots at most once per pixel: slot 0, the
exponent slots 1..e+1, the mantissa slots 22..21+e and the sign slot
11+e.
"""

from __future__ import annotations

import torch


def lookup_packed(table: torch.Tensor, idx9: torch.Tensor) -> torch.Tensor:
    """Byte ``idx9`` (int32 in [0, 512)) of the packed transition table
    (128 little-endian int32 words)."""
    word = table[(idx9 >> 2).long()]
    return (word >> ((idx9 & 3) * 8)) & 0xFF


def exponent(a: torch.Tensor) -> torch.Tensor:
    """floor(log2(a)) for 1 <= a < 2^24 via the float32 exponent; -1 for
    0."""
    e = (a.to(torch.float32).view(torch.int32) >> 23) - 127
    return torch.where(a > 0, e, -1)


def event_count(diff: torch.Tensor) -> torch.Tensor:
    """Number of rac ops put_symbol(diff, signed) performs."""
    e = exponent(diff.abs())
    return torch.where(diff == 0, 1, 2 * e + 3).to(torch.int32)


def slot_bit_grid(diff: torch.Tensor):
    """Per (pixel, slot) validity and coded bit of each slot's first hit:
    (valid bool [..., 32], bit int32 [..., 32]), including the e > 9
    FFMIN caps of put_symbol_inline (ffv1enc.c:203-230)."""
    v = diff[..., None]
    a = v.abs()
    e = exponent(diff.abs())[..., None]
    s = torch.arange(32, dtype=torch.int32, device=diff.device)
    s = s.expand(v.shape[:-1] + (32,))
    nz = v != 0
    is0 = s == 0
    isexp = (s >= 1) & (s <= torch.clamp(e + 1, max=10))
    ismant = (s >= 22) & (s <= 21 + torch.clamp(e, max=10))
    issign = s == 11 + torch.clamp(e, max=10)
    valid = is0 | (nz & (isexp | ismant | issign))
    msh = torch.where((s == 31) & (e > 9), e - 1, s - 22)
    i32 = torch.int32
    bit = torch.where(is0, (v == 0).to(i32),
          torch.where(isexp, (s <= e).to(i32),
          torch.where(ismant, (a >> torch.clamp(msh, min=0)) & 1,
                      (v < 0).to(i32))))
    return valid, bit.to(i32)
