"""Elementwise put_symbol arithmetic of the device FFV1 encoder.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/device_coder.py:94-252``
(``lookup_packed``, ``exponent``, ``event_count``, ``slot_bit_grid``,
``emission_slots``, ``emission_source``).  For coding depths <= 10
put_symbol_inline (ffv1enc.c:185-231) touches each of a context's 32 state
slots at most once per pixel: slot 0, the exponent slots 1..e+1, the
mantissa slots 22..21+e and the sign slot 11+e.  Deeper formats (e > 9)
cap the exponent slot at 10 and the mantissa slot at 31, which then repeat
up to e - 9 times each.
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


def emission_slots(diff: torch.Tensor, k_max: int):
    """Per (pixel, k) the state slot and coded bit of the pixel's k-th rac
    op, in emission order [slot 0][exponent ones][terminator][mantissa,
    high bit first][sign], with the e > 9 FFMIN caps (slots 10 and 31
    repeat).  Returns (slot int32 [..., K], bit int32 [..., K], valid bool
    [..., K]), slot and bit 0 where invalid."""
    i32 = torch.int32
    v = diff[..., None]
    a = v.abs()
    e = exponent(diff.abs())[..., None]
    k = torch.arange(k_max, dtype=i32, device=diff.device)
    k = k.expand(v.shape[:-1] + (k_max,))
    valid = torch.where(v != 0, k <= 2 * e + 2, k == 0)
    mant_i = 2 * e + 1 - k                    # for the mantissa span
    slot = torch.where(
        k == 0, 0,
        torch.where(k <= e, torch.clamp(k, max=10),
                    torch.where(k == e + 1, torch.clamp(e + 1, max=10),
                                torch.where(k <= 2 * e + 1,
                                            22 + torch.clamp(mant_i, max=9),
                                            11 + torch.clamp(e, max=10)))))
    bit = torch.where(
        k == 0, (v == 0).to(i32),
        torch.where(k <= e, 1,
                    torch.where(k == e + 1, 0,
                                torch.where(k <= 2 * e + 1,
                                            (a >> torch.clamp(mant_i, min=0))
                                            & 1, (v < 0).to(i32)))))
    return (torch.where(valid, slot, 0).to(i32),
            torch.where(valid, bit, 0).to(i32), valid)


def emission_source(diff: torch.Tensor, k_max: int):
    """Per (pixel, k) where the k-th emission's sv byte sits in the
    slot-packed words: (word int32 [..., K], shift int32 [..., K]), byte =
    (sv_words[word] >> shift) & 0xFF.  First hits read the base words
    (word = slot // 4, shift = slot % 4 * 8); repeat hit h >= 2 of slot 10
    or 31 (j = h - 1) reads ext word 8 + (j - 1) // 2 at shift
    (j - 1) % 2 * 16 + (slot == 31) * 8."""
    e = exponent(diff.abs())[..., None]
    k = torch.arange(k_max, dtype=torch.int32, device=diff.device)
    k = k.expand(diff.shape + (k_max,))
    slot, _, _ = emission_slots(diff, k_max)
    # hit index within the pixel for the capped slots
    h10 = torch.where(k <= e, k - 9, e - 8)   # exp ones then terminator
    h31 = k - e - 1                           # mantissa position
    h = torch.where(slot == 10, torch.clamp(h10, min=1),
                    torch.where(slot == 31, torch.clamp(h31, min=1), 1))
    j = h - 1                                 # 0 = base, >= 1 = ext pair j
    word = torch.where(j == 0, slot >> 2,
                       8 + torch.div(j - 1, 2, rounding_mode="floor"))
    shift = torch.where(j == 0, (slot & 3) * 8,
                        ((j - 1) % 2) * 16 + torch.where(slot == 31, 8, 0))
    return word.to(torch.int32), shift.to(torch.int32)
