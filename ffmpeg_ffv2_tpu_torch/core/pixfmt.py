"""Copy of ``ffmpeg_ffv2_tpu/core/pixfmt.py``.

Pixel format registry — the subset FFV1/FFV2 accept.

Modeled on libavutil/pixdesc.c but as a small typed table.  A format is
described by its component layout; frames are carried as per-plane numpy /
jax arrays (planar), with packed RGB formats (bgr0/rgb32, rgb48, rgba64)
normalized to planar at the API boundary.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PixelFormat:
    name: str
    colorspace: int          # 0 = YUV/gray, 1 = RGB
    bits: int                # bits per raw sample
    chroma_planes: bool
    chroma_h_shift: int
    chroma_v_shift: int
    transparency: bool
    packed: bool = False     # True for bgr0/rgb32/rgb48/rgba64 byte-packed

    @property
    def nb_planes(self) -> int:
        if self.colorspace == 1:
            return 3 + self.transparency
        n = 1
        if self.chroma_planes:
            n += 2
        if self.transparency:
            n += 1
        return n


_FORMATS: dict[str, PixelFormat] = {}


def _add(name, colorspace, bits, chroma, hs, vs, alpha, packed=False):
    _FORMATS[name] = PixelFormat(name, colorspace, bits, chroma, hs, vs,
                                 alpha, packed)


# --- grayscale ---
for b in (8, 9, 10, 12, 16):
    _add("gray" if b == 8 else f"gray{b}", 0, b, False, 0, 0, False)
_add("ya8", 0, 8, False, 0, 0, True)

# --- planar YUV ---
for b in (8, 9, 10, 12, 14, 16):
    suf = "" if b == 8 else f"p{b}"
    for sub, (hs, vs) in {"444": (0, 0), "422": (1, 0), "420": (1, 1),
                          "440": (0, 1), "411": (2, 0), "410": (2, 2)}.items():
        if sub in ("440",) and b in (9, 14, 16):
            continue
        if sub in ("411", "410") and b != 8:
            continue
        name = f"yuv{sub}p" if b == 8 else f"yuv{sub}p{b}"
        _add(name, 0, b, True, hs, vs, False)

# --- planar YUV + alpha ---
for b in (8, 9, 10, 16):
    for sub, (hs, vs) in {"444": (0, 0), "422": (1, 0), "420": (1, 1)}.items():
        name = f"yuva{sub}p" if b == 8 else f"yuva{sub}p{b}"
        _add(name, 0, b, True, hs, vs, True)

# --- planar RGB (GBR plane order in FFV1 coding; 8-bit gbrp used by FFV2) ---
_add("gbrp", 1, 8, True, 0, 0, False)
for b in (9, 10, 12, 14, 16):
    _add(f"gbrp{b}", 1, b, True, 0, 0, False)
for b in (10, 12, 16):
    _add(f"gbrap{b}", 1, b, True, 0, 0, True)

# --- packed RGB ---
_add("bgr0", 1, 8, True, 0, 0, False, packed=True)   # a.k.a. 0RGB32 little-endian
_add("rgb32", 1, 8, True, 0, 0, True, packed=True)   # BGRA bytes on LE
_add("rgb48", 1, 16, True, 0, 0, False, packed=True)
_add("rgba64", 1, 16, True, 0, 0, True, packed=True)


def get_pix_fmt(name: str) -> PixelFormat:
    try:
        return _FORMATS[name]
    except KeyError:
        raise ValueError(f"unknown/unsupported pixel format: {name}") from None


def list_pix_fmts() -> list[str]:
    return sorted(_FORMATS)


def find_yuv_format(bits: int, chroma_planes: bool, hs: int, vs: int,
                    transparency: bool) -> PixelFormat:
    """Deduce the decoder output format from FFV1 header fields
    (ffv1dec.c:read_header pix_fmt deduction)."""
    for f in _FORMATS.values():
        if (f.colorspace == 0 and f.bits == bits
                and f.chroma_planes == chroma_planes
                and f.chroma_h_shift == hs and f.chroma_v_shift == vs
                and f.transparency == transparency):
            return f
    raise ValueError(
        f"no YUV format for bits={bits} chroma={chroma_planes} "
        f"{hs}:{vs} alpha={transparency}")


def find_rgb_format(bits: int, transparency: bool) -> PixelFormat:
    if bits <= 8:
        return _FORMATS["rgb32" if transparency else "bgr0"]
    for f in _FORMATS.values():
        if (f.colorspace == 1 and not f.packed and f.bits == bits
                and f.transparency == transparency):
            return f
    raise ValueError(f"no RGB format for bits={bits} alpha={transparency}")
