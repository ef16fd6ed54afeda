"""Copy of ``ffmpeg_ffv2_tpu/ffv1/params.py``.

FFV1 configuration and derived bitstream parameters.

``FFV1Config`` is the user-facing typed config (mirrors the reference's
AVOptions: -level, -coder, -context, -slices, -slicecrc, -g; ffv1enc.c:
1291-1307).  ``FFV1Params`` is everything derived at open() time, in the
spirit of ffv1enc.c:encode_init.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.pixfmt import PixelFormat, get_pix_fmt
from .quant_tables_data import (QUANT5, QUANT11, QUANT5_10BIT, QUANT9_10BIT,
                                VER2_STATE)
from ..coder.rac import DEFAULT_ONE_STATE

# coder ("ac") values as stored in the bitstream
CODER_GOLOMB = 0
CODER_RANGE_DEFAULT = 1
CODER_RANGE_CUSTOM = 2

MAX_SLICES = 1024
MAX_QUANT_TABLES = 8
MAX_CONTEXT_INPUTS = 5
CONTEXT_SIZE = 32


@dataclass
class FFV1Config:
    """User options (ffmpeg CLI names in comments)."""
    level: int = -1          # -level: bitstream version 0..4, -1 = auto
    coder: int = -1          # -coder: 0 rice, 1/2 range; -1 = auto (rice)
    context: int = 0         # -context: 0 small, 1 large model
    slices: int = 0          # -slices: 0 = auto
    slicecrc: int = -1       # -slicecrc: -1 auto (on for v>=3)
    gop_size: int = 12       # -g
    pass1_stats: str | None = None   # 2-pass: stats from a prior pass


def build_quant_tables(bits: int) -> tuple[np.ndarray, list[int]]:
    """The two built-in quant table sets (ffv1enc.c:730-753).

    Returns (tables[2][5][256] int16, context_counts[2]).
    """
    q_big = QUANT11 if bits <= 8 else QUANT9_10BIT
    q_small = QUANT5 if bits <= 8 else QUANT5_10BIT
    tabs = np.zeros((2, 5, 256), dtype=np.int16)
    tabs[0, 0] = q_big
    tabs[0, 1] = 11 * q_big
    tabs[0, 2] = 11 * 11 * q_big
    tabs[1, 0] = q_big
    tabs[1, 1] = 11 * q_big
    tabs[1, 2] = 11 * 11 * q_small
    tabs[1, 3] = 5 * 11 * 11 * q_small
    tabs[1, 4] = 5 * 5 * 11 * 11 * q_small
    counts = [(11 * 11 * 11 + 1) // 2, (11 * 11 * 5 * 5 * 5 + 1) // 2]
    return tabs, counts


def context_count_of(quant_table: np.ndarray) -> int:
    """Number of (folded) contexts a 5x256 quant table produces
    (ffv1dec.c:read_quant_tables)."""
    count = 1
    for i in range(5):
        ranges = int(quant_table[i][127]) * 2 + 1
        if ranges > 1:
            count *= ranges
    return (count + 1) // 2


def choose_slice_grid(width: int, height: int, bits: int, plane_count: int,
                      chroma_h_shift: int, chroma_v_shift: int,
                      requested_slices: int) -> tuple[int, int]:
    """Slice geometry search (ffv1enc.c:875-903): smallest grid whose
    worst-case slice coded size fits in 8<<24 bits and matches the
    requested slice count (if any)."""
    max_h = (width + (1 << chroma_h_shift) - 1) >> chroma_h_shift
    max_v = (height + (1 << chroma_v_shift) - 1) >> chroma_v_shift
    num_v = 2 if (width > 352 or height > 288 or not requested_slices) else 1
    num_v = min(num_v, max_v)
    while num_v < 32:
        num_h = num_v
        while num_h < 2 * num_v:
            maxw = (width + num_h - 1) // num_h
            maxh = (height + num_v - 1) // num_v
            ok = not (num_h > max_h or num_v > max_v)
            if ok and maxw * maxh * (bits + 1) * plane_count <= (8 << 24):
                if (requested_slices == num_h * num_v
                        and requested_slices <= MAX_SLICES) or not requested_slices:
                    return num_h, num_v
            num_h += 1
        num_v += 1
    raise ValueError(
        f"unsupported slice count {requested_slices}; pick 4, 6, 9, 12, 16, ...")


def slice_rects(width: int, height: int, num_h: int, num_v: int):
    """Per-slice (x, y, w, h); boundaries at width*sx/num_h (ffv1.c:117)."""
    rects = []
    for i in range(num_h * num_v):
        sx = i % num_h
        sy = i // num_h
        x0 = width * sx // num_h
        x1 = width * (sx + 1) // num_h
        y0 = height * sy // num_v
        y1 = height * (sy + 1) // num_v
        rects.append((x0, y0, x1 - x0, y1 - y0))
    return rects


@dataclass
class FFV1Params:
    """Derived bitstream-level parameters shared by encoder and decoder."""
    version: int
    micro_version: int
    width: int
    height: int
    colorspace: int
    bits: int
    chroma_planes: bool
    chroma_h_shift: int
    chroma_v_shift: int
    transparency: bool
    ac: int
    ec: int
    intra: int
    context_model: int
    num_h_slices: int
    num_v_slices: int
    plane_count: int
    use32bit: bool
    quant_tables: np.ndarray           # [nqt][5][256] int16
    context_counts: list[int]
    state_transition: np.ndarray       # uint8[256] one_state used by slices
    initial_states: list | None = None  # per qt: uint8[ctx][32] or None
    pix_fmt: PixelFormat | None = None

    @property
    def slice_count(self) -> int:
        return self.num_h_slices * self.num_v_slices

    def rects(self):
        return slice_rects(self.width, self.height,
                           self.num_h_slices, self.num_v_slices)


def params_from_config(cfg: FFV1Config, pix_fmt: str | PixelFormat,
                       width: int, height: int) -> FFV1Params:
    """encode_init logic (ffv1enc.c:517-928), minus 2-pass stats."""
    fmt = get_pix_fmt(pix_fmt) if isinstance(pix_fmt, str) else pix_fmt

    version = 0
    if cfg.slices > 1:
        version = max(version, 2)
    if cfg.slices == 0 and cfg.level < 0 and width * height > 720 * 576:
        version = max(version, 2)
    if cfg.level <= 0 and version == 2:
        version = 3
    if 0 <= cfg.level <= 4:
        if cfg.level < version:
            raise ValueError(
                f"version {version} needed for requested features "
                f"but level {cfg.level} requested")
        version = cfg.level

    ec = cfg.slicecrc
    if ec < 0:
        ec = 1 if version >= 3 else 0
    if ec:
        version = max(version, 3)

    ac = cfg.coder
    if ac in (-1, 0):
        ac = CODER_GOLOMB
    elif ac == 1:
        ac = CODER_RANGE_CUSTOM   # historic '-coder 1' means custom table
    elif ac == -2:
        ac = CODER_RANGE_DEFAULT
    elif ac == 2:
        ac = CODER_RANGE_CUSTOM

    bits = fmt.bits
    colorspace = fmt.colorspace
    transparency = fmt.transparency
    chroma_planes = fmt.chroma_planes if colorspace == 0 else True
    use32bit = colorspace == 1 and bits >= 16
    if bits > 8:
        version = max(version, 1)

    if bits > 8 and ac == CODER_GOLOMB:
        ac = CODER_RANGE_CUSTOM   # ffv1enc.c:702-708

    plane_count = 3 if transparency else 2
    if not chroma_planes and version > 3:
        plane_count -= 1

    quant_tables, context_counts = build_quant_tables(bits)

    if ac == CODER_RANGE_CUSTOM:
        state_transition = VER2_STATE.astype(np.uint8).copy()
    else:
        state_transition = DEFAULT_ONE_STATE.copy()

    if version > 1:
        # full plane count incl. chroma pair for the size constraint
        full_planes = 1 + 2 * chroma_planes + transparency
        num_h, num_v = choose_slice_grid(
            width, height, bits, full_planes,
            fmt.chroma_h_shift if colorspace == 0 else 0,
            fmt.chroma_v_shift if colorspace == 0 else 0,
            cfg.slices)
    else:
        num_h = num_v = 1

    micro = {3: 4, 4: 2}.get(version, 0)

    return FFV1Params(
        version=version, micro_version=micro,
        width=width, height=height,
        colorspace=colorspace, bits=bits,
        chroma_planes=chroma_planes if colorspace == 0 else True,
        chroma_h_shift=fmt.chroma_h_shift if colorspace == 0 else 0,
        chroma_v_shift=fmt.chroma_v_shift if colorspace == 0 else 0,
        transparency=transparency,
        ac=ac, ec=ec, intra=1 if cfg.gop_size < 2 else 0,
        context_model=cfg.context,
        num_h_slices=num_h, num_v_slices=num_v,
        plane_count=plane_count, use32bit=use32bit,
        quant_tables=quant_tables, context_counts=context_counts,
        state_transition=state_transition,
        initial_states=None, pix_fmt=fmt,
    )
