"""Copy of ``ffmpeg_ffv2_tpu/ffv1/codec_py.py`` (its ``SliceState`` is the
port's ``slice_state.py``).

Scalar (pure-Python) FFV1 slice codec — the bit-exactness oracle.

Everything here mirrors the FFV1 bitstream semantics (reference:
ffv1_template.c, ffv1enc_template.c, ffv1dec_template.c) but is written for
clarity, not speed.  The C++ host codec (native/) and the TPU kernels
(tpu.py) are both validated against this module.

Sample-buffer convention: each plane is coded line by line with a ring of
2 (context model 0) or 3 (model 1) rows, each padded with 3 guard entries on
the left and 3 on the right; guards are zero except position -1 (set to T of
x=0) and position w (set to T of x=w-1) refreshed per row.
"""

from __future__ import annotations

import numpy as np

from ..coder.rac import RangeEncoder, RangeDecoder
from ..coder.symbols import put_symbol, get_symbol
from ..coder.bitio import BitWriter, BitReader
from ..coder.golomb import LOG2_RUN, put_vlc_symbol, get_vlc_symbol
from .params import CODER_GOLOMB
from .slice_state import SliceState


def fold(diff: int, bits: int) -> int:
    diff &= (1 << bits) - 1
    if diff & (1 << (bits - 1)):
        diff -= 1 << bits
    return diff


def mid_pred(a: int, b: int, c: int) -> int:
    # median of three (mathops.h:mid_pred)
    if a > b:
        a, b = b, a
    return min(max(a, c), b)


def predict(cur, prev, x: int) -> int:
    L, T, LT = cur[x - 1], prev[x], prev[x - 1]
    return mid_pred(L, L + T - LT, T)


def get_context5(qt, cur, prev, prev2, x: int) -> int:
    LT, T, RT = prev[x - 1], prev[x], prev[x + 1]
    L = cur[x - 1]
    ctx = (qt[0][(L - LT) & 0xFF] + qt[1][(LT - T) & 0xFF]
           + qt[2][(T - RT) & 0xFF])
    if qt[3][127] or qt[4][127]:
        TT = prev2[x]
        LL = cur[x - 2]
        ctx += qt[3][(LL - L) & 0xFF] + qt[4][(TT - T) & 0xFF]
    return ctx


# ---------------------------------------------------------------------------
# line coding
# ---------------------------------------------------------------------------

def encode_line(ss: SliceState, c: RangeEncoder, pb: BitWriter | None,
                qt, states, vlc_states, w: int, cur, prev, prev2,
                bits: int):
    """One line, range or golomb mode (ffv1enc_template.c:23-123).

    cur/prev/prev2 are python lists indexed -3..w+2 via offset handling by
    the caller (we pass _Row wrappers)."""
    p = ss.p
    run_index = ss.run_index
    run_count = 0
    run_mode = 0

    if ss.slice_coding_mode == 1:
        for x in range(w):
            v = cur[x]
            for i in range(bits - 1, -1, -1):
                c.put_fixed((v >> i) & 1)
        return

    for x in range(w):
        context = get_context5(qt, cur, prev, prev2, x)
        diff = cur[x] - predict(cur, prev, x)
        if context < 0:
            context = -context
            diff = -diff
        diff = fold(diff, bits)

        if p.ac != CODER_GOLOMB:
            put_symbol(c, states[context], diff, True)
        else:
            if context == 0:
                run_mode = 1
            if run_mode:
                if diff:
                    while run_count >= 1 << LOG2_RUN[run_index]:
                        run_count -= 1 << LOG2_RUN[run_index]
                        run_index += 1
                        pb.put(1, 1)
                    pb.put(1 + LOG2_RUN[run_index], run_count)
                    if run_index:
                        run_index -= 1
                    run_count = 0
                    run_mode = 0
                    if diff > 0:
                        diff -= 1
                else:
                    run_count += 1
            if run_mode == 0:
                put_vlc_symbol(pb, vlc_states[context], diff, bits)

    if run_mode:
        while run_count >= 1 << LOG2_RUN[run_index]:
            run_count -= 1 << LOG2_RUN[run_index]
            run_index += 1
            pb.put(1, 1)
        if run_count:
            pb.put(1, 1)
    ss.run_index = run_index


def decode_line(ss: SliceState, c: RangeDecoder, gb: BitReader | None,
                qt, states, vlc_states, w: int, cur, prev,
                bits: int):
    """One line decode (ffv1dec_template.c:23-126).  ``cur`` doubles as the
    TT row: cur[x] still holds the value from two rows ago until written."""
    p = ss.p
    run_count = 0
    run_mode = 0
    run_index = ss.run_index
    mask = (1 << bits) - 1

    if ss.slice_coding_mode == 1:
        for x in range(w):
            v = 0
            for _ in range(bits):
                v += v + c.get_fixed()
            cur[x] = v
        return

    x = 0
    while x < w:
        context = get_context5(qt, cur, prev, cur, x)
        if context < 0:
            context = -context
            sign = 1
        else:
            sign = 0

        if p.ac != CODER_GOLOMB:
            diff = get_symbol(c, states[context], True)
        else:
            if context == 0 and run_mode == 0:
                run_mode = 1
            if run_mode:
                if run_count == 0 and run_mode == 1:
                    if gb.get1():
                        run_count = 1 << LOG2_RUN[run_index]
                        if x + run_count <= w:
                            run_index += 1
                    else:
                        if LOG2_RUN[run_index]:
                            run_count = gb.get(LOG2_RUN[run_index])
                        else:
                            run_count = 0
                        if run_index:
                            run_index -= 1
                        run_mode = 2
                if cur[x - 1] == prev[x - 1]:
                    while run_count > 1 and w - x > 1:
                        cur[x] = prev[x]
                        x += 1
                        run_count -= 1
                else:
                    while run_count > 1 and w - x > 1:
                        cur[x] = predict(cur, prev, x)
                        x += 1
                        run_count -= 1
                run_count -= 1
                if run_count < 0:
                    run_mode = 0
                    run_count = 0
                    diff = get_vlc_symbol(gb, vlc_states[context], bits)
                    if diff >= 0:
                        diff += 1
                else:
                    diff = 0
            else:
                diff = get_vlc_symbol(gb, vlc_states[context], bits)

        if sign:
            diff = -diff

        cur[x] = (predict(cur, prev, x) + diff) & mask
        x += 1
    ss.run_index = run_index


class _Row:
    """A padded sample row: logical indices -3..w+2 map onto a list.

    Stored values wrap like the reference's sample buffers: int16 for the
    regular paths, int32 when use32bit (RGB >= 16 bpc).  The wrap is
    semantically significant for full-range 16-bit YUV (values >= 32768 go
    negative and feed the predictor that way on both ends)."""
    __slots__ = ("data", "wrap_bits")

    PAD = 3

    def __init__(self, w: int, wrap_bits: int = 16):
        self.data = [0] * (w + 6)
        self.wrap_bits = wrap_bits

    def _w(self, v: int) -> int:
        b = self.wrap_bits
        return ((int(v) + (1 << (b - 1))) & ((1 << b) - 1)) - (1 << (b - 1))

    def __getitem__(self, i: int) -> int:
        return self.data[i + self.PAD]

    def __setitem__(self, i: int, v: int):
        self.data[i + self.PAD] = self._w(v)

    def fill_from(self, arr):
        d = self.data
        d[self.PAD:self.PAD + len(arr)] = [self._w(v) for v in arr]


# ---------------------------------------------------------------------------
# plane coding
# ---------------------------------------------------------------------------

def encode_plane(ss: SliceState, c, pb, plane: np.ndarray, plane_index: int,
                 bits: int):
    """ffv1enc.c:encode_plane — YUV/gray planes."""
    p = ss.p
    h, w = plane.shape
    ring = 3 if p.context_model else 2
    rows = [_Row(w) for _ in range(ring)]
    ss.run_index = 0
    qt = p.quant_tables[ss.plane_qt_index[plane_index]]
    states = ss.states[plane_index] if ss.states else None
    vlcs = ss.vlc_states[plane_index] if ss.vlc_states else None

    for y in range(h):
        # ring indexing identical to the reference: (h + i - y) % ring
        sample = [rows[(h + i - y) % ring] for i in range(ring)]
        cur, prev = sample[0], sample[1]
        prev2 = sample[2] if ring == 3 else sample[0]  # unused when model 0
        cur.fill_from(plane[y])
        cur[-1] = prev[0]
        prev[w] = prev[w - 1]
        encode_line(ss, c, pb, qt, states, vlcs, w, cur, prev, prev2, bits)


def decode_plane(ss: SliceState, c, gb, out: np.ndarray, plane_index: int,
                 bits: int):
    p = ss.p
    h, w = out.shape
    ss.run_index = 0
    qt = p.quant_tables[ss.plane_qt_index[plane_index]]
    states = ss.states[plane_index] if ss.states else None
    vlcs = ss.vlc_states[plane_index] if ss.vlc_states else None

    rows = [_Row(w), _Row(w)]
    for y in range(h):
        prev, cur = rows[y % 2], rows[(y + 1) % 2]
        cur[-1] = prev[0]
        prev[w] = prev[w - 1]
        decode_line(ss, c, gb, qt, states, vlcs, w, cur, prev, bits)
        mask = (1 << bits) - 1
        out[y] = [v & mask for v in cur.data[_Row.PAD:_Row.PAD + w]]


# ---------------------------------------------------------------------------
# RGB (RCT) coding
# ---------------------------------------------------------------------------

def encode_rgb(ss: SliceState, c, pb, planes: list[np.ndarray], bits: int):
    """ffv1enc_template.c:encode_rgb_frame — planes are [g, b, r, (a)]
    *source* samples; RCT applied here.  lbd (8-bit) planes code at 9 bits."""
    p = ss.p
    h, w = planes[0].shape
    lbd = p.bits <= 8
    offset = 1 << bits
    nplanes = 3 + (1 if p.transparency else 0)
    ring = 3 if p.context_model else 2
    wb = 32 if p.use32bit else 16
    rows = [[_Row(w, wb) for _ in range(ring)] for _ in range(4)]
    ss.run_index = 0

    # planar 9..14-bit RGB without alpha: the reference reads G<->B swapped
    # (ffv1enc_template.c:170-172); mirror for bit-exactness
    swap = (p.colorspace == 1 and not p.use32bit and not p.transparency
            and p.bits > 8)
    gi, bi = (1, 0) if swap else (0, 1)
    for y in range(h):
        sample = [[rows[pl][(h + i - y) % ring] for i in range(ring)]
                  for pl in range(4)]
        g_row = planes[gi][y].astype(np.int64)
        b_row = planes[bi][y].astype(np.int64)
        r_row = planes[2][y].astype(np.int64)
        a_row = planes[3][y].astype(np.int64) if p.transparency else None

        if ss.slice_coding_mode != 1:
            b2 = b_row - g_row
            r2 = r_row - g_row
            g2 = g_row + ((b2 * ss.slice_rct_by + r2 * ss.slice_rct_ry) >> 2)
            b2 = b2 + offset
            r2 = r2 + offset
        else:
            g2, b2, r2 = g_row, b_row, r_row

        sample[0][0].fill_from(g2)
        sample[1][0].fill_from(b2)
        sample[2][0].fill_from(r2)
        if a_row is not None:
            sample[3][0].fill_from(a_row)

        for pl in range(nplanes):
            cur, prev = sample[pl][0], sample[pl][1]
            prev2 = sample[pl][2] if ring == 3 else sample[pl][0]
            cur[-1] = prev[0]
            prev[w] = prev[w - 1]
            plane_index = (pl + 1) // 2
            qt = p.quant_tables[ss.plane_qt_index[plane_index]]
            states = ss.states[plane_index] if ss.states else None
            vlcs = ss.vlc_states[plane_index] if ss.vlc_states else None
            if lbd and ss.slice_coding_mode == 0:
                eff_bits = 9
            else:
                eff_bits = bits + (1 if ss.slice_coding_mode != 1 else 0)
            encode_line(ss, c, pb, qt, states, vlcs, w, cur, prev, prev2,
                        eff_bits)


def decode_rgb(ss: SliceState, c, gb, out_planes: list[np.ndarray],
               bits: int):
    """ffv1dec_template.c:decode_rgb_frame; out planes [g, b, r, (a)]."""
    p = ss.p
    h, w = out_planes[0].shape
    lbd = p.bits <= 8
    offset = 1 << bits
    nplanes = 3 + (1 if p.transparency else 0)
    wb = 32 if p.use32bit else 16
    rows = [[_Row(w, wb), _Row(w, wb)] for _ in range(4)]
    ss.run_index = 0

    for y in range(h):
        for pl in range(nplanes):
            prev, cur = rows[pl][y % 2], rows[pl][(y + 1) % 2]
            cur[-1] = prev[0]
            prev[w] = prev[w - 1]
            plane_index = (pl + 1) // 2
            qt = p.quant_tables[ss.plane_qt_index[plane_index]]
            states = ss.states[plane_index] if ss.states else None
            vlcs = ss.vlc_states[plane_index] if ss.vlc_states else None
            if lbd and ss.slice_coding_mode == 0:
                eff_bits = 9
            else:
                eff_bits = bits + (1 if ss.slice_coding_mode != 1 else 0)
            decode_line(ss, c, gb, qt, states, vlcs, w, cur, prev, eff_bits)

        swap = (p.colorspace == 1 and not p.use32bit and not p.transparency
                and p.bits > 8)
        go, bo = (1, 0) if swap else (0, 1)
        cur_of = lambda pl: rows[pl][(y + 1) % 2]
        for x in range(w):
            g = cur_of(0)[x]
            b = cur_of(1)[x]
            r = cur_of(2)[x]
            a = cur_of(3)[x] if p.transparency else 0
            if ss.slice_coding_mode != 1:
                b -= offset
                r -= offset
                g -= (b * ss.slice_rct_by + r * ss.slice_rct_ry) >> 2
                b += g
                r += g
            out_planes[go][y, x] = g
            out_planes[bo][y, x] = b
            out_planes[2][y, x] = r
            if p.transparency:
                out_planes[3][y, x] = a
