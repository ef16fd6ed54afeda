"""A plain FFV1 version 3 encoder of YUV above 8 bits: the yardstick of
the cells whose samples have 9 to 16 bits.

It covers what such a configuration states: YUV at ``bits`` 9..16 with
any chroma subsampling (``h_shift``, ``v_shift``), context model 0 or 1
(``-context``), ``-coder 1`` (range coder, custom state table), slices on
FFmpeg's grid, slice CRCs, key frames every ``gop`` frames with the
contexts carried across the frames between them.  The packets are
FFmpeg's byte for byte (RFC 9043; ffv1enc.c).  Where it differs from the
8-bit reference (``ffv1.py``):

- the context quantisers are ffv1enc.c's ``quant9_10bit`` and
  ``quant5_10bit`` (``tables_hbd.py``), still indexed by each sample
  difference's low 8 bits (ffv1.h:get_context);
- the residual folds to ``bits`` bits (ffv1enc_template.c:encode_line);
- the samples are read as int16, as ffv1enc.c:encode_plane stores them,
  so a 16-bit sample past 32767 wraps before the prediction;
- the chroma crops of a slice at (x, y, w, h) are at (x >> h_shift,
  y >> v_shift), ceil(w / 2^h_shift) by ceil(h / 2^v_shift);
- the slice grid's search takes the format's chroma limits and
  ``bits + 1`` bits a sample in its size test (ffv1enc.c).

FFmpeg codes every sample above 8 bits with the range coder: asked for
Golomb-Rice there, it switches to the range coder without a word
(ffv1enc.c).  ``packets`` refuses such a configuration rather than code
something else than it states.  The range coder is ``coder.c``'s, and
the session's frame loop and slice header ``ffv1.py``'s.  Nothing here
imports or calls the program under test.
"""

from __future__ import annotations

import numpy as np

from . import build
from .ffv1 import (MAX_SLICES, PLANE_CLASSES, RefFFV1Encoder, crc32_ieee,
                   slice_rects)
from .tables import VER2_STATE, zero_state
from .tables_hbd import QUANT5_10BIT, QUANT9_10BIT

# each context model's quantisers of L - LT, LT - T, T - RT, LL - L, TT - T
# (ffv1enc.c's quant_tables[0] and [1] above 8 bits), and its folded count
QUANT = {0: [QUANT9_10BIT, 11 * QUANT9_10BIT, 121 * QUANT9_10BIT],
         1: [QUANT9_10BIT, 11 * QUANT9_10BIT, 121 * QUANT5_10BIT,
             605 * QUANT5_10BIT, 3025 * QUANT5_10BIT]}
CONTEXTS = {0: (11 * 11 * 11 + 1) // 2, 1: (11 * 11 * 5 * 5 * 5 + 1) // 2}
# the chroma shifts (h, v) of each YUV layout FFmpeg's FFV1 takes above
# 8 bits
SHIFTS = {"420": (1, 1), "422": (1, 0), "440": (0, 1), "444": (0, 0)}


def pix_fmt_layout(pix_fmt: str) -> tuple:
    """``yuv<layout>p<bits>`` (``yuv422p10``) -> (bits, h_shift,
    v_shift)."""
    layout, bits = pix_fmt[3:6], pix_fmt[7:]
    if (not pix_fmt.startswith("yuv") or layout not in SHIFTS
            or pix_fmt[6:7] != "p" or not bits.isdigit()
            or not 9 <= int(bits) <= 16):
        raise ValueError(f"{pix_fmt!r} is not planar YUV at 9-16 bits")
    return (int(bits), *SHIFTS[layout])


def slice_grid(width: int, height: int, slices: int, bits: int,
               h_shift: int, v_shift: int) -> tuple:
    """ffv1enc.c's search for the (columns, rows) of ``slices`` slices of
    a YUV frame with three planes, ``bits`` bits a sample and the chroma
    shifts given."""
    max_h = (width + (1 << h_shift) - 1) >> h_shift
    max_v = (height + (1 << v_shift) - 1) >> v_shift
    num_v = min(2 if (width > 352 or height > 288) else 1, max_v)
    while num_v < 32:
        for num_h in range(num_v, 2 * num_v):
            maxw = (width + num_h - 1) // num_h
            maxh = (height + num_v - 1) // num_v
            if (num_h <= max_h and num_v <= max_v
                    and maxw * maxh * (bits + 1) * 3 <= 8 << 24
                    and num_h * num_v == slices and slices <= MAX_SLICES):
                return num_h, num_v
        num_v += 1
    raise ValueError(f"no slice grid of {slices} slices at {width}x{height}")


def predict_contexts(p: np.ndarray, model: int, bits: int) -> tuple:
    """One slice's plane (h, w) of ``bits``-bit samples -> (context,
    residual) int32 (h, w), each context folded to >= 0 with its
    residual's sign, the residual folded to ``bits`` bits.  The
    neighbours at the slice's edges are those of ``ffv1.py``'s
    ``predict_contexts``: rows above the slice are 0; the left neighbour
    of column 0 is the sample above it, the top-left the sample two rows
    up; the top-right of the last column repeats the sample above it;
    model 1's LL of column 0 is 0, of column 1 the sample above column 0,
    and its TT is 0 in the first two rows."""
    # int16 as ffv1enc.c:encode_plane reads them, then int32 arithmetic
    p = np.asarray(p).astype(np.uint16).view(np.int16).astype(np.int32)
    t = np.zeros_like(p)
    t[1:] = p[:-1]
    l = np.empty_like(p)
    l[:, 1:] = p[:, :-1]
    l[:, 0] = t[:, 0]
    lt = np.zeros_like(p)
    lt[:, 1:] = t[:, :-1]
    lt[2:, 0] = p[:-2, 0]
    rt = np.empty_like(p)
    rt[:, :-1] = t[:, 1:]
    rt[:, -1] = t[:, -1]
    grad = l + t - lt
    pred = np.maximum(np.minimum(l, t), np.minimum(np.maximum(l, t), grad))
    q = QUANT[model]
    ctx = q[0].take((l - lt) & 0xFF)
    ctx += q[1].take((lt - t) & 0xFF)
    ctx += q[2].take((t - rt) & 0xFF)
    if model == 1:
        ll = np.zeros_like(p)
        ll[:, 2:] = p[:, :-2]
        ll[:, 1] = t[:, 0]
        tt = np.zeros_like(p)
        tt[2:] = p[:-2]
        ctx += q[3].take((ll - l) & 0xFF)
        ctx += q[4].take((tt - t) & 0xFF)
    sign = np.where(ctx < 0, -1, 1).astype(np.int32)
    half = 1 << (bits - 1)
    diff = (((p - pred) * sign + half) & ((1 << bits) - 1)) - half
    return ctx * sign, diff


class RefHBDEncoder(RefFFV1Encoder):
    """An encoder session: ``encode(planes)`` codes the next frame, a key
    frame every ``gop`` frames (gop 1: every frame), with context model
    ``context``.  ``planes`` are the Y, U, V arrays of a frame, ``bits``
    bits a sample (uint16, the low bits carrying the sample), chroma
    subsampled by ``h_shift`` and ``v_shift``.  The frame loop, the slice
    header and the work counts are ``ffv1.py``'s; the grid, the crops and
    each slice's contexts and residuals are those above 8 bits."""

    def __init__(self, width: int, height: int, slices: int, gop: int,
                 context: int, bits: int, h_shift: int, v_shift: int,
                 threads: int = 8):
        if context not in QUANT:
            raise ValueError("context model 0 or 1")
        if not 9 <= bits <= 16:
            raise ValueError("9 to 16 bits a sample; ffv1.py codes 8")
        self.w, self.h, self.gop = width, height, gop
        self.model, self.contexts = context, CONTEXTS[context]
        self.bits, self.hs, self.vs = bits, h_shift, v_shift
        self.rice = False
        self.num_h, self.num_v = slice_grid(width, height, slices, bits,
                                            h_shift, v_shift)
        self.rects = slice_rects(width, height, self.num_h, self.num_v)
        self.one = np.ascontiguousarray(VER2_STATE, np.uint8)
        self.zero = zero_state(self.one, default=False)
        rows = PLANE_CLASSES * self.contexts
        self.states = np.full((len(self.rects), rows, 32), 128, np.uint8)
        self.threads = threads
        self.picture_number = 0
        self.work = []     # a dict of work counts a frame coded
        self.lib = build.lib()

    def _slice(self, si: int, planes, keyframe: bool) -> tuple:
        """Slice ``si``'s bytes, trailers included, and its counts (the
        binary decisions coded, the terminator's included)."""
        x, y, w, h = self.rects[si]
        cx, cy = x >> self.hs, y >> self.vs
        cw, ch = -(-w >> self.hs), -(-h >> self.vs)
        crops = [planes[0][y:y + h, x:x + w],
                 planes[1][cy:cy + ch, cx:cx + cw],
                 planes[2][cy:cy + ch, cx:cx + cw]]
        if keyframe:
            self.states[si] = 128       # ff_ffv1_clear_slice_state
        keybit = int(keyframe) if si == 0 else -1
        hdr = self._header(self.rects[si])
        parts = [predict_contexts(c, self.model, self.bits) for c in crops]
        rows = np.concatenate([c.ravel() + min(k, 1) * self.contexts
                               for k, (c, _) in enumerate(parts)])
        diff = np.concatenate([d.ravel() for _, d in parts])
        rows = np.ascontiguousarray(rows, np.int32)
        diff = np.ascontiguousarray(diff, np.int32)
        cap = 4 * rows.size + 4096
        out = np.empty(cap, np.uint8)
        counts = np.zeros(2, np.int64)
        st = self.states[si]
        n = self.lib.ref_rac_slice(
            self.one.ctypes.data, self.zero.ctypes.data, keybit,
            hdr.ctypes.data, len(hdr), rows.ctypes.data, diff.ctypes.data,
            rows.size, st.ctypes.data, out.ctypes.data, cap,
            counts.ctypes.data)
        if n > cap:
            raise RuntimeError(f"slice {si}: {n} bytes past the buffer")
        data = out[:n].tobytes() + int(n).to_bytes(3, "big") + b"\x00"
        return data + crc32_ieee(data).to_bytes(4, "little"), counts


def packets(config: dict, pool: list) -> tuple:
    """The reference's packets of a configuration's session over ``pool``
    in order (key frames every ``config["gop"]``), and its work counts a
    frame: what the harness compares the window's packets with."""
    c = config
    bits, hs, vs = pix_fmt_layout(c["pix_fmt"])
    if c["level"] != 3 or not c["slicecrc"]:
        raise ValueError("the reference codes FFV1 version 3 with slice "
                         "CRCs")
    if c["coder"] != 1:
        raise ValueError(
            f"coder {c['coder']} at {bits} bits: the reference codes the "
            "range coder with the custom table (-coder 1); FFmpeg codes "
            "Golomb-Rice only up to 8 bits and would switch to the range "
            "coder")
    ref = RefHBDEncoder(c["width"], c["height"], c["slices"], c["gop"],
                        c["context"], bits, hs, vs)
    return ref.encode_all(pool), ref.work
