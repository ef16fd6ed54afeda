"""A plain FFV1 version 3 encoder, the yardstick of the benchmark's cells.

It covers what the configurations state: 8-bit YUV 4:2:0, context model
0 or 1 (``-context``), ``-coder 1`` (range coder, custom state table) or
``-coder 0`` (Golomb-Rice), slices on FFmpeg's grid, slice CRCs, key
frames every ``gop`` frames with the contexts carried across the frames
between them.
The packets are FFmpeg's byte for byte (RFC 9043; ffv1enc.c).

NumPy computes each slice's prediction, contexts and residuals, the slice
headers, the trailers and the CRC.  The two adaptive coders are serial
(each binary decision or Rice code depends on the one before), so they run
in ``coder.c`` (a 1080p frame holds ~14 million range-coder decisions,
some seconds a frame stepped from Python).  Nothing here imports or calls
the program under test.
"""

from __future__ import annotations

import binascii
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import build
from .tables import QUANT5, QUANT11, VER2_STATE, build_rac_states, zero_state

BITS = 8
PLANE_CLASSES = 2                      # luma, chroma
MAX_SLICES = 1024
# each context model's quantisers of L - LT, LT - T, T - RT, LL - L, TT - T
# (ffv1enc.c's quant_tables[0] and [1] for 8 bits), and its folded count
QUANT = {0: [QUANT11, 11 * QUANT11, 121 * QUANT11],
         1: [QUANT11, 11 * QUANT11, 121 * QUANT5, 605 * QUANT5,
             3025 * QUANT5]}
QUANT = {m: [q.astype(np.int16) for q in qs] for m, qs in QUANT.items()}
CONTEXTS = {0: (11 * 11 * 11 + 1) // 2, 1: (11 * 11 * 5 * 5 * 5 + 1) // 2}
_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def crc32_ieee(data: bytes) -> int:
    """av_crc(AV_CRC_32_IEEE, 0, data): the MSB-first CRC-32 of polynomial
    0x04C11DB7 with no initial or final XOR, as the integer whose
    little-endian bytes FFmpeg appends.  zlib runs the bit-reflected CRC,
    so the bytes go in bit-reversed and the result comes out reversed."""
    rev = _REV8[np.frombuffer(data, np.uint8)].tobytes()
    raw = binascii.crc32(rev, 0xFFFFFFFF) ^ 0xFFFFFFFF
    msb = int(f"{raw:032b}"[::-1], 2)
    return int.from_bytes(msb.to_bytes(4, "big"), "little")


def slice_grid(width: int, height: int, slices: int) -> tuple:
    """ffv1enc.c's search for the (columns, rows) of ``slices`` slices of a
    4:2:0 8-bit frame with three planes."""
    max_h, max_v = (width + 1) >> 1, (height + 1) >> 1
    num_v = min(2 if (width > 352 or height > 288) else 1, max_v)
    while num_v < 32:
        for num_h in range(num_v, 2 * num_v):
            maxw = (width + num_h - 1) // num_h
            maxh = (height + num_v - 1) // num_v
            if (num_h <= max_h and num_v <= max_v
                    and maxw * maxh * (BITS + 1) * 3 <= 8 << 24
                    and num_h * num_v == slices and slices <= MAX_SLICES):
                return num_h, num_v
        num_v += 1
    raise ValueError(f"no slice grid of {slices} slices at {width}x{height}")


def slice_rects(width: int, height: int, num_h: int, num_v: int) -> list:
    """Each slice's (x, y, w, h), row by row, its edges at width * sx //
    num_h and height * sy // num_v (ffv1.c)."""
    rects = []
    for i in range(num_h * num_v):
        x0, x1 = (width * (i % num_h + k) // num_h for k in (0, 1))
        y0, y1 = (height * (i // num_h + k) // num_v for k in (0, 1))
        rects.append((x0, y0, x1 - x0, y1 - y0))
    return rects


def predict_contexts(p: np.ndarray, model: int = 0) -> tuple:
    """One slice's plane (h, w) -> (context, residual) int32 (h, w), each
    context folded to >= 0 with its residual's sign, the residual folded
    to 8 bits (ffv1enc_template.c:encode_line, ffv1.h:get_context).  Rows
    above the slice are 0; the left neighbour of column 0 is the sample
    above it, the top-left the sample two rows up; the top-right of the
    last column repeats the sample above it; model 1's second left (LL)
    of column 0 is 0, of column 1 the sample above column 0, and its
    second top (TT) is 0 in the first two rows (ffv1enc.c:encode_plane's
    zeroed ring of rows and its guard samples)."""
    p = p.astype(np.int16)
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
    # int16 throughout: samples 0..255, gradients within +-510, contexts
    # within +-7562
    q = QUANT[model]
    ctx = q[0].take((l - lt).view(np.uint16) & 0xFF)
    ctx += q[1].take((lt - t).view(np.uint16) & 0xFF)
    ctx += q[2].take((t - rt).view(np.uint16) & 0xFF)
    if model == 1:
        ll = np.zeros_like(p)
        ll[:, 2:] = p[:, :-2]
        ll[:, 1] = t[:, 0]
        tt = np.zeros_like(p)
        tt[2:] = p[:-2]
        ctx += q[3].take((ll - l).view(np.uint16) & 0xFF)
        ctx += q[4].take((tt - t).view(np.uint16) & 0xFF)
    sign = np.where(ctx < 0, -1, 1).astype(np.int16)
    ctx *= sign
    diff = (p - pred) * sign
    diff = ((diff + 128) & 0xFF) - 128
    return ctx.astype(np.int32), diff.astype(np.int32)


class RefFFV1Encoder:
    """An encoder session: ``encode(planes)`` codes the next frame, a key
    frame every ``gop`` frames (gop 1: every frame), with context model
    ``context``.  ``planes`` are the 8-bit Y, U, V arrays of a 4:2:0
    frame."""

    def __init__(self, width: int, height: int, slices: int, coder: int,
                 gop: int, context: int = 0, threads: int = 8):
        if coder not in (0, 1):
            raise ValueError("coder 0 (Golomb-Rice) or 1 (range, custom "
                             "table)")
        if context not in QUANT:
            raise ValueError("context model 0 or 1")
        self.w, self.h, self.gop = width, height, gop
        self.model, self.contexts = context, CONTEXTS[context]
        self.rice = coder == 0
        num_h, num_v = slice_grid(width, height, slices)
        self.num_h, self.num_v = num_h, num_v
        self.rects = slice_rects(width, height, num_h, num_v)
        one = VER2_STATE if coder == 1 else build_rac_states()
        self.one = np.ascontiguousarray(one, np.uint8)
        self.zero = zero_state(self.one, default=coder != 1)
        n = len(self.rects)
        rows = PLANE_CLASSES * self.contexts
        self.states = np.full((n, rows, 32), 128, np.uint8)
        self.vlc = np.zeros((n, rows, 4), np.int32)
        self.threads = threads
        self.picture_number = 0
        self.work = []     # a dict of work counts a frame coded
        self.lib = build.lib()

    def _header(self, rect) -> np.ndarray:
        """encode_slice_header (version 3): the slice's grid position and
        size, each plane class's quant table (the context model), picture
        structure 3
        (progressive) and the aspect ratio 0:1."""
        x, y, w, h = rect
        return np.array([(x + 1) * self.num_h // self.w,
                         (y + 1) * self.num_v // self.h,
                         (w + 1) * self.num_h // self.w - 1,
                         (h + 1) * self.num_v // self.h - 1,
                         self.model, self.model, 3, 0, 1], np.int32)

    def _reset(self, si: int):
        """ff_ffv1_clear_slice_state."""
        self.states[si] = 128
        self.vlc[si] = (0, 4, 0, 1)    # drift, error_sum, bias, count

    def _slice(self, si: int, planes, keyframe: bool) -> tuple:
        """Slice ``si``'s bytes, trailers included, and its counts."""
        x, y, w, h = self.rects[si]
        cx, cy, cw, ch = x >> 1, y >> 1, -(-w >> 1), -(-h >> 1)
        crops = [(planes[0][y:y + h, x:x + w], 0),
                 (planes[1][cy:cy + ch, cx:cx + cw], 1),
                 (planes[2][cy:cy + ch, cx:cx + cw], 1)]
        if keyframe:
            self._reset(si)
        keybit = int(keyframe) if si == 0 else -1
        hdr = self._header(self.rects[si])
        parts = [predict_contexts(c, self.model) for c, _ in crops]
        ctx = np.concatenate([c.ravel() for c, _ in parts])
        diff = np.concatenate([d.ravel() for _, d in parts])
        cap = 4 * ctx.size + 4096
        out = np.empty(cap, np.uint8)
        counts = np.zeros(2, np.int64)
        if self.rice:
            pw = np.array([c.shape[1] for c, _ in crops], np.int32)
            ph = np.array([c.shape[0] for c, _ in crops], np.int32)
            poff = np.concatenate([[0], np.cumsum(pw * ph)[:-1]]).astype(
                np.int64)
            prow = np.array([k * self.contexts for _, k in crops], np.int32)
            st = self.vlc[si]
            n = self.lib.ref_rice_slice(
                self.one.ctypes.data, self.zero.ctypes.data, keybit,
                hdr.ctypes.data, len(hdr), 3, pw.ctypes.data, ph.ctypes.data,
                poff.ctypes.data, prow.ctypes.data, ctx.ctypes.data,
                diff.ctypes.data, BITS, st.ctypes.data, out.ctypes.data, cap,
                counts.ctypes.data)
        else:
            rows = ctx + np.concatenate(
                [np.full(c.size, k * self.contexts, np.int32)
                 for (c, k) in crops]).astype(np.int32)
            st = self.states[si]
            n = self.lib.ref_rac_slice(
                self.one.ctypes.data, self.zero.ctypes.data, keybit,
                hdr.ctypes.data, len(hdr), rows.ctypes.data,
                diff.ctypes.data, ctx.size, st.ctypes.data, out.ctypes.data,
                cap, counts.ctypes.data)
        if n > cap:
            raise RuntimeError(f"slice {si}: {n} bytes past the buffer")
        data = out[:n].tobytes() + int(n).to_bytes(3, "big") + b"\x00"
        return data + crc32_ieee(data).to_bytes(4, "little"), counts

    def encode(self, planes, pool=None) -> bytes:
        """The next frame's packet; its work counts go to ``work``."""
        keyframe = self.gop <= 1 or self.picture_number % self.gop == 0
        self.picture_number += 1
        planes = [np.asarray(p) for p in planes]
        idx = range(len(self.rects))
        if pool is None:
            parts = [self._slice(si, planes, keyframe) for si in idx]
        else:
            parts = list(pool.map(
                lambda si: self._slice(si, planes, keyframe), idx))
        pkt = b"".join(d for d, _ in parts)
        c = np.sum([c for _, c in parts], axis=0)
        work = {"samples": sum(p.size for p in planes),
                "packet_bytes": len(pkt),
                "contexts": len(self.rects) * PLANE_CLASSES * self.contexts}
        if self.rice:
            work.update(codes=int(c[0]), runs=int(c[1]))
        else:
            work["decisions"] = int(c[0])
        self.work.append(work)
        return pkt

    def encode_all(self, frames) -> list:
        """Code ``frames`` in order, the slices of a frame on threads."""
        with ThreadPoolExecutor(self.threads) as pool:
            return [self.encode(f, pool) for f in frames]


def packets(config: dict, pool: list) -> tuple:
    """The reference's packets of a configuration's session over ``pool``
    in order (key frames every ``config["gop"]``), and its work counts a
    frame: what the harness compares the window's packets with."""
    c = config
    if c["pix_fmt"] != "yuv420p" or c["level"] != 3 or not c["slicecrc"]:
        raise ValueError("the reference codes FFV1 version 3 yuv420p with "
                         "slice CRCs")
    ref = RefFFV1Encoder(c["width"], c["height"], c["slices"], c["coder"],
                         c["gop"], c["context"])
    return ref.encode_all(pool), ref.work
