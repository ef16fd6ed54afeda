"""Phase A of the device FFV1 encoder: per-pixel contexts and residuals.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/tpu.py:34-165`` (``_wrap16``,
``_med3``, ``neighbours``, ``quant_lut``, ``build_quant_luts``,
``_apply_quant``, ``plane_context_diff``, ``lut_for``) and of the YUV
and RGB branches of ``ffmpeg_ffv2_tpu/ffv1/device_coder.py:
DeviceFFV1Encoder._phase_a``, ``_phase_a_rct`` and ``_phase_a_rice``
(``phase_a_planes`` and ``phase_a_rgb_planes`` keep the per-plane grids
that the rice run planning needs), and of ``_rct_cost_parts`` (the v4
per-slice RCT search, ``rct_costs``).  The encoder side has no sequential
dependency (the predictor reads original samples), so a plane is shifts,
compares and a median.  On the card one launch of the phase_a kernel
(``csrc/phase_a.cu``) computes every crop that a ``PhaseAPlan`` lists and
writes the streams in the layout the next stage reads (``run``; a stack
through ``plane_context_diff``); the plain torch functions here, batched
over the slices of a frame, are its plain version and run on the CPU.

RGB codes the reversible colour transform of its planes at depth bits + 1
(ffv1enc_template.c:175-198): g' = g + ((b - g) * by + (r - g) * ry >> 2),
b' = b - g + offset, r' = r - g + offset, with the fixed by = ry = 1 up to
version 3 and a per-slice pair from the cost search in version 4.  Its
stream interleaves the planes line by line.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build
from .params import FFV1Params
from .rct import RCT_Y_COEFF

_K = _build.KERNELS["phase_a"]


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _med3(a, b, c):
    # mid_pred(L, L+T-LT, T)
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    return torch.minimum(torch.maximum(mn, c), mx)


def neighbours(s: torch.Tensor) -> dict:
    """Predictor taps of int32 planes ``s`` (..., h, w) with FFV1 border
    semantics: dict of L, T, LT, RT, LL, TT, each shaped like ``s``."""
    h, w = s.shape[-2:]
    lead = s.shape[:-2]
    z = lambda *sh: torch.zeros(lead + sh, dtype=s.dtype, device=s.device)
    T = torch.cat([z(1, w), s[..., :-1, :]], dim=-2)
    # L: s[y, x-1]; at x=0 the guard is prev[0] == T at x=0
    L = torch.cat([T[..., :, :1], s[..., :, :-1]], dim=-1)
    # LT: s[y-1, x-1]; at x=0 the guard carries s[y-2, 0]
    up2_col0 = torch.cat([z(2, 1), s[..., :-2, :1]], dim=-2)
    LT = torch.cat([up2_col0[..., :h, :], T[..., :, :-1]], dim=-1)
    # RT: s[y-1, x+1]; at x=w-1 the guard duplicates T
    RT = torch.cat([T[..., :, 1:], T[..., :, -1:]], dim=-1)
    # LL: s[y, x-2]; x==1 -> guard (-1) == T[y,0]; x==0 -> guard (-2) == 0
    LL = torch.cat([z(h, 1), T[..., :, :1], s[..., :, :-2]], dim=-1)[..., :w]
    # TT: s[y-2, x]; rows 0,1 -> 0
    TT = torch.cat([z(2, w), s[..., :-2, :]], dim=-2)[..., :h, :]
    return {"L": L, "T": T, "LT": LT, "RT": RT, "LL": LL, "TT": TT}


def quant_lut(qt_row: np.ndarray):
    """One 256-entry quant table as (base, thresholds, deltas) over the
    signed 8-bit difference: qt(d8) = base + sum_t delta_t * (d8 >= t)."""
    row = np.asarray(qt_row, dtype=np.int64)
    signed = np.concatenate([row[128:], row[:128]])  # d8=-128..-1, 0..127
    base = int(signed[0])
    deltas = np.diff(signed)
    nz = np.nonzero(deltas)[0]
    thr = (nz + 1 - 128).astype(np.int32)
    dlt = deltas[nz].astype(np.int32)
    return base, thr, dlt


def build_quant_luts(qt: np.ndarray):
    """LUTs for all 5 rows, padded to a common threshold count:
    (bases int32[5], thr int32[5, T], dlt int32[5, T])."""
    rows = [quant_lut(qt[k]) for k in range(5)]
    T = max(len(r[1]) for r in rows) or 1
    bases = np.array([r[0] for r in rows], dtype=np.int32)
    thr = np.zeros((5, T), dtype=np.int32)
    dlt = np.zeros((5, T), dtype=np.int32)
    for k, (b, t, d) in enumerate(rows):
        thr[k, :len(t)] = t
        dlt[k, :len(d)] = d
    return bases, thr, dlt


def lut_for(p: FFV1Params, qt_index: int):
    return build_quant_luts(p.quant_tables[qt_index])


def _apply_quant(d, bases, thr, dlt, k: int):
    """qt_k((d) & 0xFF as signed) via threshold compares."""
    d8 = ((d + 128) & 0xFF) - 128
    acc = torch.full_like(d, int(bases[k]))
    for t in range(thr.shape[1]):
        acc = acc + torch.where(d8 >= int(thr[k, t]), int(dlt[k, t]), 0)
    return acc


def plane_context_diff_plain(s: torch.Tensor, qt, bits: int, five: bool):
    """Plain version of the phase_a kernel: (context >= 0, folded signed
    diff) int32 for planes (..., h, w).

    ``qt``: (bases, thr, dlt) from build_quant_luts; ``five``: the
    5-input context model."""
    n = neighbours(s)
    L, T, LT, RT, LL, TT = (n["L"], n["T"], n["LT"], n["RT"], n["LL"],
                            n["TT"])
    bases, thr, dlt = qt
    ctx = (_apply_quant(L - LT, bases, thr, dlt, 0)
           + _apply_quant(LT - T, bases, thr, dlt, 1)
           + _apply_quant(T - RT, bases, thr, dlt, 2))
    if five:
        ctx = (ctx + _apply_quant(LL - L, bases, thr, dlt, 3)
               + _apply_quant(TT - T, bases, thr, dlt, 4))
    diff = s - _med3(L, L + T - LT, T)
    neg = ctx < 0
    ctx = torch.where(neg, -ctx, ctx)
    diff = torch.where(neg, -diff, diff)
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    diff = ((diff + half) & mask) - half
    return ctx.to(torch.int32), diff.to(torch.int32)


# -- the phase_a kernel (csrc/phase_a.cu) ------------------------------------

# its descriptor table: the five quantizer rows, then a job a (slice,
# plane) crop, then a block a tile of a job (job, tile); a job takes 8
# words, one spare, so the (job, tile) pairs stay 8-byte aligned
QT_WORDS = 5 * 256
JOB_WORDS = 8
TILE_W, TILE_H = 32, 64
MAX_PLANES = 4


def direct_quant_rows(qt) -> np.ndarray:
    """The five 256-entry quantizer rows that the kernel reads, int32
    (5, 256): entry [k, d & 0xFF] is ``_apply_quant``'s qt_k(d) of the
    threshold form (bases, thr, dlt)."""
    bases, thr, dlt = (np.asarray(a, np.int64) for a in qt)
    d8 = np.arange(256)
    d8 = np.where(d8 < 128, d8, d8 - 256)
    hits = d8[None, :, None] >= thr[:, None, :]
    return (bases[:, None] + (hits * dlt[:, None, :]).sum(-1)).astype(
        np.int32)


class PhaseAPlan:
    """What one launch of the phase_a kernel covers.  ``jobs``: one a
    (slice, plane) crop, (plane, x, y, w, h, output offset, output row
    pitch) in words; the launch writes sample (y', x') of a job's crop at
    offset + y' * pitch + x' of both outputs, (ctx, diff) int32 of
    ``out_shape``.  ``table`` is the descriptor table on ``device``, built
    once: the direct quantizer rows, the jobs (padded to JOB_WORDS), then
    a (job, tile) pair a block.  ``wrap``: the kernel wraps each sample to
    16 bits (``_wrap16``) as it reads it.  ``plain(planes)`` is the plain
    version of the same launch."""

    def __init__(self, jobs, qt, bits: int, five: bool, wrap: bool,
                 out_shape, plain, device):
        if not jobs:
            raise ValueError("phase_a: a plan needs at least one crop")
        if not 1 <= bits <= 30:
            raise ValueError(f"phase_a: depth {bits} outside 1..30")
        self.jobs = [tuple(int(v) for v in j) for j in jobs]
        self.n_planes = max(j[0] for j in self.jobs) + 1
        if self.n_planes > MAX_PLANES:
            raise ValueError(f"phase_a: {self.n_planes} planes, at most "
                             f"{MAX_PLANES}")
        # (rows, columns) of each plane that the jobs read
        self.extents = [
            (max(y + h for q, x, y, w, h, *_ in self.jobs if q == k),
             max(x + w for q, x, y, w, h, *_ in self.jobs if q == k))
            for k in range(self.n_planes)]
        self.bits, self.five, self.wrap = bits, bool(five), bool(wrap)
        self.out_shape = tuple(out_shape)
        self.plain = plain
        blocks = [(j, t) for j, (_, _, _, w, h, *_) in enumerate(self.jobs)
                  for t in range(-(-w // TILE_W) * -(-h // TILE_H))]
        self.n_blocks = len(blocks)
        words = np.zeros((len(self.jobs), JOB_WORDS), np.int32)
        words[:, :7] = self.jobs
        self.table = torch.as_tensor(np.concatenate([
            direct_quant_rows(qt).ravel(), words.ravel(),
            np.asarray(blocks, np.int32).ravel()]), device=device)

    def grids(self, stream) -> list:
        """Per-plane (S, h, w) views of a session's (S, npix) output
        stream, one slice a row (``yuv_plan``, ``rgb_plan``)."""
        S, npix = stream.shape
        out = []
        for k in range(self.n_planes):
            _, _, _, w, h, off, pitch = next(j for j in self.jobs
                                             if j[0] == k)
            out.append(stream.as_strided((S, h, w), (npix, pitch, 1),
                                         stream.storage_offset() + off))
        return out


def yuv_plan(crop_plan, qt, bits: int, five: bool, device) -> PhaseAPlan:
    """A session's YUV or gray frame, one plane tensor a coded plane, to
    the (S, npix) streams of ``phase_a``: a slice's whole planes
    concatenated in coding order.  Every slice crop of a plane has one
    shape (a session's slices, or a shape bank's)."""
    S = len(crop_plan[0])
    shapes = [prects[0][2:] for prects in crop_plan]
    sizes = [w * h for w, h in shapes]
    npix = sum(sizes)
    jobs = []
    for li, prects in enumerate(crop_plan):
        for si, (x, y, w, h) in enumerate(prects):
            if (w, h) != shapes[li]:
                raise ValueError(f"phase_a: plane {li} has crops of "
                                 f"{shapes[li]} and {(w, h)}")
            jobs.append((li, x, y, w, h, si * npix + sum(sizes[:li]), w))
    return PhaseAPlan(
        jobs, qt, bits, five, True, (S, npix),
        lambda planes: phase_a(planes, crop_plan, qt, bits, five), device)


def rgb_plan(S: int, h: int, w: int, n_planes: int, qt, bits: int,
             five: bool, device) -> PhaseAPlan:
    """The coded RGB planes (``rct_planes``, already wrapped where they
    wrap), each an (S, h, w) stack of slice crops handed over as an
    (S * h, w) plane, to the line-interleaved (S, h * w * n_planes)
    streams of ``phase_a_rgb``."""
    npix = h * w * n_planes
    jobs = [(k, 0, s * h, w, h, s * npix + k * w, w * n_planes)
            for s in range(S) for k in range(n_planes)]

    def plain(planes):
        grids = [plane_context_diff_plain(c.reshape(S, h, w), qt, bits, five)
                 for c in planes]
        return tuple(interleave_lines([g[i] for g in grids]) for i in (0, 1))

    return PhaseAPlan(jobs, qt, bits, five, False, (S, npix), plain, device)


@functools.lru_cache(maxsize=64)
def _stack_plan(n: int, h: int, w: int, rows: bytes, bits: int, five: bool,
                device) -> PhaseAPlan:
    """``plane_context_diff``'s plan of an (n, h, w) stack handed over as
    an (n * h, w) plane: grid i is crop i, written where it was read."""
    qt = build_quant_luts(np.frombuffer(rows, np.int32).reshape(5, 256))
    jobs = [(0, 0, i * h, w, h, i * h * w, w) for i in range(n)]
    return PhaseAPlan(
        jobs, qt, bits, five, False, (n, h, w),
        lambda planes: plane_context_diff_plain(planes[0].reshape(n, h, w),
                                                qt, bits, five), device)


def run(plan: PhaseAPlan, planes, out=None):
    """The phase_a kernel's wrapper: (ctx, diff) of ``plan`` on ``planes``
    (one int32 tensor a plane of the plan, read through its row stride),
    into the pair ``out`` where given.  CPU tensors take ``plan.plain``
    (counted in ``plain_calls``); CUDA tensors launch the kernel."""
    dev = planes[0].device
    if _K.plain_for(dev):
        ctx, diff = plan.plain(planes)
        if out is None:
            return ctx, diff
        out[0].copy_(ctx.reshape(out[0].shape))
        out[1].copy_(diff.reshape(out[1].shape))
        return out
    if len(planes) != plan.n_planes:
        raise ValueError(f"{_K.name}: {len(planes)} planes for a plan of "
                         f"{plan.n_planes}")
    if plan.table.device != dev:
        raise ValueError(f"{_K.name}: the plan's table is on "
                         f"{plan.table.device}, the planes on {dev}")
    ptrs, pitches = [], []
    for k, (pl, (rows, cols)) in enumerate(zip(planes, plan.extents)):
        if (pl.dtype != torch.int32 or pl.device != dev or pl.dim() != 2
                or pl.shape[0] < rows or pl.shape[1] < cols
                or (pl.stride(1) != 1 and pl.shape[1] > 1)):
            raise ValueError(
                f"{_K.name}: plane {k} must be a 2-D int32 tensor on {dev} "
                f"of at least {rows}x{cols} with unit column stride, got "
                f"{pl.dtype} {tuple(pl.shape)} strides {pl.stride()} on "
                f"{pl.device}")
        ptrs.append(pl.data_ptr())
        pitches.append(pl.stride(0))
    pad = MAX_PLANES - len(ptrs)
    if out is None:
        out = (torch.empty(plan.out_shape, dtype=torch.int32, device=dev),
               torch.empty(plan.out_shape, dtype=torch.int32, device=dev))
    _K.check("ctx", out[0], plan.out_shape, dev)
    _K.check("diff", out[1], plan.out_shape, dev)
    _K.launch(plan.table.data_ptr(), len(plan.jobs), plan.n_blocks,
              *ptrs, *[ptrs[0]] * pad, *pitches, *[0] * pad, plan.bits,
              int(plan.five), int(plan.wrap), out[0].data_ptr(),
              out[1].data_ptr(), _build.stream_handle(out[0]))
    return out


def plane_context_diff(s: torch.Tensor, qt, bits: int, five: bool):
    """(context >= 0, folded signed diff) int32 for int32 planes (..., h,
    w), already wrapped where they wrap: one ``run`` of the stack, its
    grids as the crops of one launch on the card.  ``qt``: (bases, thr,
    dlt) from build_quant_luts; ``five``: the 5-input context model."""
    h, w = s.shape[-2:]
    n = math.prod(s.shape[:-2])
    plan = _stack_plan(n, h, w, direct_quant_rows(qt).tobytes(), bits,
                       bool(five), s.device)
    ctx, diff = run(plan, [s.reshape(n * h, w)])
    return ctx.view(s.shape), diff.view(s.shape)


def phase_a_planes(planes, crop_plan, qt, bits: int, five: bool):
    """YUV/gray planes (int32 tensors, one per coded plane) -> per-plane
    lists of (n_slices, h, w) int32 context and diff grids, one slice
    crop per row of the batch."""
    ctxs, diffs = [], []
    for plane, prects in zip(planes, crop_plan):
        crops = torch.stack([plane[y:y + h, x:x + w]
                             for (x, y, w, h) in prects])
        ctx, diff = plane_context_diff_plain(_wrap16(crops.to(torch.int32)),
                                             qt, bits, five)
        ctxs.append(ctx)
        diffs.append(diff)
    return ctxs, diffs


def phase_a(planes, crop_plan, qt, bits: int, five: bool):
    """YUV/gray planes -> per-slice streams (ctx, diff) int32
    (n_slices, npix) in coding order: whole planes concatenated per
    slice."""
    ctxs, diffs = phase_a_planes(planes, crop_plan, qt, bits, five)
    S = len(crop_plan[0])
    return (torch.cat([c.reshape(S, -1) for c in ctxs], dim=1),
            torch.cat([d.reshape(S, -1) for d in diffs], dim=1))


def _crops(plane, rects):
    return torch.stack([plane[y:y + h, x:x + w]
                        for (x, y, w, h) in rects]).to(torch.int32)


def rct_planes(planes, rects, p: FFV1Params, by=None, ry=None):
    """RGB planes (g, b, r[, a] as given; int32 tensors) -> the coded
    planes' slice crops (n_slices, h, w): the RCT with the fixed by = ry =
    1, or the per-slice coefficients ``by``/``ry`` ((n_slices,) int32).
    Formats over 8 bits that are neither 32-bit nor transparent code their
    first two planes swapped; 32-bit samples (rgb48) are not wrapped to 16
    bits."""
    swap = not p.use32bit and not p.transparency and p.bits > 8
    order = ((1, 0, 2) if swap else (0, 1, 2)) + ((3,) if p.transparency
                                                  else ())
    crops = [_crops(planes[k], rects) for k in order]
    g, b, r = crops[:3]
    offset = 1 << max(p.bits, 8)
    b2 = b - g
    r2 = r - g
    if by is None:
        g2 = g + ((b2 + r2) >> 2)
    else:
        g2 = g + ((b2 * by[:, None, None] + r2 * ry[:, None, None]) >> 2)
    coded = [g2, b2 + offset, r2 + offset] + crops[3:]
    return coded if p.use32bit else [_wrap16(c) for c in coded]


def phase_a_rgb_planes(planes, rects, p: FFV1Params, qt, code_bits: int,
                       five: bool, by=None, ry=None):
    """RGB planes -> per-plane lists of (n_slices, h, w) int32 context and
    diff grids of the coded planes (``rct_planes``)."""
    ctxs, diffs = [], []
    for c in rct_planes(planes, rects, p, by, ry):
        ctx, diff = plane_context_diff(c, qt, code_bits, five)
        ctxs.append(ctx)
        diffs.append(diff)
    return ctxs, diffs


def interleave_lines(grids):
    """Per-plane (n_slices, h, w) grids -> (n_slices, h * w * planes)
    streams whose planes alternate line by line."""
    return torch.stack(grids, dim=2).reshape(grids[0].shape[0], -1)


def phase_a_rgb(planes, rects, p: FFV1Params, qt, code_bits: int,
                five: bool, by=None, ry=None):
    """RGB planes -> per-slice streams (ctx, diff) int32 (n_slices, npix)
    with the planes interleaved per line."""
    ctxs, diffs = phase_a_rgb_planes(planes, rects, p, qt, code_bits, five,
                                     by, ry)
    return interleave_lines(ctxs), interleave_lines(diffs)


def rct_costs(planes, rects):
    """The v4 RCT search's cost of each candidate on each slice: (n_slices,
    15) int64 sums of |bg + ((br * ry + bb * by) >> 2)| over the second
    differences of the g, b, r planes (the first three as given), in the
    order of ``rct.RCT_Y_COEFF`` (choose_rct_params, ffv1enc.c:963-1043).
    int64 sums are exact where the reference sums in uint64."""
    g, b, r = (_crops(planes[k], rects).long() for k in (0, 1, 2))

    def hdiff(x):
        return torch.cat([x[:, :, :1], x[:, :, 1:] - x[:, :, :-1]], dim=2)

    ag, ab, ar = hdiff(g), hdiff(b), hdiff(r)
    bg = ag[:, 1:, 1:] - ag[:, :-1, 1:]
    bb = ab[:, 1:, 1:] - ab[:, :-1, 1:] - bg
    br = ar[:, 1:, 1:] - ar[:, :-1, 1:] - bg
    return torch.stack([(bg + ((br * ry + bb * by) >> 2)).abs().sum((1, 2))
                        for (ry, by) in RCT_Y_COEFF], dim=1)


def pick_rct(costs) -> list:
    """(n_slices, 15) candidate costs -> [(by, ry)] per slice: the first
    strict minimum, as the reference's ``<`` scan picks it."""
    out = []
    for stats in costs.cpu().tolist():
        best = 0
        for i in range(1, len(RCT_Y_COEFF)):
            if stats[i] < stats[best]:
                best = i
        ry, by = RCT_Y_COEFF[best]
        out.append((by, ry))
    return out
