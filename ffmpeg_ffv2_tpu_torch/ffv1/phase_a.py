"""Phase A of the device FFV1 encoder: per-pixel contexts and residuals.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/tpu.py:34-165`` (``_wrap16``,
``_med3``, ``neighbours``, ``quant_lut``, ``build_quant_luts``,
``_apply_quant``, ``plane_context_diff``, ``lut_for``) and of the YUV
branches of ``ffmpeg_ffv2_tpu/ffv1/device_coder.py:DeviceFFV1Encoder.
_phase_a`` and ``_phase_a_rice`` (``phase_a_planes`` keeps the per-plane
grids that the rice run planning needs).  Plain torch: the encoder side
has no sequential dependency (the predictor reads original samples), so a
plane is shifts, compares and a median, batched over the slices of a
frame.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import FFV1Params


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
    LT = torch.cat([up2_col0, T[..., :, :-1]], dim=-1)
    # RT: s[y-1, x+1]; at x=w-1 the guard duplicates T
    RT = torch.cat([T[..., :, 1:], T[..., :, -1:]], dim=-1)
    # LL: s[y, x-2]; x==1 -> guard (-1) == T[y,0]; x==0 -> guard (-2) == 0
    LL = torch.cat([z(h, 1), T[..., :, :1], s[..., :, :-2]], dim=-1)
    # TT: s[y-2, x]; rows 0,1 -> 0
    TT = torch.cat([z(2, w), s[..., :-2, :]], dim=-2)
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


def plane_context_diff(s: torch.Tensor, qt, bits: int, five: bool):
    """(context >= 0, folded signed diff) int32 for planes (..., h, w).

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


def phase_a_planes(planes, crop_plan, qt, bits: int, five: bool):
    """YUV/gray planes (int32 tensors, one per coded plane) -> per-plane
    lists of (n_slices, h, w) int32 context and diff grids, one slice
    crop per row of the batch."""
    ctxs, diffs = [], []
    for plane, prects in zip(planes, crop_plan):
        crops = torch.stack([plane[y:y + h, x:x + w]
                             for (x, y, w, h) in prects])
        ctx, diff = plane_context_diff(_wrap16(crops.to(torch.int32)), qt,
                                       bits, five)
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
