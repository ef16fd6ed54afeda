"""Copy of ``ffmpeg_ffv2_tpu/ffv2/dsp.py``.

FFV2 DSP: sample<->coefficient conversion, zigzag scan, band partitions,
lapped biorthogonal pre/post filters, and the block transforms.

Behavioral counterpart of the reference's FFV2DSP (libavcodec/ffv2.c),
redesigned TPU-first:

* transforms are exact fixed-point **matrix** DCT-II / DST-IV (int32,
  deterministic rounding, B=11 fraction bits) instead of scalar lifting —
  batched blocks run as one dot on the MXU/VPU and the inverse is the
  transpose with the same rounding rule.  The reference's lifting kernels
  (ffv2.c:od_bin_fdct*) exist for multiplierless scalar CPUs; a systolic
  array wants matmuls.  Consequence: our FFV2 bitstreams use this transform
  basis (the reference has no FFV2 golden vectors or interop surface; see
  SURVEY.md section 7 step 7).
* the lapped filters keep the reference's exact integer lifting semantics
  (ffv2.c:lap_filt_params_* / LAP_FILTER_PAIR) — they define the SB-border
  halo exchange and are cheap elementwise chains, vectorized across the
  perpendicular axis.

Everything operates on Q12-centered int32 coefficient planes:
value = (sample << (12 - depth)) - 2048  (ffv2.c:26-60).
"""

from __future__ import annotations

import functools

import numpy as np

from .tables import ZIGZAG_LEVELS, BAND_LEVELS

SB_SIZE = 64
TX_SIZES = (4, 8, 16, 32, 64)
TX_DCT, TX_DST = 0, 1

_FRAC_BITS = 11
_ROUND = 1 << (_FRAC_BITS - 1)


def _wrap32(x):
    """Reduce to int32 wraparound semantics so the int64 numpy reference
    and the int32 TPU matmuls agree bit-for-bit on any input, including
    hostile streams that overflow (mod-2^32 arithmetic is a homomorphism,
    so wrapping after an int64 accumulation equals int32 accumulation)."""
    return ((np.asarray(x, dtype=np.int64) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


# ---------------------------------------------------------------------------
# sample <-> Q12 coefficient planes
# ---------------------------------------------------------------------------

def ref_to_coeff(plane: np.ndarray, depth: int) -> np.ndarray:
    return ((plane.astype(np.int32) << (12 - depth)) - 2048)


def coeff_to_ref(coeff: np.ndarray, depth: int) -> np.ndarray:
    return (coeff.astype(np.int32) + 2048) >> (12 - depth)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    x = np.arange(n)[None, :].astype(np.float64)
    m = np.cos(np.pi * (2 * x + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] *= np.sqrt(0.5)
    return np.round(m * (1 << _FRAC_BITS)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def dst_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    x = np.arange(n)[None, :].astype(np.float64)
    m = np.sin(np.pi * (2 * x + 1) * (2 * k + 1) / (4 * n)) * np.sqrt(2.0 / n)
    return np.round(m * (1 << _FRAC_BITS)).astype(np.int32)


def _basis(n: int, tx_type: int) -> np.ndarray:
    return dct_matrix(n) if tx_type == TX_DCT else dst_matrix(n)


def fwd_tx_2d(block: np.ndarray, tx_type: int = TX_DCT) -> np.ndarray:
    """Exact fixed-point 2-D separable forward transform of one [n, n]
    int32 block (row pass then column pass, each with >> rounding)."""
    n = block.shape[0]
    m = _basis(n, tx_type).astype(np.int64)
    rows = (_wrap32(block.astype(np.int64) @ m.T) + _ROUND) >> _FRAC_BITS
    cols = (_wrap32(m @ rows) + _ROUND) >> _FRAC_BITS
    return cols.astype(np.int32)


def inv_tx_2d(coeff: np.ndarray, tx_type: int = TX_DCT) -> np.ndarray:
    n = coeff.shape[0]
    m = _basis(n, tx_type).astype(np.int64)
    cols = (_wrap32(m.T @ coeff.astype(np.int64)) + _ROUND) >> _FRAC_BITS
    rows = (_wrap32(cols @ m) + _ROUND) >> _FRAC_BITS
    return rows.astype(np.int32)


# ---------------------------------------------------------------------------
# zigzag scan (frequency order) and band partitions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def scan_order(n: int) -> np.ndarray:
    """Flat (y*n + x) scan positions for an n*n block, reference-exact
    (ffv2.c:raster_to_coding walks levels 4x4, 8x8, ... concatenating each
    level's zigzag list).  Quirk kept for wire compatibility: the 4x4
    layout (zigzags.h:layout_freq_4x4) declares zigzag_len 16 but lists
    only 15 coordinates — C zero-fills the 16th to {0,0}, so the true DC
    lands at scan index 15 and the wire "DC" (coding index 0) is the
    coefficient at (0,1)."""
    order = []
    for lvl in TX_SIZES:
        if lvl > n:
            break
        zz = ZIGZAG_LEVELS[lvl]
        order.extend(int(y) * n + int(x) for x, y in zz)
        if lvl == 4:
            order.append(0)  # zero-filled 16th entry -> {0, 0}
    out = np.array(order, dtype=np.int64)
    assert len(out) == n * n, (n, len(out))
    return out


@functools.lru_cache(maxsize=None)
def band_starts(n: int):
    """AC band boundaries for an n*n block (ffv2_num_bands): offsets into
    the post-DC scan stream.  The reference terminates with n*n (not
    n*n-1), so the last band spans one phantom position past the real
    coefficients — ffv2enc/ffv2dec read/write one element out of bounds
    there; we code the position (parse compatibility) but treat it as 0 on
    encode and discard it on decode."""
    starts = []
    for lvl in TX_SIZES:
        if lvl > n:
            break
        starts.extend(BAND_LEVELS[lvl])
    starts.append(n * n)
    return starts


def raster_to_coding(block: np.ndarray) -> np.ndarray:
    n = block.shape[0]
    return block.reshape(-1)[scan_order(n)]


def coding_to_raster(stream: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n * n, dtype=stream.dtype)
    out[scan_order(n)] = stream
    return out.reshape(n, n)


# ---------------------------------------------------------------------------
# lapped biorthogonal pre/post filters (exact integer lifting,
# ffv2.c:lap_filt_params_* and LAP_FILTER_PAIR)
# ---------------------------------------------------------------------------

LAP_PARAMS = {
    4: np.array([85, 75, -15, 33], dtype=np.int64),
    8: np.array([93, 72, 73, 78, -28, -23, -10, 50, 37, 23], dtype=np.int64),
    16: np.array([94, 71, 68, 68, 68, 69, 70, 73, -32, -37, -36, -32, -26,
                  -17, -7, 56, 49, 45, 40, 34, 26, 15], dtype=np.int64),
    32: np.array([91, 70, 68, 67, 67, 67, 67, 66, 66, 67, 67, 66, 67, 67,
                  67, 70, -32, -41, -42, -41, -40, -38, -36, -34, -32, -29,
                  -24, -19, -14, -9, -5, 58, 52, 50, 48, 45, 43, 40, 38, 35,
                  32, 29, 24, 18, 13, 8], dtype=np.int64),
    64: np.array([91, 91, 70, 70, 68, 68, 67, 67, 67, 67, 67, 67, 67, 67,
                  66, 66, 66, 66, 67, 67, 67, 67, 66, 66, 67, 67, 67, 67,
                  67, 67, 70, 70, -32, -32, -41, -41, -42, -42, -41, -41,
                  -40, -40, -38, -38, -36, -36, -34, -34, -32, -32, -29,
                  -29, -24, -24, -19, -19, -14, -14, -9, -9, -5, -5, 58, 58,
                  52, 52, 50, 50, 48, 48, 45, 45, 43, 43, 40, 40, 38, 38,
                  35, 35, 32, 32, 29, 29, 24, 24, 18, 18, 13, 13, 8, 8, 2,
                  2], dtype=np.int64),
}


def _incr_pos(t: np.ndarray) -> np.ndarray:
    """t += (t > 0) via the reference's branchless form."""
    return t + ((t > 0).astype(np.int64))


def lap_prefilter(x: np.ndarray, size: int) -> np.ndarray:
    """Forward lapped filter over axis -1 of ``x[..., size]``; vectorized
    over leading axes.  Mirrors fwd_lap_filter_SIZE exactly."""
    p = LAP_PARAMS[size]
    h = size // 2
    x = x.astype(np.int64)
    t = np.empty_like(x)
    # butterflies
    t[..., size - 1 - np.arange(h)] = x[..., :h] - x[..., size - 1 - np.arange(h)]
    for i in range(h):
        t[..., h - 1 - i] = x[..., h - 1 - i] - (t[..., h + i] >> 1)
    # scaling of the high half
    for i in range(h, size):
        v = (t[..., i] * p[i - h]) >> 6
        t[..., i] = _incr_pos(v)
    # lifting chain
    for i in range(size - 1, h, -1):
        t[..., i] = t[..., i] + ((t[..., i - 1] * p[i - 1] + 32) >> 6)
        t[..., i - 1] = t[..., i - 1] + ((t[..., i] * p[i + h - 2] + 32) >> 6)
    y = np.empty_like(x)
    for i in range(h):
        t[..., i] = t[..., i] + (t[..., size - 1 - i] >> 1)
        y[..., i] = t[..., i]
    for i in range(h):
        y[..., h + i] = t[..., h - 1 - i] - t[..., h + i]
    return y


def _c_div(a: np.ndarray, b: int) -> np.ndarray:
    """C-style truncating division by a positive/negative constant."""
    q = np.abs(a) // abs(b)
    return np.where((a >= 0) == (b >= 0), q, -q)


def lap_postfilter(x: np.ndarray, size: int) -> np.ndarray:
    """Inverse lapped filter (inv_lap_filter_SIZE), incl. the per-sample
    truncating divide of the reference."""
    p = LAP_PARAMS[size]
    h = size // 2
    x = x.astype(np.int64)
    t = np.empty_like(x)
    t[..., size - 1 - np.arange(h)] = x[..., :h] - x[..., size - 1 - np.arange(h)]
    for i in range(h):
        t[..., h - 1 - i] = x[..., h - 1 - i] - (t[..., h + i] >> 1)
    for i in range(h, size - 1):
        t[..., i] = t[..., i] - ((t[..., i + 1] * p[i + h - 1] + 32) >> 6)
        t[..., i + 1] = t[..., i + 1] - ((t[..., i] * p[i] + 32) >> 6)
    for i in range(size - 1, h - 1, -1):
        t[..., i] = _c_div(t[..., i] << 6, int(p[i - h]))
    out = np.empty_like(x)
    for i in range(h):
        t[..., i] = t[..., i] + (t[..., size - 1 - i] >> 1)
        out[..., i] = t[..., i]
    for i in range(h, size):
        out[..., i] = t[..., size - 1 - i] - t[..., i]
    return out


def lap_filter_frame_hor(plane: np.ndarray, sb: int, radius: int,
                         forward: bool) -> np.ndarray:
    """Apply the lapped filter across vertical SB boundaries (columns at
    multiples of ``sb``, skipping the frame edge), full height.  All
    boundary slabs are non-overlapping, so they batch into one vectorized
    filter call over a (n_boundaries*H, radius) stack."""
    out = plane.astype(np.int64).copy()
    h = radius // 2
    fn = lap_prefilter if forward else lap_postfilter
    xs = range(sb, plane.shape[1], sb)
    if not xs:
        return out
    slabs = np.stack([out[:, x0 - h:x0 + h] for x0 in xs])
    filt = fn(slabs.reshape(-1, radius), radius).reshape(slabs.shape)
    for i, x0 in enumerate(xs):
        out[:, x0 - h:x0 + h] = filt[i]
    return out


def lap_filter_frame_ver(plane: np.ndarray, sb: int, radius: int,
                         forward: bool) -> np.ndarray:
    out = plane.astype(np.int64).copy()
    h = radius // 2
    fn = lap_prefilter if forward else lap_postfilter
    ys = range(sb, plane.shape[0], sb)
    if not ys:
        return out
    slabs = np.stack([out[y0 - h:y0 + h, :].T for y0 in ys])
    filt = fn(slabs.reshape(-1, radius), radius).reshape(slabs.shape)
    for i, y0 in enumerate(ys):
        out[y0 - h:y0 + h, :] = filt[i].T
    return out
