"""FFV2's device front and back: the counterpart of
``ffmpeg_ffv2_tpu/ffv2/tpu.py``.

Everything between pixels and the Daala entropy coder runs here on tensors
on a CUDA device, or on the CPU where the caller passes ``device="cpu"``
(``device="cuda"`` with no card raises ``RuntimeError``): the Q12
conversion, the lapped pre- and postfilter across superblock boundaries
(K19, ``csrc/ffv2_lap.cu``), the block split, the 2-D transforms, the
zigzag gather, and the quantizer (K18, ``csrc/ffv2_quant.cu``: DC, PVQ
pulses and the exact split sums of each band's energy).  The public
functions keep the JAX module's names and contracts, numpy at their edge;
the ``*_t`` functions take and return tensors, and the sessions of
``ffv2/native.py`` call those.

Each kernel's wrapper launches it for a CUDA tensor and runs its plain
PyTorch version, beside it here, for a CPU tensor; nothing falls back.
The transforms are a plain matrix product, which the JAX package too
leaves to XLA outside any kernel: a float64 ``torch.matmul``, exact (see
``_tx_pass``).  All arithmetic is JAX's int32 with its wraparound; where
the numpy reference ``dsp`` differs on hostile input (the transforms'
rounding add, ``_c_div`` of INT_MIN), the port follows JAX.

Every function takes a ``mark`` hook (``metrics.TRACE``, the port's
stage recorder, by default), called after each stage with the stage's
name; ``chip_smoke.py`` passes one that records CUDA events.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from ..utils.metrics import TRACE
from . import dsp

LAP_RADIUS = 32                 # tpu.py: _jx_frame_* with radius 32
I64 = torch.int64


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ffv2: device='cuda' but torch sees no CUDA "
                           "device")
    return dev


def _up(a, device) -> torch.Tensor:
    """A numpy array (or array-like) -> an int32 tensor on ``device``."""
    return torch.as_tensor(np.array(a, dtype=np.int32),
                           device=_device(device))


def _w32(x):
    """int64 tensor -> the int32 value it wraps to, still as int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


# ---------------------------------------------------------------------------
# transforms (tpu.py:_tx_batch)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _basis(n: int, tx_type: int, device: str) -> torch.Tensor:
    return torch.as_tensor(dsp._basis(n, tx_type).astype(np.float64),
                           device=device)


def _tx_pass(acc: torch.Tensor) -> torch.Tensor:
    """One pass of the transform from its float64 matrix product to JAX's
    int32: ``(acc + _ROUND) >> _FRAC_BITS`` with int32 wraparound.

    Exact: the basis entries are Q11 integers (``dsp._FRAC_BITS`` = 11)
    under 2^11 in magnitude, and the other operand is int32, under 2^31.
    So every product is an integer under 2^42 and every partial sum of
    n <= 64 of them an integer under 2^48, which float64 (a 53-bit
    significand) holds exactly in any summation order: the product equals
    the int64 one.  JAX accumulates in int32 (``preferred_element_type``),
    which wraps mod 2^32, and adds ``_ROUND`` in int32 too, so the add
    wraps as well: wrap(wrap(acc) + R) == wrap(acc + R).  Then an
    arithmetic shift.  (The numpy reference adds R after its wrap, in
    int64, and differs where wrap(acc) + R passes 2^31 - 1.)"""
    return (_w32(acc.to(I64) + dsp._ROUND) >> dsp._FRAC_BITS).to(torch.int32)


def tx_batch_t(blocks: torch.Tensor, tx_type: int,
               inverse: bool) -> torch.Tensor:
    """int32 [B, n, n] -> transformed int32 [B, n, n] (tpu.py:_tx_batch)."""
    n = blocks.shape[-1]
    m = _basis(n, tx_type, str(blocks.device))
    x = blocks.to(torch.float64)
    if not inverse:
        # rows = (x @ m.T + R) >> B ; out = (m @ rows + R) >> B
        rows = _tx_pass(torch.matmul(x, m.T))
        return _tx_pass(torch.matmul(m, rows.to(torch.float64)))
    # cols = (m.T @ c + R) >> B ; out = (cols @ m + R) >> B
    cols = _tx_pass(torch.matmul(m.T, x))
    return _tx_pass(torch.matmul(cols.to(torch.float64), m))


def fwd_tx_batch(blocks: np.ndarray, tx_type: int = dsp.TX_DCT,
                 device="cuda") -> np.ndarray:
    """Batched forward transform: int32 [B, n, n] -> int32 [B, n, n]."""
    t = _up(blocks, device)
    return tx_batch_t(t, tx_type, False).cpu().numpy()


def inv_tx_batch(coeffs: np.ndarray, tx_type: int = dsp.TX_DCT,
                 device="cuda") -> np.ndarray:
    t = _up(coeffs, device)
    return tx_batch_t(t, tx_type, True).cpu().numpy()


# ---------------------------------------------------------------------------
# K19: the lapped filters across SB boundaries (tpu.py:77-150)
# ---------------------------------------------------------------------------


def _c_div(a, b: int):
    """tpu.py:_jx_c_div in int32: jnp.abs(INT_MIN) wraps to INT_MIN."""
    q = torch.div(_w32(a.abs()), abs(b), rounding_mode="floor")
    return _w32(torch.where((a >= 0) == (b >= 0), q, -q))


def lap_slab_plain(x: torch.Tensor, forward: bool) -> torch.Tensor:
    """K19's plain version on slabs: int32 [..., 32] -> filtered int32,
    ``_jx_lap_prefilter`` / ``_jx_lap_postfilter`` step for step (int64
    with a wrap to int32 after each step that can overflow)."""
    size = LAP_RADIUS
    h = size // 2
    p = [int(v) for v in dsp.LAP_PARAMS[size]]
    x = x.to(I64)
    xs = [x[..., i] for i in range(size)]
    t = [None] * size
    for i in range(h):
        t[size - 1 - i] = _w32(xs[i] - xs[size - 1 - i])
    for i in range(h):
        t[h - 1 - i] = _w32(xs[h - 1 - i] - (t[h + i] >> 1))
    out = [None] * size
    if forward:
        for i in range(h, size):
            v = _w32(t[i] * p[i - h]) >> 6
            t[i] = _w32(v + (v > 0).to(I64))
        for i in range(size - 1, h, -1):
            t[i] = _w32(t[i] + (_w32(t[i - 1] * p[i - 1] + 32) >> 6))
            t[i - 1] = _w32(t[i - 1] + (_w32(t[i] * p[i + h - 2] + 32) >> 6))
        for i in range(h):
            t[i] = _w32(t[i] + (t[size - 1 - i] >> 1))
            out[i] = t[i]
        for i in range(h):
            out[h + i] = _w32(t[h - 1 - i] - t[h + i])
    else:
        for i in range(h, size - 1):
            t[i] = _w32(t[i] - (_w32(t[i + 1] * p[i + h - 1] + 32) >> 6))
            t[i + 1] = _w32(t[i + 1] - (_w32(t[i] * p[i] + 32) >> 6))
        for i in range(size - 1, h - 1, -1):
            t[i] = _c_div(_w32(t[i] << 6), p[i - h])
        for i in range(h):
            t[i] = _w32(t[i] + (t[size - 1 - i] >> 1))
            out[i] = t[i]
        for i in range(h, size):
            out[i] = _w32(t[size - 1 - i] - t[i])
    return torch.stack(out, dim=-1).to(torch.int32)


def lap_dir_plain(c: torch.Tensor, sb: int, forward: bool,
                  vertical: bool) -> None:
    """One direction of the filter on planes ``c`` int32 [..., H, W], in
    place (``_jx_frame_ver`` when ``vertical``, else ``_jx_frame_hor``):
    the slabs of every boundary stacked, filtered, written back."""
    h = LAP_RADIUS // 2
    if vertical:
        c = c.transpose(-1, -2)
    at = list(range(sb, c.shape[-1], sb))
    if at:
        filt = lap_slab_plain(torch.stack([c[..., x0 - h:x0 + h]
                                           for x0 in at]), forward)
        for i, x0 in enumerate(at):
            c[..., x0 - h:x0 + h] = filt[i]


def _check_slabs(extent: int, sb: int) -> None:
    """Raise unless the slabs [b - 16, b + 16) of the boundaries b = sb, 2
    sb, ... below ``extent`` lie inside it and are disjoint: two slabs
    meet where sb < 32 and a direction crosses two boundaries or more (a
    halo's 32-row slab, sb = 16, has one boundary)."""
    h = LAP_RADIUS // 2
    nb = (extent - 1) // sb if extent > 0 else 0
    if nb > 1 and sb < LAP_RADIUS:
        raise ValueError(f"lap: sb {sb} < {LAP_RADIUS} makes the slabs of "
                         "two boundaries overlap")
    if nb and (sb < h or nb * sb + h > extent):
        raise ValueError(f"lap: a boundary's slab leaves the extent {extent} "
                         f"at sb {sb}")


LAP_ROLE_H = 1       # a tile's first 32 columns: a vertical boundary's slab
LAP_ROLE_V = 2       # a tile's 32 rows: a horizontal boundary's slab
LAP_MODES = ("frame", "hor", "ver")
_LAP_PIECE = 64      # a band tile's widest piece, a row tile's tallest


def _lap_pieces(lo: int, hi: int) -> list:
    return [(a, min(_LAP_PIECE, hi - a)) for a in range(lo, hi, _LAP_PIECE)]


@functools.lru_cache(maxsize=None)
def lap_tiles(H: int, W: int, sb: int, mode: str) -> np.ndarray:
    """K19's tiles of an [H, W] plane: int32 [n, 5] rows (y0, x0, h, w,
    role), read-only, covering the union of the slabs that ``mode``
    filters exactly once (``csrc/ffv2_lap.cu``).

    ``mode`` "frame" (both directions), "hor" (across the vertical
    boundaries, along rows) or "ver" (across the horizontal ones).  Band
    tiles (``LAP_ROLE_V``): a horizontal slab's 32 rows times a piece of
    at most 64 columns, the columns cut at every vertical slab's start
    ("frame"; such a piece starts with the slab and adds ``LAP_ROLE_H``)
    or every 64 ("ver").  Row tiles (``LAP_ROLE_H`` alone): up to 64 rows
    outside every horizontal slab ("frame"; all rows in "hor") times one
    vertical slab's 32 columns.  Raises ``ValueError`` where the slabs
    leave the plane or overlap (``_check_slabs``)."""
    if mode not in LAP_MODES:
        raise ValueError(f"lap: mode {mode!r} is not one of {LAP_MODES}")
    r, h = LAP_RADIUS, LAP_RADIUS // 2
    xs = ys = []
    if mode != "ver":
        _check_slabs(W, sb)
        xs = [b - h for b in range(sb, W, sb)]
    if mode != "hor":
        _check_slabs(H, sb)
        ys = [b - h for b in range(sb, H, sb)]
    tiles = []
    cuts = sorted({0, W, *xs})
    for y in ys:
        for a, b in zip(cuts, cuts[1:]):
            for i, (x, w) in enumerate(_lap_pieces(a, b)):
                slab = i == 0 and a in xs
                tiles.append((y, x, r, w,
                              LAP_ROLE_V | (LAP_ROLE_H if slab else 0)))
    gaps = sorted({0, H, *ys, *(y + r for y in ys)})
    for a, b in zip(gaps, gaps[1:]):
        if a in ys:                            # a horizontal slab's rows
            continue
        for y, hh in _lap_pieces(a, b):
            tiles.extend((y, x, hh, r, LAP_ROLE_H) for x in xs)
    out = np.array(tiles, dtype=np.int32).reshape(-1, 5)
    out.flags.writeable = False
    return out


_lap_tables = {}


def _lap_table_on(H: int, W: int, sb: int, mode: str, device) -> torch.Tensor:
    """``lap_tiles`` on ``device``, uploaded once a device."""
    key = (H, W, sb, mode, device)
    t = _lap_tables.get(key)
    if t is None:
        t = _lap_tables[key] = torch.as_tensor(
            lap_tiles(H, W, sb, mode).copy(), device=device)
    return t


def _lap(c: torch.Tensor, sb: int, forward: bool, mode: str) -> torch.Tensor:
    """K19 over ``lap_tiles``' ``mode`` on int32 planes ``c`` [P, H, W], in
    place: one launch for a CUDA tensor (none where no boundary is
    crossed), the plain version of each direction in the filter's order
    for a CPU tensor."""
    lap_tiles(c.shape[-2], c.shape[-1], sb, mode)      # the slabs' checks
    k = _build.KERNELS["lap_pre" if forward else "lap_post"]
    if k.plain_for(c.device):
        dirs = {"frame": (False, True), "hor": (False,), "ver": (True,)}[mode]
        for vertical in dirs if forward else dirs[::-1]:
            lap_dir_plain(c, sb, forward, vertical)
        return c
    k.check("c", c, c.shape, c.device)
    P, H, W = c.shape
    tab = _lap_table_on(H, W, sb, mode, c.device)
    if P and tab.shape[0]:
        k.launch(c.data_ptr(), tab.data_ptr(), tab.shape[0], P, H, W,
                 _build.stream_handle(c))
    return c


def lap_dir(c: torch.Tensor, sb: int, forward: bool,
            vertical: bool) -> torch.Tensor:
    """One direction of the lapped filter (``_jx_frame_ver`` when
    ``vertical``, else ``_jx_frame_hor``) on int32 planes ``c`` [P, H, W],
    in place, and returned: K19 (one ``lap_pre`` / ``lap_post`` launch
    over the "ver" or "hor" tiles) for a CUDA tensor, ``lap_dir_plain``
    for a CPU tensor.  The sharded front (``parallel/ffv2.py``) filters
    its band and its halo slabs one direction at a time."""
    return _lap(c, sb, forward, "ver" if vertical else "hor")


def lap_frame(c: torch.Tensor, sb: int, forward: bool) -> torch.Tensor:
    """The lapped filter across the SB boundaries of int32 planes ``c``
    [P, H, W], in place, and returned: the prefilter (``forward``) is the
    horizontal direction then the vertical, the postfilter the reverse.
    K19 (``lap_pre`` / ``lap_post``, one launch over the "frame" tiles)
    for a CUDA tensor, the plain version for a CPU tensor."""
    return _lap(c, sb, forward, "frame")


# ---------------------------------------------------------------------------
# K18: DC, PVQ pulses and gain split sums (tpu.py:233-318)
# ---------------------------------------------------------------------------


def _pvq_band_plain(band_abs: torch.Tensor, qp: int) -> torch.Tensor:
    """``_pvq_band_device`` step for step: band_abs [B, L] int32
    magnitudes (as int64) -> pulse counts y [B, L] (int64)."""
    B, L = band_abs.shape
    dev = band_abs.device
    Lp = 1 << max(1, (L - 1).bit_length())
    mx = band_abs.max(dim=1, keepdim=True).values
    f = mx.clamp(min=1).to(torch.int32).to(torch.float32)
    bl = (f.view(torch.int32).to(I64) >> 23) - 126
    shift = (bl - 8).clamp(min=0)
    ax = torch.nn.functional.pad(band_abs >> shift, (0, Lp - L))
    lanes = torch.arange(Lp, device=dev)
    valid = (lanes < L)[None, :]
    y = torch.zeros((B, Lp), dtype=I64, device=dev)
    xy = torch.zeros((B,), dtype=I64, device=dev)
    yy = torch.zeros((B,), dtype=I64, device=dev)
    for _ in range(qp):
        sx = _w32(xy[:, None] + ax)
        a = _w32(sx * sx)
        b = _w32(yy[:, None] + 2 * y + 1)
        q = torch.div(a, b, rounding_mode="floor")
        r = _w32(a - _w32(q * b))
        q = torch.where(valid & (y < qp - 1), q, -1)
        tq, tr, tb, ti = q, r, b, lanes.expand(B, Lp)
        length = Lp
        while length > 1:
            hh = length // 2
            ql, qr = tq[:, :hh], tq[:, hh:length]
            rl, rr = tr[:, :hh], tr[:, hh:length]
            bl_, br = tb[:, :hh], tb[:, hh:length]
            il, ir = ti[:, :hh], ti[:, hh:length]
            cl = _w32(rl * br)
            cr = _w32(rr * bl_)
            left = (ql > qr) | ((ql == qr)
                               & ((cl > cr) | ((cl == cr) & (il < ir))))
            tq = torch.where(left, ql, qr)
            tr = torch.where(left, rl, rr)
            tb = torch.where(left, bl_, br)
            ti = torch.where(left, il, ir)
            length = hh
        best = ti[:, 0]
        ok = tq[:, 0] >= 0
        onehot = (lanes[None, :] == best[:, None]) & ok[:, None]
        y = y + onehot.to(I64)
        xy = _w32(xy + torch.where(onehot, ax, 0).sum(dim=1))
        yy = _w32(yy + torch.where(onehot, 2 * y - 1, 0).sum(dim=1))
    return y[:, :L]


def quantize_plain(streams: torch.Tensor, qp: int, bands, n: int):
    """K18's plain version, ``_quantize_streams`` step for step: streams
    int32 [NB, n*n] -> (dc int32 [NB], pulses int8 [NB, bands[-1] -
    bands[0]], split sums int32 [NB, nbands, 3])."""
    dc = torch.empty((streams.shape[0],), dtype=torch.int32,
                     device=streams.device)
    dc.copy_(streams[:, 0])              # dense: the packed copy views it
    n_ac = n * n - 1
    ac = streams[:, 1:].to(I64)
    last = bands[-1]
    if last > n_ac:                      # the phantom position
        ac = torch.nn.functional.pad(ac, (0, last - n_ac))
    pulses, sums = [], []
    for lo, hi in zip(bands[:-1], bands[1:]):
        band = ac[:, lo:hi]
        aa = _w32(band.abs())
        h = aa >> 9
        lw = aa & 511
        sums.append(torch.stack([_w32((h * h).sum(dim=1)),
                                 _w32((h * lw).sum(dim=1)),
                                 _w32((lw * lw).sum(dim=1))], dim=1))
        y = _pvq_band_plain(aa, qp)
        pulses.append((y * band.sign()).to(torch.int8))
    return (dc, torch.cat(pulses, dim=1).contiguous(),
            torch.stack(sums, dim=1).to(torch.int32).contiguous())


def quantize_t(streams: torch.Tensor, qp: int, bands, n: int):
    """DC, PVQ pulses and split sums of scanned streams int32 [NB, n*n]
    (tpu.py:_quantize_streams): K18 for a CUDA tensor, the plain version
    for a CPU tensor."""
    k = _build.KERNELS["pvq"]
    bands = [int(b) for b in bands]
    if k.plain_for(streams.device):
        return quantize_plain(streams, qp, bands, n)
    dev = streams.device
    NB = streams.shape[0]
    k.check("streams", streams, (NB, n * n), dev)
    nb = len(bands) - 1
    dc = torch.empty((NB,), dtype=torch.int32, device=dev)
    pulses = torch.empty((NB, bands[-1] - bands[0]), dtype=torch.int8,
                         device=dev)
    sums = torch.empty((NB, nb, 3), dtype=torch.int32, device=dev)
    if NB:
        starts = np.asarray(bands, dtype=np.int32)
        k.launch(streams.data_ptr(), NB, n * n, starts.ctypes.data, nb, qp,
                 dc.data_ptr(), pulses.data_ptr(), sums.data_ptr(),
                 pulses.shape[1], _build.stream_handle(streams))
    return dc, pulses, sums


def igain_of(sums: np.ndarray) -> np.ndarray:
    """The exact int64 band energy from the int32 split sums:
    s0 * 2^18 + 2 * s1 * 2^9 + s2."""
    s = np.asarray(sums).astype(np.int64)
    return (s[..., 0] << 18) + (s[..., 1] << 10) + s[..., 2]


def quantize_streams(streams, qp: int, band_starts, n: int, device="cuda"):
    """Numpy (dc, pulses, igain) of scanned streams (tpu.py:
    quantize_streams)."""
    t = _up(streams, device)
    dc, pulses, sums = quantize_t(t, qp, band_starts, n)
    return dc.cpu().numpy(), pulses.cpu().numpy(), igain_of(sums.cpu())


# ---------------------------------------------------------------------------
# the frame pipelines (tpu.py:161-225, 333-365)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _order(n: int, device: str) -> torch.Tensor:
    return torch.as_tensor(dsp.scan_order(n), device=device)


def prefilter_t(planes: torch.Tensor, depth: int, sb: int) -> torch.Tensor:
    """int32 pixel planes [P, ph, pw] -> prefiltered Q12 coefficient planes
    (``dsp.ref_to_coeff``, then K19's prefilter)."""
    c = ((planes.to(torch.int32) << (12 - depth)) - 2048).contiguous()
    return lap_frame(c, sb, True)


def blocks_of(c: torch.Tensor, n: int) -> torch.Tensor:
    """Planes [P, ph, pw] -> n x n blocks [nby * nbx * P, n, n], in raster
    order of blocks, the planes of a block together."""
    P, ph, pw = c.shape
    return (c.reshape(P, ph // n, n, pw // n, n).permute(1, 3, 0, 2, 4)
            .reshape(-1, n, n))


def scan_t(blocks: torch.Tensor) -> torch.Tensor:
    """Blocks [B, n, n] -> their coding-order streams [B, n*n]."""
    n = blocks.shape[-1]
    return blocks.reshape(blocks.shape[0], -1)[:, _order(n,
                                                         str(blocks.device))]


def encode_front_t(planes: torch.Tensor, depth: int, sb: int, n: int,
                   mark=TRACE) -> torch.Tensor:
    """tpu.py:_encode_front: padded pixel planes [P, ph, pw] -> scanned
    coefficient streams int32 [nby * nbx * P, n*n]."""
    c = prefilter_t(planes, depth, sb)
    mark("Q12 + K19 lap_pre")
    txed = tx_batch_t(blocks_of(c, n), dsp.TX_DCT, False)
    mark("block split + transform")
    streams = scan_t(txed)
    mark("zigzag")
    return streams


def unscan_t(streams: torch.Tensor, n: int) -> torch.Tensor:
    """Coding-order streams [B, n*n] -> blocks [B, n, n]."""
    blocks = torch.zeros_like(streams)
    blocks[:, _order(n, str(streams.device))] = streams
    return blocks.reshape(-1, n, n)


def decode_back_t(streams: torch.Tensor, depth: int, sb: int, nplanes: int,
                  nby: int, nbx: int, n: int, mark=TRACE) -> torch.Tensor:
    """tpu.py:_decode_back: streams int32 [nby * nbx * P, n*n] -> pixel
    planes int32 [P, ph, pw], unclipped."""
    inv = tx_batch_t(unscan_t(streams, n), dsp.TX_DCT, True)
    c = (inv.reshape(nby, nbx, nplanes, n, n).permute(2, 0, 3, 1, 4)
         .reshape(nplanes, nby * n, nbx * n).contiguous())
    mark("inverse zigzag + transform")
    lap_frame(c, sb, False)
    mark("K19 lap_post")
    return coeff_to_ref_t(c, depth)


def coeff_to_ref_t(c: torch.Tensor, depth: int) -> torch.Tensor:
    """Postfiltered Q12 planes -> pixels, ``dsp.coeff_to_ref`` in int32."""
    return (_w32(c.to(I64) + 2048) >> (12 - depth)).to(torch.int32)


def upload(planes_padded: np.ndarray, depth: int, dev) -> torch.Tensor:
    """Pixel planes to the device at their source depth (uint8, or the
    16-bit words as int16, widened there with & 0xFFFF: torch's uint16 has
    few ops) -> int32 [P, ph, pw]."""
    a = np.asarray(planes_padded)
    if depth <= 8:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(
            dev).to(torch.int32)
    h16 = np.ascontiguousarray(a, dtype=np.uint16).view(np.int16)
    return torch.from_numpy(h16).to(dev).to(torch.int32) & 0xFFFF


def encode_front(planes_padded: np.ndarray, depth: int, sb: int = None,
                 n: int = None, device="cuda") -> np.ndarray:
    sb = sb or dsp.SB_SIZE
    n = n or sb
    t = _up(planes_padded, device)
    return encode_front_t(t, depth, sb, n).cpu().numpy()


def decode_back(streams: np.ndarray, depth: int, nplanes: int, nby: int,
                nbx: int, sb: int = None, n: int = None,
                device="cuda") -> np.ndarray:
    sb = sb or dsp.SB_SIZE
    n = n or sb
    t = _up(streams, device)
    return decode_back_t(t, depth, sb, nplanes, nby, nbx, n).cpu().numpy()


def prefilter_frame(planes_padded: np.ndarray, depth: int, sb: int = None,
                    device="cuda") -> np.ndarray:
    sb = sb or dsp.SB_SIZE
    t = _up(planes_padded, device)
    return prefilter_t(t, depth, sb).cpu().numpy()


def encode_front_q(planes_padded: np.ndarray, depth: int, qp: int,
                   band_starts, sb: int = None, n: int = None,
                   device="cuda", mark=TRACE):
    """The fused device front (tpu.py:encode_front_q): the planes go up
    at their source depth; Q12, K19's prefilter, the transform, the zigzag
    and K18 run on the device; dc, the split sums and the int8 pulses come
    down packed in one uint8 copy.  Returns numpy (dc int32 [NB], pulses
    int8 [NB, plen], igain int64 [NB, nbands])."""
    sb = sb or dsp.SB_SIZE
    n = n or sb
    x = upload(planes_padded, depth, _device(device))
    mark("host cast + upload")
    streams = encode_front_t(x, depth, sb, n, mark)
    dc, pulses, sums = quantize_t(streams, qp, band_starts, n)
    mark("K18 pvq")
    nb, nbands = sums.shape[:2]
    packed = torch.cat([dc.view(torch.uint8).reshape(nb, 4),
                        sums.view(torch.uint8).reshape(nb, nbands * 12),
                        pulses.view(torch.uint8)], dim=1)
    buf = packed.cpu().numpy()
    mark("pack + copy down")
    dc = buf[:, :4].copy().view(np.int32).reshape(nb)
    sums = buf[:, 4:4 + nbands * 12].copy().view(np.int32).reshape(
        nb, nbands, 3)
    pulses = buf[:, 4 + nbands * 12:].view(np.int8)
    return dc, pulses, igain_of(sums)
