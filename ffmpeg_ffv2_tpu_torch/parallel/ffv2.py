"""Multi-device sharding for the FFV2 device front on torch.distributed.

The counterpart of ``ffmpeg_ffv2_tpu/parallel/ffv2.py``.  FFV2's parallel
unit is the superblock: the transforms, the zigzag and the PVQ quantizer
work a block at a time, but the lapped prefilter crosses SB boundaries
with a 32-sample support (16 each side).  Banding the frame into
contiguous SB rows over the mesh's slice axis therefore needs ONE halo
exchange: at each boundary between two ranks' bands, the vertical filter
reads 16 rows from each side.  Here the exchange is an all_gather of each
band's top and bottom 16 rows over the slice group (transported by
backend, ``slices.transport``), where the JAX module sends them with
``ppermute``.

Byte-identity: the result is the same (dc, pulses, igain) as the single
device ``ffv2.device.encode_front_q`` (the same Q12 arithmetic, filter
support and block raster order: the bands are contiguous rows, so their
block streams concatenated in s order ARE the global raster order), so the
entropy coder writes the same packet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ffv2 import device as dv
from ..ffv2 import dsp
from ..utils.metrics import TRACE
from .slices import all_gather_cat

RADIUS = dv.LAP_RADIUS
HALF = RADIUS // 2


def _filter_halo(c: torch.Tensor, up: torch.Tensor, dn: torch.Tensor):
    """The vertical prefilter of a band's two boundary slabs, [2P, 32, W]
    in one K19 launch: rows 0..15 of the top slab are the rank above's
    bottom rows ``up``, rows 16..31 of the bottom slab the rank below's
    top rows ``dn`` (all pre-vertical-filter)."""
    slabs = torch.cat([torch.cat([up, c[:, :HALF]], dim=1),
                       torch.cat([c[:, -HALF:], dn], dim=1)]).contiguous()
    return dv.lap_dir(slabs, HALF, True, True)


def encode_front_q_sharded(planes_padded: np.ndarray, depth: int, qp: int,
                           band_starts, mesh, sb: int | None = None,
                           n: int | None = None, device="cuda",
                           mark=TRACE):
    """Sharded twin of ``ffv2.device.encode_front_q``
    (parallel/ffv2.py:encode_front_q_sharded): the frame's SB rows are
    banded over the mesh's slice axis; every rank returns the global numpy
    (dc, pulses, igain), identical to the single-device front's.

    ``planes_padded``: int [P, ph, pw], the whole frame on every rank, ph
    a multiple of slices * sb (raises ValueError otherwise).  Rank s
    takes band s and runs, in order: Q12; K19's horizontal direction on
    the band; the halo exchange (the band's top and bottom 16 rows,
    gathered over the slice group; s takes s-1's bottom rows and s+1's
    top rows); K19's vertical direction on the band's interior
    boundaries and on its two 32-row boundary slabs (the first and last
    ranks keep their outer rows); the transform, the zigzag and K18 on
    the band's blocks; then the packed rows gathered in s order.
    ``mark`` is called after each stage (``metrics.TRACE`` by default)."""
    sb = sb or dsp.SB_SIZE
    n = n or sb
    n_shards, s = mesh.shape["slice"], mesh.s
    P, ph, pw = planes_padded.shape
    if ph % (n_shards * sb):
        raise ValueError(f"plane height {ph} must split into {n_shards} "
                         "SB-row bands")
    bands = [int(b) for b in band_starts]
    hl = ph // n_shards
    x = dv.upload(planes_padded[:, s * hl:(s + 1) * hl], depth,
                  dv._device(device))
    c = ((x << (12 - depth)) - 2048).contiguous()
    dv.lap_dir(c, sb, True, False)
    mark("upload + Q12 + K19 horizontal")
    edges = all_gather_cat(torch.stack([c[:, :HALF], c[:, -HALF:]])[None],
                           mesh.slice_group).to(c.device)  # [k, 2, P, 16, W]
    zero = torch.zeros_like(c[:, :HALF])
    up = edges[s - 1, 1] if s > 0 else zero
    dn = edges[s + 1, 0] if s < n_shards - 1 else zero
    mark("halo exchange")
    slabs = _filter_halo(c, up, dn)
    dv.lap_dir(c, sb, True, True)                  # interior boundaries
    if s > 0:
        c[:, :HALF] = slabs[:P, HALF:]
    if s < n_shards - 1:
        c[:, -HALF:] = slabs[P:, :HALF]
    mark("K19 vertical + halo slabs")
    streams = dv.scan_t(dv.tx_batch_t(dv.blocks_of(c, n), dsp.TX_DCT,
                                      False))
    dc, pulses, sums = dv.quantize_t(streams, qp, bands, n)
    mark("transform + zigzag + K18")
    nb, nbands = sums.shape[:2]
    packed = torch.cat([dc.view(torch.uint8).reshape(nb, 4),
                        sums.view(torch.uint8).reshape(nb, nbands * 12),
                        pulses.view(torch.uint8)], dim=1)
    buf = all_gather_cat(packed, mesh.slice_group).cpu().numpy()
    mark("gather + copy down")
    nb = buf.shape[0]
    dc = buf[:, :4].copy().view(np.int32).reshape(nb)
    sums = buf[:, 4:4 + nbands * 12].copy().view(np.int32).reshape(
        nb, nbands, 3)
    pulses = buf[:, 4 + nbands * 12:].view(np.int8)
    return dc, pulses, dv.igain_of(sums)
