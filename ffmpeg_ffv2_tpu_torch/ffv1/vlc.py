"""The Golomb-Rice VlcState walk over chain-grouped cells.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/device_rice.py:vlc_adapt_reference``
and of the TPU kernel ``device_rice.py:vlc_adapt_pallas`` (``_vlc_kernel``).
``vlc_adapt`` launches the CUDA kernel ``csrc/vlc.cu`` (K5) on CUDA tensors
and takes the plain row scan ``vlc_adapt_plain`` on CPU tensors.

Cells come from the same chain-grouping layout as the range coder's
(``device_coder.layout_plan`` with ``payload_bits=pb + 1``): bits
0..pb-1 hold diff + 2^(pb - 1), bit pb the silent flag, bit pb + 1 the
valid flag, with pb = ``rice.rice_pb(bits)`` (12 for coding depths up to
12, 16 for 13..16).  Each live
cell (valid, not silent) gets one ``len << 18 | val`` code word, and its
lane's four states (drift, error_sum, bias, count) advance.
"""

from __future__ import annotations

import torch

from .. import _build
from .adapt import successors
from .rice import rice_pb, vlc_code_word, vlc_update

I32 = torch.int32
_K = _build.KERNELS["vlc"]


def vlc_adapt_plain(ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
                    bits: int, tiles=None):
    """Plain version: a Python loop over the cell rows of each tile on
    (128,) state tensors.

    ch1_cells (CELLROWS, 128) int32; s0_blocks (TILES, 5, 128) int32 (4
    state rows + the per-lane continuation flag).  Returns (code
    (CELLROWS, 128), ends (TILES, 4, 128)) int32, zero where no tile
    walks; a tile with cap <= 0 keeps zero end states, which a successor
    with the continuation flag loads.  ``tiles`` restricts the walk to the
    listed tile indices (ascending, closed under tile_pred)."""
    dev = ch1_cells.device
    pb = rice_pb(bits)
    caps = tile_caps.tolist()
    bases = tile_bases.tolist()
    preds = tile_pred.tolist()
    code = torch.zeros(ch1_cells.shape, dtype=I32, device=dev)
    ends = torch.zeros((len(caps), 4, 128), dtype=I32, device=dev)
    for t in (range(len(caps)) if tiles is None else tiles):
        cap, base, pred = caps[t], bases[t], preds[t]
        if cap <= 0:
            continue
        s = s0_blocks[t, :4]
        if pred >= 0:
            s = torch.where(s0_blocks[t, 4:5] > 0, ends[pred], s)
        drift, es, bias, count = s.unbind(0)
        for row in range(base, base + cap):
            r = ch1_cells[row]
            v0 = (r & ((1 << pb) - 1)) - (1 << (pb - 1))
            live = (((r >> (pb + 1)) & 1) == 1) & (((r >> pb) & 1) == 0)
            length, val, v = vlc_code_word(v0, drift, es, bias, count, bits)
            nd, ne, nb, nc = vlc_update(drift, es, bias, count, v)
            drift = torch.where(live, nd, drift)
            es = torch.where(live, ne, es)
            bias = torch.where(live, nb, bias)
            count = torch.where(live, nc, count)
            code[row] = torch.where(live, (length << 18) | val, 0)
        ends[t] = torch.stack([drift, es, bias, count])
    return code, ends


def vlc_adapt(ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
              bits: int):
    """K5 wrapper: (code (CELLROWS, 128), ends (TILES, 4, 128)) int32."""
    dev = ch1_cells.device
    cellrows = ch1_cells.shape[0]
    tiles = tile_caps.shape[0]
    _K.check("ch1_cells", ch1_cells, (cellrows, 128), dev)
    for name, t in (("tile_caps", tile_caps), ("tile_bases", tile_bases),
                    ("tile_pred", tile_pred)):
        _K.check(name, t, (tiles,), dev)
    _K.check("s0_blocks", s0_blocks, (tiles, 5, 128), dev)
    if _K.plain_for(dev):
        return vlc_adapt_plain(ch1_cells, tile_caps, tile_bases, tile_pred,
                               s0_blocks, bits)
    succ = successors(tile_pred)
    code = torch.zeros((cellrows, 128), dtype=I32, device=dev)
    ends = torch.zeros((tiles, 4, 128), dtype=I32, device=dev)
    _K.launch(ch1_cells.data_ptr(), tile_caps.data_ptr(),
              tile_bases.data_ptr(), tile_pred.data_ptr(), succ.data_ptr(),
              s0_blocks.data_ptr(), tiles, cellrows, bits, rice_pb(bits),
              code.data_ptr(), ends.data_ptr(),
              _build.stream_handle(ch1_cells))
    return code, ends
