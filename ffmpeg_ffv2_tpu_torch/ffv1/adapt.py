"""The FFV1 context-state walk (adaptation) over chain-grouped cells.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/device_coder.py:adapt_reference``
and of the TPU kernel ``ffmpeg_ffv2_tpu/ffv1/adapt_pallas.py:adapt_pallas``
(``_kernel_slotpack``).  ``adapt`` launches the CUDA kernel
``csrc/adapt.cu`` (K2) on CUDA tensors and takes the plain row scan
``adapt_plain`` on CPU tensors.  Coding depths <= 10 only.

Slot states are kept in PERMUTED row order (host.SLOT_AT_ROW); a cell's
pre-update state values pack into 8 int32 words, word j = slots 4j..4j+3
little-endian.
"""

from __future__ import annotations

import torch

from .. import _build
from . import host
from .symbols import lookup_packed, slot_bit_grid

_K = _build.KERNELS["adapt"]


def pack_sv_words(sv_perm):
    """(..., 32, 128) permuted-row sv bytes -> (..., 8, 128) int32 words."""
    return (sv_perm[..., 0:8, :]
            | (sv_perm[..., 8:16, :] << 8)
            | (sv_perm[..., 16:24, :] << 16)
            | (sv_perm[..., 24:32, :] << 24))


def adapt_plain(ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
                packed_table, tiles=None):
    """Plain version: a Python loop over the cell rows of each tile on
    (32, 128) state tensors.

    ch1_cells (CELLROWS, 128) int32; s0_blocks (TILES, 33, 128) int32 (32
    permuted slot rows, row 32 = per-lane continuation flag); returns
    (sv (CELLROWS, 8, 128) int32, ends (TILES, 32, 128) int32), zero
    where no tile walks.  ``tiles`` restricts the walk to the listed tile
    indices (ascending, closed under tile_pred), for a cut comparison."""
    dev = ch1_cells.device
    i32 = torch.int32
    caps = tile_caps.tolist()
    bases = tile_bases.tolist()
    preds = tile_pred.tolist()
    sv = torch.zeros((ch1_cells.shape[0], 8, 128), dtype=i32, device=dev)
    ends = torch.zeros((len(caps), 32, 128), dtype=i32, device=dev)
    perm = torch.as_tensor(host.SLOT_AT_ROW, device=dev).long()
    table = packed_table.reshape(128)
    for t in (range(len(caps)) if tiles is None else tiles):
        cap, base, pred = caps[t], bases[t], preds[t]
        if cap <= 0:
            continue
        if pred >= 0:
            cont = (s0_blocks[t, 32] > 0)[None, :]
            s = torch.where(cont, ends[pred], s0_blocks[t, :32])
        else:
            s = s0_blocks[t, :32].clone()
        for row in range(base, base + cap):
            r = ch1_cells[row]
            v = (r & 0xFFF) - 2048
            ok = ((r >> 13) & 1) == 1
            valid, bit = slot_bit_grid(v)            # (128, 32) slot order
            valid = (valid & ok[:, None])[:, perm].T
            bit = bit[:, perm].T
            sv[row] = pack_sv_words(torch.where(valid, s, 0))
            s = torch.where(valid, lookup_packed(table, bit * 256 + s), s)
        ends[t] = s
    return sv, ends


def successors(tile_pred):
    """The successor of each tile (tile_pred inverted, -1 for none), built
    on the device; the spare slot past the tiles absorbs the root tiles'
    writes.  K2 and K5 walk a split group's tiles through it."""
    tiles = tile_pred.shape[0]
    tidx = torch.arange(tiles, dtype=torch.int32, device=tile_pred.device)
    succ = torch.full((tiles + 1,), -1, dtype=torch.int32,
                      device=tile_pred.device)
    succ.scatter_(0, torch.where(tile_pred >= 0, tile_pred, tiles).long(),
                  tidx)
    return succ[:tiles].contiguous()


def adapt(ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
          packed_table, code_bits: int):
    """K2 wrapper: (sv (CELLROWS, 8, 128), ends (TILES, 32, 128)) int32."""
    if code_bits > 10:
        raise NotImplementedError(
            "adapt: coding depth above 10 needs the repeat sub-steps of "
            "slots 10/31, which the port does not have yet")
    dev = ch1_cells.device
    cellrows = ch1_cells.shape[0]
    tiles = tile_caps.shape[0]
    _K.check("ch1_cells", ch1_cells, (cellrows, 128), dev)
    for name, t in (("tile_caps", tile_caps), ("tile_bases", tile_bases),
                    ("tile_pred", tile_pred)):
        _K.check(name, t, (tiles,), dev)
    _K.check("s0_blocks", s0_blocks, (tiles, 33, 128), dev)
    _K.check("packed_table", packed_table, (128,), dev)
    if _K.plain_for(dev):
        return adapt_plain(ch1_cells, tile_caps, tile_bases, tile_pred,
                           s0_blocks, packed_table)
    succ = successors(tile_pred)
    sv = torch.zeros((cellrows, 8, 128), dtype=torch.int32, device=dev)
    ends = torch.zeros((tiles, 32, 128), dtype=torch.int32, device=dev)
    _K.launch(ch1_cells.data_ptr(), tile_caps.data_ptr(),
              tile_bases.data_ptr(), tile_pred.data_ptr(), succ.data_ptr(),
              s0_blocks.data_ptr(), packed_table.data_ptr(), tiles, cellrows,
              sv.data_ptr(), ends.data_ptr(), _build.stream_handle(ch1_cells))
    return sv, ends
