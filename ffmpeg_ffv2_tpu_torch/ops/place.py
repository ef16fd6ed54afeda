"""Placement of the cell channels into the tile-major cell layout.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/device_coder.py:scatter_cells`` and
of the TPU kernel ``ffmpeg_ffv2_tpu/ops/place_pallas.py:
place_sorted_pallas`` (``_place_kernel``).  ``place`` launches the CUDA
kernel ``csrc/place.cu`` (K1) on CUDA tensors and takes the plain
``scatter_cells`` on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build

INT32_MAX = 2 ** 31 - 1
LANES = 128
# the plan's K1 slot geometry (device_coder.layout_plan; not in JAX's plan)
TABLE_KEYS = ("group_first", "group_size", "tile_rank0", "cell_bases",
              "cell_caps")
_K = _build.KERNELS["place"]


def scatter_cells(dest, ch1, orig, cellrows_cap: int):
    """Plain version: ch1/orig (N,) int32 to flat cell dest (N,) of two
    (cellrows_cap, 128) int32 channels; empty cells hold 0 and INT32_MAX.
    Destinations outside the cells (the INT32_MAX sentinels) are dropped
    like jax's scatter mode="drop"."""
    cells = cellrows_cap * LANES
    ok = (dest >= 0) & (dest < cells)
    idx = torch.where(ok, dest, cells).long()
    ch1c = torch.zeros(cells + 1, dtype=torch.int32, device=dest.device)
    ch2c = torch.full((cells + 1,), INT32_MAX, dtype=torch.int32,
                      device=dest.device)
    # the dropped elements all land on the spare slot past the cells
    ch1c.scatter_(0, idx, ch1)
    ch2c.scatter_(0, idx, orig)
    return (ch1c[:cells].reshape(cellrows_cap, LANES),
            ch2c[:cells].reshape(cellrows_cap, LANES))


def place(plan, cellrows_cap: int):
    """K1 wrapper: (ch1c, ch2c), each (cellrows_cap, 128) int32, the cells
    of ``plan`` (``device_coder.layout_plan``: ``dest``, ``ch1``,
    ``orig``, ``lane_rows`` and the TABLE_KEYS).  The kernel writes every
    cell once and equals scatter_cells wherever dest is unique, which
    layout_plan guarantees unless the tiles overflow tiles_cap (then the
    encoder redoes the frame larger and discards the cells)."""
    dest, ch1, orig = plan["dest"], plan["ch1"], plan["orig"]
    n = dest.shape[0]
    dev = dest.device
    for name, t in (("dest", dest), ("ch1", ch1), ("orig", orig)):
        _K.check(name, t, (n,), dev)
    if _K.plain_for(dev):
        return scatter_cells(dest, ch1, orig, cellrows_cap)
    tiles = plan["cell_caps"].shape[0]
    G = plan["group_size"].shape[0]
    for name, shape in (("lane_rows", (tiles * LANES,)),
                        ("group_first", (G,)), ("group_size", (G,)),
                        ("tile_rank0", (tiles,)), ("cell_bases", (tiles,)),
                        ("cell_caps", (tiles,))):
        _K.check(name, plan[name], shape, dev)
    cells = torch.empty((2, cellrows_cap, LANES), dtype=torch.int32,
                        device=dev)
    # scratch: each slot's (first element, length), then each row's tile
    scratch = torch.empty(tiles * LANES * 2 + cellrows_cap,
                          dtype=torch.int32, device=dev)
    runs, ch1c = scratch.data_ptr(), cells.data_ptr()
    _K.launch(dest.data_ptr(), ch1.data_ptr(), orig.data_ptr(), n,
              plan["lane_rows"].data_ptr(), plan["group_first"].data_ptr(),
              plan["group_size"].data_ptr(), G,
              plan["tile_rank0"].data_ptr(), plan["cell_bases"].data_ptr(),
              plan["cell_caps"].data_ptr(), tiles, cellrows_cap, runs,
              runs + 4 * tiles * LANES * 2, ch1c,
              ch1c + 4 * cellrows_cap * LANES, _build.stream_handle(dest))
    return cells[0], cells[1]
