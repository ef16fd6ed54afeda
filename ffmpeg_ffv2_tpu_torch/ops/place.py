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
_K = _build.KERNELS["place"]


def scatter_cells(dest, ch1, orig, cellrows_cap: int):
    """Plain version: ch1/orig (N,) int32 to flat cell dest (N,) of two
    (cellrows_cap, 128) int32 channels; empty cells hold 0 and INT32_MAX.
    Destinations outside the cells (the INT32_MAX sentinels) are dropped
    like jax's scatter mode="drop"."""
    cells = cellrows_cap * 128
    ok = (dest >= 0) & (dest < cells)
    idx = torch.where(ok, dest, cells).long()
    ch1c = torch.zeros(cells + 1, dtype=torch.int32, device=dest.device)
    ch2c = torch.full((cells + 1,), INT32_MAX, dtype=torch.int32,
                      device=dest.device)
    # the dropped elements all land on the spare slot past the cells
    ch1c.scatter_(0, idx, ch1)
    ch2c.scatter_(0, idx, orig)
    return (ch1c[:cells].reshape(cellrows_cap, 128),
            ch2c[:cells].reshape(cellrows_cap, 128))


def place(dest, ch1, orig, cellrows_cap: int):
    """K1 wrapper: (ch1c, ch2c), each (cellrows_cap, 128) int32."""
    n = dest.shape[0]
    for name, t in (("dest", dest), ("ch1", ch1), ("orig", orig)):
        _K.check(name, t, (n,), dest.device)
    if _K.plain_for(dest.device):
        return scatter_cells(dest, ch1, orig, cellrows_cap)
    ch1c = torch.zeros((cellrows_cap, 128), dtype=torch.int32,
                       device=dest.device)
    ch2c = torch.full((cellrows_cap, 128), INT32_MAX, dtype=torch.int32,
                      device=dest.device)
    _K.launch(dest.data_ptr(), ch1.data_ptr(), orig.data_ptr(), n,
              cellrows_cap * 128, ch1c.data_ptr(), ch2c.data_ptr(),
              _build.stream_handle(dest))
    return ch1c, ch2c
