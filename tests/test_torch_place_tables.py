"""K1's slot geometry (the TABLE_KEYS that the port's layout_plan adds to
JAX's plan) on seeded frames, range and Golomb-Rice payloads, at GCAP 64
and 16 (split groups): every real slot's run of elements reproduces
``dest``, every element lies in exactly one run, and the lane walk built
from the tables (csrc/place.cu's two passes in plain PyTorch,
``slot_runs`` and ``lane_walk``) equals ``scatter_cells``, also where
the cell rows overflow, elements are dropped and the encoder's
``layout()`` clamps the walk's tiles.
"""

import numpy as np
import pytest
import torch

from ffmpeg_ffv2_tpu_torch.ffv1 import host
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu_torch.ops.place import (INT32_MAX, LANES, TABLE_KEYS,
                                             place, scatter_cells)
from test_torch_formats import torch_one_thread  # noqa: F401


def slot_runs(plan):
    """(first, length) (tiles * 128,) of each slot's run of elements, the
    kernel's first pass: slot (T, l) starts at group_first[g] +
    tile_rank0[T] for g = lane_rows[T * 128 + l], and is real (length >
    0) iff that element's dest is the slot's first cell."""
    caps, bases = plan["cell_caps"], plan["cell_bases"]
    dest = plan["dest"]
    rank0 = plan["tile_rank0"].repeat_interleave(LANES)
    g = plan["lane_rows"].long()
    first = plan["group_first"][g] + rank0
    length = torch.minimum(plan["group_size"][g] - rank0,
                           caps.repeat_interleave(LANES))
    cell0 = (bases[:, None] * LANES + torch.arange(
        LANES, dtype=torch.int32, device=dest.device)).reshape(-1)
    at = dest[first.clamp(max=dest.shape[0] - 1).long()]
    real = (length > 0) & (first < dest.shape[0]) & (at == cell0)
    return first, torch.where(real, length, 0)


def lane_walk(plan, cellrows_cap: int):
    """The kernel's second pass: every cell of the two channels from the
    slot runs, row by row (the row's tile, then each lane's run), the fill
    past a run and past the last tile."""
    caps, bases = plan["cell_caps"], plan["cell_bases"]
    first, length = slot_runs(plan)
    dev = caps.device
    row = torch.arange(cellrows_cap, dtype=torch.int32, device=dev)
    T = (torch.searchsorted(bases, row, right=True, out_int32=True) - 1)
    T = T.clamp(min=0)
    j = (row - bases[T.long()])[:, None]
    slot = (T[:, None] * LANES + torch.arange(LANES, dtype=torch.int32,
                                              device=dev)).long()
    hit = (j < caps[T.long()][:, None]) & (j < length[slot])
    src = torch.where(hit, first[slot] + j, 0).long()
    return (torch.where(hit, plan["ch1"][src], 0),
            torch.where(hit, plan["orig"][src], INT32_MAX))


def _frame(w, h, seed):
    """yuv420p gradient + sparse noise: a few large context groups (split
    at a small GCAP) beside many small ones."""
    rng = np.random.RandomState(seed)
    planes = []
    for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        yy, xx = np.mgrid[0:hh, 0:ww]
        pl = (xx // 8 * 8 + yy).astype(np.int32) % 256
        noise = rng.rand(hh, ww) < 0.3
        planes.append(torch.as_tensor(np.where(
            noise, rng.randint(0, 256, (hh, ww)), pl).astype(np.int32)))
    return planes


@pytest.fixture(params=[(64, 1), (16, 1), (64, 0), (16, 0)],
                ids=["gcap64-range", "gcap16-range", "gcap64-rice",
                     "gcap16-rice"])
def layout(request, monkeypatch):
    """(encoder, plan_at): plan_at(cellrows_cap) is the encoder's own
    layout() of one seeded keyframe at the worst-case tile cap."""
    gcap, coder = request.param
    monkeypatch.setattr(host, "GCAP", gcap)
    w, h = (96, 64) if gcap == 64 else (48, 32)
    enc = DeviceFFV1Encoder(w, h, "yuv420p",
                            FFV1Config(level=3, coder=coder, slices=4),
                            device="cpu").banks[0]
    planes = _frame(w, h, 11)
    if coder:
        (ctx, field), bits = enc.phase_a(planes), 0
    else:
        ctx, streams = enc.phase_a_rice(planes)
        field, bits = streams["payload"], enc.rice_pb + 1

    def plan_at(cellrows_cap):
        plan = enc.layout(ctx, field, enc.caps.tiles_max, cellrows_cap, bits)
        assert set(TABLE_KEYS) <= set(plan)
        assert (plan["tile_rank0"] > 0).any()      # split groups' tiles
        return plan

    return enc, plan_at


def _check_runs(plan):
    """Every real slot's j-th cell is dest of its run's j-th element, runs
    fit their tile, and each element (no sentinel) is in one run."""
    first, length = slot_runs(plan)
    dest = plan["dest"]
    slot = torch.nonzero(length > 0).reshape(-1)
    T, lane = slot // LANES, slot % LANES
    assert (length[slot] <= plan["cell_caps"][T]).all()
    n = length[slot].long()
    rep = torch.repeat_interleave(torch.arange(slot.shape[0]), n)
    j = torch.arange(int(n.sum())) - torch.repeat_interleave(
        torch.cumsum(n, 0) - n, n)
    elem = first[slot][rep].long() + j
    cell = (plan["cell_bases"][T][rep].long() + j) * LANES + lane[rep]
    assert torch.equal(dest[elem].long(), cell)
    cover = torch.zeros(dest.shape[0], dtype=torch.int64)
    cover.index_add_(0, elem, torch.ones_like(elem))
    assert torch.equal(cover, (dest != INT32_MAX).long())


def _check_walk(plan, cellrows_cap):
    ref = scatter_cells(plan["dest"], plan["ch1"], plan["orig"],
                        cellrows_cap)
    for got in (lane_walk(plan, cellrows_cap), place(plan, cellrows_cap)):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_torch_place_tables_reproduce_dest(layout):
    enc, plan_at = layout
    _check_runs(plan_at(enc.caps.cellrows_max))


def test_torch_place_lane_walk_equals_scatter(layout):
    enc, plan_at = layout
    rows = int(plan_at(enc.caps.cellrows_max)["n_rows"])
    for cellrows_cap in (enc.caps.cellrows_max, rows):
        _check_walk(plan_at(cellrows_cap), cellrows_cap)


def test_torch_place_overflowing_layout(layout):
    """Half the rows the tiles need: layout() clamps the walk's tile
    bases, the cells past the cap are dropped, and the slot runs and the
    lane walk still follow dest."""
    enc, plan_at = layout
    cellrows_cap = int(plan_at(enc.caps.cellrows_max)["n_rows"]) // 2
    plan = plan_at(cellrows_cap)
    assert not torch.equal(plan["tile_bases"], plan["cell_bases"])
    dest = plan["dest"]
    assert ((dest >= cellrows_cap * LANES) & (dest != INT32_MAX)).any()
    _check_runs(plan)
    _check_walk(plan, cellrows_cap)
