"""Multi-device sharding for the FFV1 device pipeline on torch.distributed.

The counterpart of ``ffmpeg_ffv2_tpu/parallel/slices.py``.  The codec's
natural parallel axes map onto a ("data", "slice") mesh of ranks:

* ``data``  -- independent frames or GOP streams on different ranks;
* ``slice`` -- FFV1 slices, which are independent coding units by format
  design (each has its own predictor ring, context states and range
  coder), so phase A and the entropy coder need no communication; the
  per-slice bitstreams meet in one gather (``gather_slice_bytes``) and
  the host lays out the slice trailers.

A rank's place in the mesh is (d, s) with rank = d * slices + s (row
major, as ``jax.sharding.Mesh`` lays out the device array).  Each rank
runs the port's kernels on its share; the collectives run between ranks
over the process groups that ``make_mesh`` builds.  Transport by backend:
NCCL moves tensors on the card, gloo moves host tensors (``transport``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ffv1.phase_a import plane_context_diff


@dataclasses.dataclass
class Mesh:
    """This rank's view of a ("data", "slice") mesh of ranks.

    ``d``, ``s``: this rank's coordinates; ``ranks``: the mesh's global
    ranks, row major; ``group``: all of them; ``slice_group``: the ranks
    of row ``d`` in ``s`` order; ``data_group``: the ranks of column
    ``s`` in ``d`` order; ``backend``: the process groups' backend."""
    data: int
    slices: int
    d: int
    s: int
    ranks: tuple
    group: object
    slice_group: object
    data_group: object
    backend: str

    @property
    def shape(self) -> dict:
        """The axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {"data": self.data, "slice": self.slices}


def make_mesh(data: int = 1, slices: int | None = None, group=None):
    """Build a ("data", "slice") mesh over the initialized default process
    group (the counterpart of slices.py:make_mesh).

    ``group``: the global ranks the mesh spans (a sequence, laid out in
    increasing order), or None for every rank of the world.  Every rank of the world calls this with the
    same arguments, because ``dist.new_group`` is collective over the
    world: the groups of every row and column are made on every rank, in
    one order.  Returns this rank's :class:`Mesh`, or None on a rank
    outside ``group``.  Raises ValueError when data x slices is not the
    number of ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no default process group (call "
                           "torch.distributed.init_process_group first)")
    # sorted: a process group orders its members by global rank
    ranks = tuple(range(dist.get_world_size()) if group is None
                  else sorted(int(r) for r in group))
    n = len(ranks)
    if slices is None:
        slices = n // data
    if data * slices != n:
        raise ValueError(f"{data}x{slices} != {n} ranks")
    grid = np.array(ranks).reshape(data, slices)
    whole = dist.new_group(list(ranks)) if group is not None \
        else dist.group.WORLD
    rows = [dist.new_group(grid[d].tolist()) for d in range(data)]
    cols = [dist.new_group(grid[:, s].tolist()) for s in range(slices)]
    me = dist.get_rank()
    if me not in ranks:
        return None
    d, s = divmod(ranks.index(me), slices)
    return Mesh(data, slices, d, s, ranks, whole, rows[d], cols[s],
                dist.get_backend(whole))


def transport(group) -> torch.device:
    """Where a collective over ``group`` takes its tensors, by the group's
    backend: NCCL gathers tensors on this rank's card, gloo gathers host
    tensors (a packet's bytes are wanted on the host anyway).  No other
    backend is taken."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if backend == "gloo":
        return torch.device("cpu")
    raise ValueError(f"no transport for backend {backend!r}")


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` from every rank of ``group`` (equal shapes), concatenated along
    dim 0 in group-rank order, on the group's transport device."""
    t = t.to(transport(group)).contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def uniform_slice_stack(plane: np.ndarray, prects, pad_to=None):
    """Stack per-slice crops of ``plane`` into [S, H, W] with edge-replicated
    padding to a common (or given) shape."""
    hs = [r[3] for r in prects]
    ws = [r[2] for r in prects]
    H = pad_to[0] if pad_to else max(hs)
    W = pad_to[1] if pad_to else max(ws)
    out = np.empty((len(prects), H, W), dtype=np.int32)
    for i, (x, y, w, h) in enumerate(prects):
        crop = plane[y:y + h, x:x + w]
        out[i, :h, :w] = crop
        if w < W:
            out[i, :h, w:] = crop[:, -1:]
        if h < H:
            out[i, h:, :] = out[i, h - 1:h, :]
    return out


def unstack_slices(stacked: np.ndarray, prects):
    """Undo uniform_slice_stack: list of [h, w] crops."""
    return [np.asarray(stacked[i, :h, :w])
            for i, (x, y, w, h) in enumerate(prects)]


def phase_a_sharded(crops, qt, bits, five, mesh, data_axis=False,
                    device="cuda"):
    """Phase A over a stacked slice batch, sharded over the mesh's slice
    axis (slices.py:phase_a_sharded).

    ``crops``: int32 [S, H, W] (or [B, S, H, W] with data_axis=True, B the
    mesh's data size), already int16-wrapped, S divisible by the slice
    axis; ``qt``: (bases, thr, dlt) from ``phase_a.build_quant_luts``.
    Rank (d, s) runs the port's ``plane_context_diff`` on its contiguous
    block of S / slices slices (of lane d's batch with data_axis); one
    all_gather over the slice group (and one over the data group) then
    gives every rank the global numpy (ctx, diff), each shaped as
    ``crops``, as the JAX function returns the global arrays."""
    crops = np.asarray(crops)
    lane = crops[mesh.d] if data_axis else crops
    S = lane.shape[0]
    if S % mesh.slices:
        raise ValueError(f"{S} slices not divisible by slice-axis size "
                         f"{mesh.slices}")
    n = S // mesh.slices
    block = torch.as_tensor(lane[mesh.s * n:(mesh.s + 1) * n],
                            dtype=torch.int32, device=device)
    ctx, diff = plane_context_diff(block, qt, bits, five)
    out = all_gather_cat(torch.stack([ctx, diff], dim=1),
                         mesh.slice_group)                 # [S, 2, H, W]
    if data_axis:
        out = all_gather_cat(out[None], mesh.data_group)   # [B, S, 2, H, W]
    out = out.cpu().numpy()
    return out[..., 0, :, :], out[..., 1, :, :]


def gather_slice_bytes(by, ln, mesh, axis: str = "slice"):
    """The bitstream-assembly collective (slices.py:gather_slice_bytes):
    every rank of the ``axis`` group contributes its local slices' byte
    buffers ``by`` uint8 [n, cap] and exact lengths ``ln`` [n], and
    receives the whole group's, concatenated in group order: (by [k * n,
    L] uint8, ln [k * n] int64) with L the largest length.  The lengths
    go first, then the buffers cut or zero-padded to L.

    Transport by backend, chosen from ``dist.get_backend`` of the group
    (``transport``), never by a caught failure: NCCL gathers the tensors
    on the card, gloo gathers their host copies."""
    group = {"slice": mesh.slice_group, "data": mesh.data_group}[axis]
    dev = transport(group)
    ln = torch.as_tensor(ln).to(device=dev, dtype=torch.int64)
    ln_all = all_gather_cat(ln, group)
    L = max(int(ln_all.max()) if ln_all.numel() else 0, 1)
    by = torch.as_tensor(by).to(dev)
    buf = by.new_zeros((by.shape[0], L))
    w = min(L, by.shape[1])
    buf[:, :w] = by[:, :w]
    return all_gather_cat(buf, group), ln_all
