"""Multi-device FFV1 encoder on torch.distributed: frames in, packets out.

The counterpart of ``ffmpeg_ffv2_tpu/parallel/ffv1.py``.
``ParallelFFV1Encoder`` runs the port's device FFV1 pipeline on every rank
of a ("data", "slice") mesh (``slices.make_mesh``):

* the **slice axis** shards FFV1 slices, independent coding units by
  format design: rank (d, s) codes the s-th contiguous block of each
  shape bank's slices as a ``Bank`` of its own, through the session's
  ``device_coder.code_banks``, with no communication; the raw slice
  payloads then ride one gather over the slice group and one over the
  data group (``gather_slice_bytes``), and the host lays out the packet
  (``device_coder.finish_packet``);
* the **data axis** carries independent streams: lane d encodes its own
  frame sequence, its coder state carried across frames by the banks of
  the ranks (d, *).

Each bank grows its own caps: the bytes do not depend on them, so no
collective runs inside the retry loop, and every rank calls the same
collectives in the same order.  Every packet equals the single-device
``DeviceFFV1Encoder``'s for the lane's frames.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ffv1.device_coder import (Bank, code_banks, finish_packet,
                                 shape_banks, upload)
from ..ffv1 import headers as H
from ..ffv1.host import build_crop_plan
from ..ffv1.params import FFV1Config, params_from_config
from ..utils.metrics import TRACE
from .slices import all_gather_cat, gather_slice_bytes


def check_slices(cfg: FFV1Config, p, n_shards: int) -> list:
    """Raise ValueError unless the frame's slices split over a slice axis
    of ``n_shards`` ranks: cfg.slices and every shape bank's slice count
    divisible by it.  Returns the crop plan of ``p`` (the stream's
    FFV1Params).  ``ParallelFFV1Encoder`` calls it, and the CLI's
    ``--mesh`` before it starts any rank."""
    if cfg.slices % n_shards:
        raise ValueError(f"slices={cfg.slices} not divisible by slice-axis "
                         f"size {n_shards}")
    plan = build_crop_plan(p)
    for ids in shape_banks(plan):
        if len(ids) % n_shards:
            raise ValueError(
                f"bank of {len(ids)} slices not divisible by slice-axis "
                f"size {n_shards} (slice shapes "
                f"{[pr[ids[0]][2:] for pr in plan]})")
    return plan


class ParallelFFV1Encoder:
    """Sharded FFV1 encode over a ("data", "slice") mesh of ranks.

    Parameters
    ----------
    width, height, pix_fmt, cfg : like ``DeviceFFV1Encoder``.
    mesh : this rank's ``slices.Mesh``; every slice bank's count must be
        divisible by the slice-axis size (uniform frames have one bank of
        cfg.slices).
    device : "cuda" (the kernels) by default; "cpu" runs their plain
        versions (tests).
    emission_order : K6 in place of K2 and emission_pack, as
        ``DeviceFFV1Encoder``'s.

    ``encode_batch(frames)`` takes one frame per data lane a call, on
    every rank; lane d's frames form an independent stream.  All lanes
    share the keyframe flag a call (aligned GOPs).  Every rank returns
    every lane's packet.
    """

    def __init__(self, width: int, height: int, pix_fmt: str,
                 cfg: FFV1Config, mesh, device="cuda",
                 emission_order: bool = False):
        if set(getattr(mesh, "shape", ())) != {"data", "slice"}:
            raise ValueError('mesh must have axes ("data", "slice")')
        self.mesh = mesh
        self.data = int(mesh.shape["data"])
        self.n_shards = int(mesh.shape["slice"])
        self.cfg = cfg
        self.device = torch.device(device)
        p = self.p = params_from_config(cfg, pix_fmt, width, height)
        plan = check_slices(cfg, p, self.n_shards)
        # [bank][s]: shard s's block of each shape bank, what P("slice")
        # gives shard s of the bank's slice order; this rank codes its
        # blocks as banks of their own
        self.blocks = []
        for ids in shape_banks(plan):
            n = len(ids) // self.n_shards
            self.blocks.append([ids[s * n:(s + 1) * n]
                                for s in range(self.n_shards)])
        self.banks = [Bank(p, b[mesh.s], plan, self.device, emission_order)
                      for b in self.blocks]
        self.kernels = self.banks[0].kernels
        self.extradata = H.write_extradata(p) if p.version > 1 else b""
        # the global slice id of each row of a gathered lane: shard s's
        # blocks, bank by bank
        self._slice_of = [si for s in range(self.n_shards)
                          for b in self.blocks for si in b[s]]
        self.picture_number = 0

    # -- codec state ---------------------------------------------------------

    def state(self) -> list:
        """The carried coder state, one numpy array per bank in the JAX
        ``_BankUnit._state`` layout: [data, n_shards, chain_rows + 1, 32]
        uint8 (range) or [..., 4] int32 (Golomb-Rice), chain_rows the rows
        of one shard's block.  Gathered from every rank of the mesh; every
        rank calls it."""
        out = []
        for bank in self.banks:
            t = torch.as_tensor(bank.state())
            parts = all_gather_cat(t[None], self.mesh.group).cpu().numpy()
            out.append(parts.reshape((self.data, self.n_shards)
                                     + bank.state_shape))
        return out

    def load_state(self, tables, picture_number: int):
        """Continue the lanes' streams from ``tables`` (``state()``'s
        layout, one array per bank: this package's, or the JAX
        ``_BankUnit._state``): rank (d, s) takes its slab [d, s]."""
        if len(tables) != len(self.banks):
            raise ValueError(f"load_state: {len(self.banks)} units, got "
                             f"{len(tables)} tables")
        d, s = self.mesh.d, self.mesh.s
        for bank, t in zip(self.banks, tables):
            t = np.asarray(t)
            shape = (self.data, self.n_shards) + bank.state_shape
            if t.shape != shape:
                raise ValueError(f"load_state: expected {shape}, "
                                 f"got {t.shape}")
            bank.load_state(t[d, s])
        self.picture_number = int(picture_number)

    # -- public API ----------------------------------------------------------

    def encode_batch(self, frames, force_keyframe=None,
                     mark=TRACE) -> list:
        """Encode one frame per data lane (len(frames) == the mesh's data
        size; rank (d, *) encodes frames[d]); returns every lane's packet,
        on every rank, byte-identical to the single-device encoder run per
        lane.  ``mark`` is called after the local encode, after the
        gathers and after the packets' assembly."""
        if len(frames) != self.data:
            raise ValueError(
                f"need {self.data} frames (one per data lane), got "
                f"{len(frames)}")
        gop = self.cfg.gop_size
        keyframe = gop == 0 or self.picture_number % gop == 0
        if force_keyframe is not None:
            keyframe = bool(force_keyframe)
        planes = upload(frames[self.mesh.d], self.device)
        local = [data for part in code_banks(self.banks, planes, keyframe)
                 for data in part]
        mark("encode")
        cap = max(len(x) for x in local)
        by = np.zeros((len(local), cap), np.uint8)
        for i, x in enumerate(local):
            by[i, :len(x)] = np.frombuffer(x, np.uint8)
        ln = np.array([len(x) for x in local], np.int64)
        by, ln = gather_slice_bytes(torch.from_numpy(by),
                                    torch.from_numpy(ln), self.mesh)
        by, ln = gather_slice_bytes(by, ln, self.mesh, axis="data")
        by_h, ln_h = by.cpu().numpy(), ln.cpu().numpy()
        mark("gather")
        n = len(self._slice_of)
        pkts = [finish_packet(self.p, self._slice_of,
                              [by_h[k, :ln_h[k]].tobytes()
                               for k in range(d * n, (d + 1) * n)])
                for d in range(self.data)]
        self.picture_number += 1
        mark("assemble")
        return pkts
