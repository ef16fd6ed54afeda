"""The CLI's ``--mesh DxS`` encode: the counterpart of
``ffmpeg_ffv2_tpu/cli/main.py:_encode_stream_mesh``.

GOP-parallel sharded FFV1 encode over a ("data", "slice") mesh of D x S
ranks (``parallel.slices.make_mesh``): lane b encodes GOPs b, b + D, ...
through ``parallel.ffv1.ParallelFFV1Encoder``, each lane's slices split
over the S ranks of its row.  The packets come back in stream order,
byte-identical to the single-device encoder's.

``encode_mesh`` runs in the CLI's process: it checks the mesh against the
frame's slices (``parallel.ffv1.check_slices``), picks the transport,
turns the JAX CLI's GOP schedule (``gop_steps``) into one FFV1 case of
the rank program ``parallel.world.run_cases`` and spawns the world
(``parallel.world.spawn_world``).

The transport is chosen, never caught: gloo when the ranks run on the CPU
(``-device cpu``, the plain versions) or when the world has more ranks
than torch sees cards (the ranks then share the cards, rank r on card
r mod count); NCCL when every rank has a card of its own.
"""

from __future__ import annotations

import numpy as np
import torch

MESH_TIMEOUT_S = 1800.0       # the world's deadline (spawn_world)


def parse_mesh(spec: str) -> tuple:
    """"DxS" -> (D, S), both positive; ValueError otherwise."""
    try:
        data, slices = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"{spec!r} is not DxS, e.g. 2x2") from None
    if data < 1 or slices < 1:
        raise ValueError(f"{spec!r}: both sizes must be positive")
    return data, slices


def pick_transport(n_ranks: int, device) -> str:
    """gloo on the CPU or where ranks must share a card, NCCL where every
    rank has one (NCCL refuses two ranks on one device)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"


def gop_steps(n_frames: int, gop: int, data: int):
    """The JAX CLI's schedule: GOP b rides lane b mod D; per group of D
    GOPs, step t sends each lane its GOP's frame t (a short lane repeats
    its last frame, and its extra packets are dropped), with
    force_keyframe on t == 0.  Yields (frame index a lane, keyframe,
    {lane: stream position} of the packets kept)."""
    gop = gop if gop > 0 else n_frames
    starts = list(range(0, n_frames, gop))
    for base in range(0, len(starts), data):
        group = [(s, min(gop, n_frames - s)) for s in starts[base:base + data]]
        for t in range(max(n for _, n in group)):
            batch = [s + min(t, n - 1) for s, n in group]
            batch += [batch[-1]] * (data - len(batch))
            keep = {j: s + t for j, (s, n) in enumerate(group) if t < n}
            yield batch, t == 0, keep


def encode_mesh(spec: str, cfg, pix_fmt: str, w: int, h: int, frames,
                device) -> tuple:
    """Encode ``frames`` over a ``spec`` ("DxS") mesh of ranks on
    ``device``: the ``gop_steps`` schedule as one ``kind="ffv1"`` case of
    ``parallel.world.run_cases``.  Returns (packets in stream order,
    extradata, params, transport, a report by rank: its steps' ms, its
    encoder's set-up ms, the seconds of its start, its launches and plain
    calls).  ValueError for a mesh the frame does not allow; RuntimeError
    for a rank that fails."""
    from ..core.pixfmt import get_pix_fmt
    from ..ffv1.params import params_from_config
    from ..parallel.ffv1 import check_slices
    from ..parallel.world import run_cases, spawn_world
    data, slices = parse_mesh(spec)
    p = params_from_config(cfg, pix_fmt, w, h)
    check_slices(cfg, p, slices)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device (-device cpu runs the "
                           "plain versions)")
    transport = pick_transport(data * slices, device)
    # the planes in their sample width: what every rank is sent
    dt = np.uint8 if get_pix_fmt(pix_fmt).bits <= 8 else np.uint16
    sent = [[np.ascontiguousarray(pl, dtype=dt) for pl in fr]
            for fr in frames]
    steps = list(gop_steps(len(frames), cfg.gop_size, data))
    case = dict(kind="ffv1", name=f"mesh {spec}", mesh=(data, slices),
                width=w, height=h, pix_fmt=pix_fmt, cfg=cfg,
                lanes=[[sent[batch[b]] for batch, _, _ in steps]
                       for b in range(data)],
                keyframes=[key for _, key, _ in steps])
    res = [r[0] for r in spawn_world(run_cases, data * slices, transport,
                                     MESH_TIMEOUT_S, [case], device)]
    packets = [None] * len(frames)
    for (_, _, keep), pkts in zip(steps, res[0]["packets"]):
        for j, i in keep.items():
            packets[i] = pkts[j]
    reports = []
    for r in res:
        st = r["started"]
        reports.append(dict(
            rank=r["rank"], transport=r["transport"], ms=sum(r["frame_ms"]),
            setup_ms=r["setup_ms"],
            start_s=dict(interpreter=st["main"] - st["spawn"],
                         group=st["group"] - st["main"],
                         device=st["ready"] - st["group"]),
            launches={k: v for k, v in r["launches"].items() if v},
            plain_calls={k: v for k, v in r["plain"].items() if v}))
    return packets, res[0]["extradata"], p, transport, reports
