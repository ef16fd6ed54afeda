"""A world of ranks on one host: the port's counterpart of the JAX
package's virtual CPU mesh (``tests/conftest.py``) and of the meshes of
``__graft_entry__.dryrun_multichip``.

``spawn_world(fn, n_ranks, backend, timeout_s, *args)`` starts n_ranks
processes (the ``spawn`` start method), joins them into one process group
over TCP on a free local port, runs ``fn(rank, n_ranks, *args)`` on each
and returns their results in rank order.  gloo ranks may share one card
(or none: the tests' ranks run the plain versions on the CPU); NCCL needs
a card a rank.  ``fn`` must live in a module that imports no jax: each
child imports it afresh.

``run_cases`` is such a function: the rank program that drives the
sharded encoders of this package through a list of cases (dicts, below)
and reports each case's outputs, launch counts and host times.
"""

from __future__ import annotations

import datetime
import hashlib
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from ..ffv1 import native as ffv1_native
from ..utils import metrics


def _free_port() -> int:
    """A TCP port that is free on this host now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# this rank's start, on the host's wall clock (time.time()): "spawn" the
# parent starting the ranks, "main" this child entering its body (its
# interpreter up and its imports done), "group" its arguments received
# and the process group joined
STARTED = {}


def _rank_main(fn, rank, n_ranks, backend, addr, timeout_s, spawned, in_q,
               out_q):
    """A child's body: take the arguments from ``in_q``, join the group,
    run ``fn``, report to the parent.  A failure is reported with its
    traceback (this is the boundary that tells the parent)."""
    STARTED.update(spawn=spawned, main=time.time())
    try:
        args = in_q.get(timeout=timeout_s)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=addr, world_size=n_ranks, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        STARTED["group"] = time.time()
        try:
            result = fn(rank, n_ranks, *args)
        finally:
            dist.destroy_process_group()
        out_q.put((rank, True, result))
    except Exception:
        out_q.put((rank, False, traceback.format_exc()))


def spawn_world(fn, n_ranks: int, backend: str, timeout_s: float, *args):
    """Run ``fn(rank, n_ranks, *args)`` on each rank of a new world and
    return the results in rank order.

    Before spawning, the parent builds what the ranks load (the CUDA
    library where torch sees a card, and the native runtime), so that the
    ranks never race nvcc or g++ into ``build/``.  Each rank's process
    group times out after ``timeout_s``; the parent waits at most
    ``timeout_s`` for the whole world, and on a timeout, a rank's
    exception or a rank that dies, terminates every rank and raises
    (RuntimeError, or TimeoutError).  Nothing is left running.

    ``args`` reach the ranks through a queue, not with the processes: a
    spawned child reads its process's pickle only as fast as it imports
    (torch first), so large arguments there would hold each start until
    the rank before it had imported torch."""
    if torch.cuda.is_available():
        _build.build()
    ffv1_native.build()
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    in_q = ctx.Queue()
    in_q.cancel_join_thread()     # a rank that dies unread must not hang us
    addr = f"tcp://127.0.0.1:{_free_port()}"
    spawned = time.time()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n_ranks, backend, addr, timeout_s,
                               spawned, in_q, out_q))
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout_s
    results = {}
    try:
        for p in procs:
            p.start()
        for _ in procs:
            in_q.put(args)
        while len(results) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {n_ranks} ({backend}): ranks "
                    f"{sorted(set(range(n_ranks)) - set(results))} did not "
                    f"finish within {timeout_s} s")
            try:
                rank, ok, out = out_q.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results}
                if dead:
                    raise RuntimeError(f"world of {n_ranks} ({backend}): "
                                       f"ranks exited without a result "
                                       f"(exit codes {dead})")
                continue
            if not ok:
                raise RuntimeError(f"world of {n_ranks} ({backend}): rank "
                                   f"{rank} failed:\n{out}")
            results[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        out_q.close()
        in_q.close()
    return [results[r] for r in range(n_ranks)]


def stall(rank: int, n_ranks: int, seconds: float) -> None:
    """A rank program whose collective never completes: rank 0 waits in a
    barrier that the other ranks, asleep for ``seconds``, never enter
    (``spawn_world``'s deadline is what ends it)."""
    if rank == 0:
        dist.barrier()
    else:
        time.sleep(seconds)


# ---------------------------------------------------------------------------
# the rank program
# ---------------------------------------------------------------------------


def _counts() -> tuple:
    ks = _build.KERNELS.values()
    return ({k.name: k.launches for k in ks},
            {k.name: k.plain_calls for k in ks})


def _digest(x) -> str:
    """sha256 of bytes, or of a tuple of arrays (their dtypes, shapes and
    bytes)."""
    h = hashlib.sha256()
    for a in ((x,) if isinstance(x, bytes) else x):
        if not isinstance(a, bytes):
            a = np.ascontiguousarray(a)
            h.update(f"{a.dtype}{a.shape}".encode())
        h.update(bytes(a) if isinstance(a, bytes) else a.tobytes())
    return h.hexdigest()


def _ffv1_case(case, mesh, device) -> dict:
    """Frames of every lane through ParallelFFV1Encoder.encode_batch, a
    step at a time.  Keys: width, height, pix_fmt, cfg, lanes (a list per
    data lane of frames, each a list of planes), keyframes (force_keyframe
    of each step, or None for the session's GOP), emission_order,
    load_state ((tables, picture_number) before the first step),
    state_after (the step after which ``state()`` is read)."""
    from .ffv1 import ParallelFFV1Encoder
    t0 = time.perf_counter()
    enc = ParallelFFV1Encoder(case["width"], case["height"],
                              case["pix_fmt"], case["cfg"], mesh,
                              device=device,
                              emission_order=case.get("emission_order",
                                                      False))
    setup_ms = (time.perf_counter() - t0) * 1e3
    if case.get("load_state") is not None:
        enc.load_state(*case["load_state"])
    lanes = case["lanes"]
    keyframes = case.get("keyframes") or [None] * len(lanes[0])
    out = dict(packets=[], frame_ms=[], stage_ms=[], state=None,
               kernels=list(enc.kernels), units=len(enc.banks),
               transport=mesh.backend, extradata=enc.extradata,
               setup_ms=setup_ms)
    _build.reset_counts()
    trace = metrics.StageTrace()
    for t, kf in enumerate(keyframes):
        t0 = time.perf_counter()
        with trace.call("encode_batch", len(lanes)) as call:
            pkts = enc.encode_batch([lane[t] for lane in lanes],
                                    force_keyframe=kf, mark=trace)
        out["frame_ms"].append((time.perf_counter() - t0) * 1e3)
        out["stage_ms"].append(call.stage_ms())
        out["packets"].append(pkts)
        if case.get("state_after") == t:
            out["state"] = enc.state()      # a gather; it launches nothing
    out["launches"], out["plain"] = _counts()
    return out


def _ffv2_case(case, mesh, device) -> dict:
    """The SB-banded FFV2 front on one frame (keys: planes [P, ph, pw]
    padded, depth, qp, sb, n), or with ``packet``, a NativeFFV2Encoder
    packet through ``encode(front_q=...)`` (keys: width, height, pix_fmt,
    qp, planes: a list of planes); ``reps`` times (1 by default), each
    timed (``ms``), the stage ms of the last."""
    from functools import partial
    from ..ffv2 import FFV2Config, dsp
    from ..ffv2.native import NativeFFV2Encoder
    from .ffv2 import encode_front_q_sharded
    if case.get("packet"):
        enc = NativeFFV2Encoder(case["width"], case["height"],
                                case["pix_fmt"], FFV2Config(qp=case["qp"]),
                                device=device)

        def run(trace):
            return enc.encode(case["planes"], front_q=partial(
                encode_front_q_sharded, mesh=mesh, device=device,
                mark=trace))
    else:
        def run(trace):
            return encode_front_q_sharded(
                np.asarray(case["planes"]), case["depth"], case["qp"],
                list(dsp.band_starts(case.get("n") or dsp.SB_SIZE)), mesh,
                sb=case.get("sb"), n=case.get("n"), device=device,
                mark=trace)
    _build.reset_counts()
    trace = metrics.StageTrace()
    ms = []
    for _ in range(case.get("reps", 1)):
        t0 = time.perf_counter()
        with trace.call("front", 1) as call:
            res = run(trace)
        ms.append((time.perf_counter() - t0) * 1e3)
    launches, plain = _counts()
    return dict(result=res, ms=ms, stage_ms=call.stage_ms(),
                launches=launches,
                plain=plain, transport=mesh.backend)


def _gather_case(case, mesh, device) -> dict:
    """gather_slice_bytes over the slice axis on this rank's buffers:
    ``lens[s]`` byte lengths for slice rank s, each buffer's byte i being
    (37 * s + 11 * row + i) % 256, its capacity ``cap``."""
    from .slices import gather_slice_bytes
    lens = case["lens"][mesh.s]
    by = np.zeros((len(lens), case["cap"]), np.uint8)
    for row, n in enumerate(lens):
        by[row, :n] = (37 * mesh.s + 11 * row + np.arange(n)) % 256
    got, ln = gather_slice_bytes(torch.as_tensor(by, device=device),
                                 torch.as_tensor(lens), mesh)
    return dict(by=got.cpu().numpy(), ln=ln.cpu().numpy(),
                device=str(got.device))


def _phase_a_case(case, mesh, device) -> dict:
    """phase_a_sharded (keys: crops, qt, bits, five, data_axis)."""
    from .slices import phase_a_sharded
    ctx, diff = phase_a_sharded(case["crops"], case["qt"], case["bits"],
                                case["five"], mesh,
                                data_axis=case.get("data_axis", False),
                                device=device)
    return dict(ctx=ctx, diff=diff)


_CASES = dict(ffv1=_ffv1_case, ffv2=_ffv2_case, gather=_gather_case,
              phase_a=_phase_a_case)


def run_cases(rank: int, n_ranks: int, cases, device="cuda") -> list:
    """The rank program of a world (``spawn_world``): each case in turn,
    on a mesh ``case["mesh"]`` = (data, slices) over ``case.get("group")``
    (global ranks; None: the world).  Every rank makes every case's mesh
    (a collective); a rank outside the case's group returns None for it.
    A case with ``expect`` = "ValueError" returns the message of the
    ValueError it must raise.  Packets and results come back from global
    rank 0 only; every rank returns their sha256 (``digests``,
    ``digest``).  Every result carries ``started``: the rank's start
    (``STARTED``, and "ready", its device set and, on a card, its CUDA
    context made) on the host's wall clock.

    A rank on "cuda" with no index takes card rank mod the card count:
    the ranks share the cards where they outnumber them."""
    from .slices import make_mesh
    torch.set_num_threads(1)          # the ranks share the host's cores
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
        torch.zeros(1, device="cuda")     # make the context here
    started = dict(STARTED, ready=time.time())
    out = []
    for case in cases:
        mesh = make_mesh(*case["mesh"], group=case.get("group"))
        if mesh is None:
            out.append(None)
            continue
        if case.get("expect") == "ValueError":
            try:
                _CASES[case["kind"]](case, mesh, device)
            except ValueError as e:
                out.append(dict(error=str(e)))
                continue
            raise AssertionError(f"case {case.get('name')}: no ValueError")
        res = _CASES[case["kind"]](case, mesh, device)
        res.update(name=case.get("name"), rank=rank, pid=os.getpid(),
                   d=mesh.d, s=mesh.s, started=started)
        if "packets" in res:
            res["digests"] = [[_digest(p) for p in step]
                              for step in res["packets"]]
            if rank:
                del res["packets"]
        if "result" in res:
            res["digest"] = _digest(res["result"])
            if rank:
                del res["result"]
        out.append(res)
    return out
