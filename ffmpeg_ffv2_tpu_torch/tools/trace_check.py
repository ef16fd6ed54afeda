"""The stage recorder (``utils/metrics.py:StageTrace``) on the card, on
the FFV1 paths of the benchmark's cells: 1080p yuv420p FATE vsynth1
frames (``testsrc.videogen``), the range coder at level 3, context 1,
24 slices with CRCs, frame by frame (``encode()``) and in batches of 8
key frames (``encode_batch``), and Golomb-Rice at context 0, 16 slices
with CRCs, frame by frame:

    python3 -m ffmpeg_ffv2_tpu_torch.tools.trace_check [--frames N]
        [--out FILE]

It prints one JSON object a part, and writes them all to ``--out`` when
given:

- ``setup``: the process's set-up calls (``library load``, each
  ``session init``) with their stages' seconds;
- ``syncs``: each path, warm, through one call under
  ``torch.cuda.set_sync_debug_mode(1)``: every operation that made the
  host wait for the card, by the innermost line of the port that made
  it, with the stage it fell in and its count a call;
- ``stages``: each path's host ms a frame by stage and by kind over
  ``--frames`` frames (the recorder's own records), its boundaries a
  frame, and the calls' ms a frame on the host clock;
- ``cost``: ns a boundary on this host (``MARKS`` marks in one call),
  with no profile recording and with a CPU and CUDA profile recording;
- ``profile``: a CPU and CUDA ``torch.profiler`` profile of 3 range
  frames: how many events carry the stage prefix against the
  boundaries, their device types, and any such event on the device.

It needs a CUDA card and exits with 1 where there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import warnings

MARKS = 100_000
PKG = "ffmpeg_ffv2_tpu_torch"
# the benchmark's two deployments (portbench/configs/*.json)
RANGE = dict(level=3, coder=1, context=1, slices=24, slicecrc=1, gop_size=1)
RICE = dict(level=3, coder=0, context=0, slices=16, slicecrc=1, gop_size=1)
PATHS = {"range": (RANGE, 1), "rice": (RICE, 1), "range_b8": (RANGE, 8)}


def _frames(n: int) -> list:
    from ..testsrc import videogen
    return [list(f) for f in videogen.vsynth1_frames(n, 1920, 1080)]


def _session(cfg: dict):
    from ..ffv1.device_coder import DeviceFFV1Encoder
    from ..ffv1.params import FFV1Config
    return DeviceFFV1Encoder(1920, 1080, "yuv420p", FFV1Config(**cfg),
                             device="cuda")


def _call(enc, frames, b: int, mark=None):
    """One call of the path: ``encode`` of frames[0], or ``encode_batch``
    of frames[:b]."""
    if b == 1:
        return [enc.encode(frames[0], mark=mark)]
    return enc.encode_batch(frames[:b], mark)


def _where(stack) -> tuple:
    """The innermost frame of the port (this tool aside) in ``stack``."""
    for f in reversed(stack):
        if PKG in f.filename and "trace_check" not in f.filename:
            rel = f.filename[f.filename.index(PKG):]
            return f"{rel}:{f.lineno}", f.name, (f.line or "").strip()
    return "?", "?", ""


def syncs(enc, frames, b: int) -> list:
    """Every synchronising operation of one call: where, in which stage,
    how many times."""
    import torch
    seen, found = [], {}

    def mark(stage, inputs=None):
        seen.append(stage)

    def show(message, category, filename, lineno, file=None, line=None):
        where, fn, src = _where(traceback.extract_stack())
        key = (len(seen), where)
        found.setdefault(key, [fn, src, str(message).split("\n")[0][:90],
                               0])[3] += 1

    old = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode(1)
        try:
            _call(enc, frames, b, mark)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = old
    return [dict(stage=seen[i] if i < len(seen) else "(after the call)",
                 where=w, function=fn, line=src, warning=msg, count=n)
            for (i, w), (fn, src, msg, n) in sorted(found.items())]


def stages(enc, frames, b: int, n: int) -> dict:
    """The path's stages over ``n`` frames on a fresh recorder."""
    import torch
    from ..utils.metrics import StageTrace
    enc.trace = StageTrace()
    calls, t = 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while t < n:
        _call(enc, frames[t % len(frames):] + frames, b)
        t += b
        calls += 1
    ms = 1e3 * (time.perf_counter() - t0) / t
    recs = enc.trace.calls()
    by_stage, by_kind, bounds = {}, {}, 0
    for c in recs:
        for s in c.stages:
            d = 1e3 * (s.t1 - s.t0) / t
            by_stage[s.name] = by_stage.get(s.name, 0.0) + d
            by_kind[s.kind] = by_kind.get(s.kind, 0.0) + d
            bounds += 1
    return dict(frames=t, calls=calls, call_ms_per_frame=ms,
                recorded_ms_per_frame=1e3 * sum(c.t1 - c.t0 for c in recs)
                / t, boundaries_per_frame=bounds / t,
                attempts=max((s.attempt for c in recs for s in c.stages),
                             default=0),
                kind_ms_per_frame=by_kind, stage_ms_per_frame=by_stage)


def cost() -> dict:
    """ns a boundary, with no profile and with a CPU+CUDA profile."""
    from torch.profiler import ProfilerActivity, profile
    from ..utils.metrics import StageTrace, no_mark

    def per_mark(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(MARKS):
            fn("layout")
        return 1e9 * (time.perf_counter() - t0) / MARKS

    out = {"no_mark_ns": min(per_mark(no_mark) for _ in range(3))}
    best = []
    for _ in range(3):
        tr = StageTrace()
        with tr.call("cost", 1):
            best.append(per_mark(tr))
    out["boundary_ns"] = min(best)
    tr = StageTrace()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with tr.call("cost", 1):
            out["boundary_ns_profiled"] = per_mark(tr)
    return out


def profiled(enc, frames) -> dict:
    """3 range frames under a CPU and CUDA profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ..utils.metrics import EVENT_PREFIX, StageTrace
    enc.trace = StageTrace()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in frames[:3]:
            enc.encode(f)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.name.startswith(EVENT_PREFIX)]
    kinds = {}
    for e in ev:
        kinds[str(e.device_type)] = kinds.get(str(e.device_type), 0) + 1
    on_dev = [e.name for e in ev
              if e.device_type != torch.autograd.DeviceType.CPU]
    return dict(events=len(ev),
                boundaries=sum(len(c.marks) for c in enc.trace.calls()),
                device_types=kinds, on_device=on_dev[:20],
                longest_us=max((e.time_range.end - e.time_range.start
                                for e in ev), default=0.0),
                total_events=len(prof.events()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("trace_check: no CUDA card", file=sys.stderr)
        return 1
    from .. import _build
    from ..utils.metrics import TRACE
    t_start = time.perf_counter()
    _build.load()
    frames = _frames(8)
    out = {"device": torch.cuda.get_device_name(0)}
    sessions = {}
    for name, (cfg, b) in PATHS.items():
        enc = sessions[name] = _session(cfg)
        for _ in range(3):                 # warm: caps settled, allocator
            _call(enc, frames, b)
    out["setup"] = [dict(name=c.name, s=c.t1 - c.t0,
                         stages={s.name: s.t1 - s.t0 for s in c.stages})
                    for c in TRACE.calls(t_start)
                    if c.name in ("library load", "session init")]
    out["syncs"] = {name: syncs(sessions[name], frames, b)
                    for name, (_, b) in PATHS.items()}
    out["stages"] = {name: stages(sessions[name], frames, b, args.frames)
                     for name, (_, b) in PATHS.items()}
    out["cost"] = cost()
    out["profile"] = profiled(sessions["range"], frames)
    for k, v in out.items():
        print(json.dumps({k: v}))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
