"""The stage recorder (``utils/metrics.py:StageTrace``) on the FFV1
session, on the CPU (every kernel wrapper runs its plain PyTorch
version): a range and a Golomb-Rice ``DeviceFFV1Encoder`` at 32x32 / 4
slices, ``encode()`` frame by frame and one ``encode_batch`` of 2 key
frames.  Each call leaves one call record whose stages tile it; the
packets are the native codec's, whatever the recorder; an explicit
``mark`` still takes every stage and the kernels' inputs; the ring's
interval query; and the profiler events of the boundaries."""

import bisect
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu_torch.utils import metrics
from ffmpeg_ffv2_tpu_torch.utils.metrics import STAGE_KINDS, StageTrace
from test_torch_formats import torch_one_thread  # noqa: F401

W, H = 32, 32
CODERS = {"range": 1, "rice": 0}
PATHS = ("range", "rice", "batch")
# the stages every call of a path leaves, at least
PATH_STAGES = {
    "range": {"upload", "phase_a", "layout", "K1 place", "s0", "K2 adapt",
              "emission_pack", "writeback", "unsort", "K3 expand",
              "sizes to host", "K4 rac_render", "lengths to host",
              "bytes to host", "slice bytes", "slice trailers + CRC"},
    "rice": {"upload", "phase_a", "layout", "K1 place", "s0", "K5 vlc",
             "writeback", "unsort", "compact events", "ladder kernel",
             "ladder delivery", "bit elements", "bit assembly",
             "sizes to host", "bytes to host", "slice bytes",
             "slice trailers + CRC"},
}
PATH_STAGES["batch"] = PATH_STAGES["range"]
# the kernel stages whose inputs an explicit mark receives
KERNEL_STAGES = {"range": {"K1 place", "K2 adapt", "emission_pack",
                           "K3 expand", "K4 rac_render"},
                 "rice": {"K1 place", "K5 vlc", "ladder kernel"}}
KERNEL_STAGES["batch"] = KERNEL_STAGES["range"]


def _frames(n, seed=3):
    """A moving gradient in luma, seeded noise in chroma."""
    rng = np.random.RandomState(seed)
    y = np.indices((H, W)).sum(0) * 3
    return [[((y + t) % 256).astype(np.int32)]
            + [rng.randint(0, 256, (H // 2, W // 2)).astype(np.int32)
               for _ in range(2)] for t in range(n)]


def _session(path, trace=None):
    coder = CODERS["rice" if path == "rice" else "range"]
    cfg = FFV1Config(level=3, coder=coder, slices=4,
                     gop_size=1 if path == "batch" else 2)
    enc = DeviceFFV1Encoder(W, H, "yuv420p", cfg, device="cpu")
    enc.trace = StageTrace() if trace is None else trace
    return enc, cfg


def _run(enc, path, frames, mark=None):
    """The packets of ``frames``: frame by frame, or as one batch."""
    if path == "batch":
        return enc.encode_batch(frames, mark)
    return [enc.encode(f, mark=mark) for f in frames]


def _native(cfg, frames, path):
    nat = NativeFFV1Codec(DeviceFFV1Encoder(W, H, "yuv420p", cfg,
                                            device="cpu").p)
    return [nat.encode(f, path == "batch" or t % cfg.gop_size == 0)
            for t, f in enumerate(frames)]


@pytest.fixture(scope="module")
def runs(torch_one_thread):  # noqa: F811
    """Each path's two frames through three sessions: one that records
    into a fresh StageTrace, one into TRACE, and one with an explicit
    ``mark`` that keeps each stage and its inputs; and the native codec's
    packets.  No profile records, and ``record_function`` counts the
    events the recorder makes."""
    out = {}
    made = []
    real = metrics._profiler.record_function

    def counted(name):
        made.append(name)
        return real(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics._profiler, "record_function", counted)
        for path in PATHS:
            frames = _frames(2)
            enc, cfg = _session(path)
            default, _ = _session(path, metrics.TRACE)
            explicit, _ = _session(path)
            got = []
            out[path] = dict(
                enc=enc, packets=_run(enc, path, frames),
                default=_run(default, path, frames),
                explicit=_run(explicit, path, frames,
                              mark=lambda st, x=None: got.append((st, x))),
                explicit_trace=explicit.trace, marks=got,
                native=_native(cfg, frames, path))
    out["events"] = made
    return out


@pytest.mark.parametrize("path", PATHS)
def test_torch_trace_calls_tile_and_name_every_stage(runs, path):
    """One call record a call with its frames; its stages tile it (each
    starts where the one before ended, the first at the call's start, the
    last ending at its end); every stage is in STAGE_KINDS; the path's
    stages are all there; the cap-retry attempts count up from 0; the
    packets are the native codec's, and those of a session that records
    into TRACE."""
    r = runs[path]
    calls = r["enc"].trace.calls()
    n_calls, per_call = (1, 2) if path == "batch" else (2, 1)
    name = "encode_batch" if path == "batch" else "encode"
    assert [(c.name, c.frames) for c in calls] == [(name, per_call)] * n_calls
    for c in calls:
        st = c.stages
        assert st[0].t0 == c.t0 and st[-1].t1 == c.t1
        assert all(a.t1 == b.t0 for a, b in zip(st, st[1:]))
        assert all(s.t0 <= s.t1 for s in st)
        assert all(s.kind == STAGE_KINDS[s.name] for s in st)
        assert {s.name for s in st} >= PATH_STAGES[path]
        attempts = [s.attempt for s in st]
        assert attempts[0] == 0 and attempts == sorted(attempts)
    assert r["packets"] == r["native"] == r["default"]


@pytest.mark.parametrize("path", PATHS)
def test_torch_trace_explicit_mark_takes_its_place(runs, path):
    """An explicit ``mark`` receives the stages that the recorder records,
    in order, with each kernel stage's inputs; the session's recorder
    records nothing then, and the packets are the same."""
    r = runs[path]
    want = [s.name for c in r["enc"].trace.calls() for s in c.stages]
    assert [s for s, _ in r["marks"]] == want
    assert {s for s, x in r["marks"] if x is not None} == KERNEL_STAGES[path]
    assert all(isinstance(x, tuple) for _, x in r["marks"] if x is not None)
    assert r["explicit_trace"].calls() == []
    assert r["explicit"] == r["packets"]


def test_torch_trace_no_events_without_a_profile(runs):
    """With no profile recording, the recorder makes no profiler event."""
    assert runs["events"] == []


def test_torch_trace_retry_attempts():
    """A layout cap too small for the frame: the first attempt's stages
    carry attempt 0, the retry's 1, and the packet is still the native
    codec's."""
    frames = _frames(1, seed=7)
    enc, cfg = _session("range")
    enc.banks[0].caps.tiles_cap = 1
    assert _run(enc, "range", frames) == _native(cfg, frames, "range")
    (call,) = enc.trace.calls()
    attempts = [(s.name, s.attempt) for s in call.stages]
    assert {("sizes to host", 0), ("sizes to host", 1)} <= set(attempts)
    assert ("upload", 0) in attempts and ("K4 rac_render", 1) in attempts


def test_torch_trace_interval_and_ring():
    """``calls(t0, t1)`` gives exactly the calls whose roots lie inside
    the interval; once the ring has dropped a call that ended at or after
    t0, it gives None."""
    frames = _frames(3, seed=9)
    enc, _ = _session("rice")
    marks = [time.perf_counter()]
    for f in frames:
        enc.encode(f)
        marks.append(time.perf_counter())
    every = enc.trace.calls()
    assert len(every) == 3
    for i in range(3):
        assert enc.trace.calls(marks[i], marks[i + 1]) == [every[i]]
    assert enc.trace.calls(marks[0], marks[2]) == every[:2]
    assert enc.trace.calls(marks[3], float("inf")) == []
    # a ring of two calls' boundaries: the first call is gone
    size = len(every[0].marks) + 1
    small, _ = _session("rice", StageTrace(ring=2 * size + 1))
    marks = [time.perf_counter()]
    for f in frames:
        small.encode(f)
        marks.append(time.perf_counter())
    assert small.trace.calls() is None
    assert small.trace.calls(marks[0], marks[3]) is None
    assert len(small.trace.calls(marks[1], marks[3])) == 2
    assert small.trace.last() is small.trace.calls(marks[2], marks[3])[0]


def test_torch_trace_totals_counts_and_nesting():
    """The running totals and counts sum the closed calls' stages; a call
    nested inside another is a call of its own whose time lies in the
    enclosing call's next stage, and ``calls`` gives roots only; a mark
    outside any call records nothing."""
    tr = StageTrace()
    tr("upload")
    with tr.call("outer", 2) as outer:
        tr("upload")
        with tr.call("inner", 0) as inner:
            tr("build")
        tr.retry()
        tr("layout")
    assert tr.calls() == [outer]
    assert [(s.name, s.attempt) for s in outer.stages] == [("upload", 0),
                                                           ("layout", 1)]
    assert outer.stages[1].t0 <= inner.t0 <= inner.t1 <= outer.t1
    assert inner.parent is outer and tr.last() is outer
    assert tr.counts == {"upload": 1, "layout": 1, "build": 1}
    assert tr.totals["layout"] == pytest.approx(
        outer.stages[1].t1 - outer.stages[1].t0)
    assert set(outer.stage_ms()) == {"upload", "layout"}


def test_torch_trace_session_init_is_a_call():
    """A session's set-up is a call ``session init`` on TRACE, whose one
    stage tiles it."""
    before = time.perf_counter()
    _session("range")
    (call,) = [c for c in metrics.TRACE.calls(before)
               if c.name == "session init"]
    assert [s.name for s in call.stages] == ["session tables"]
    assert call.stages[0].t0 == call.t0 and call.stages[0].t1 == call.t1


def test_torch_trace_profiler_events():
    """While a CPU profile records, each boundary leaves one event named
    ``EVENT_PREFIX + stage`` on the host, which encloses no other event
    (a Golomb-Rice frame: the plain range coder makes a profile of
    hundreds of thousands of events)."""
    enc, _ = _session("rice")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(enc, "rice", _frames(1, seed=11))
    want = [metrics.EVENT_PREFIX + s.name for c in enc.trace.calls()
            for s in c.stages]
    events = prof.events()
    ours = sorted((e for e in events
                   if e.name.startswith(metrics.EVENT_PREFIX)),
                  key=lambda e: e.time_range.start)
    assert [e.name for e in ours] == want
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ours)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if not e.name.startswith(metrics.EVENT_PREFIX))
    for e in ours:
        a, b = e.time_range.start, e.time_range.end
        i = bisect.bisect_left(spans, (a, float("-inf")))
        while i < len(spans) and spans[i][0] <= b:
            assert spans[i][1] > b      # no event inside [a, b]
            i += 1


def test_torch_trace_span_and_no_mark():
    """``span`` opens a call only on a StageTrace; one ``no_mark`` is
    shared by the modules that name it."""
    from ffmpeg_ffv2_tpu_torch.ffv1 import rice
    tr = StageTrace()
    with metrics.span(tr, "encode", 1) as call:
        tr("upload")
    assert tr.calls() == [call]
    with metrics.span(metrics.no_mark, "encode", 1) as none:
        assert none is None
    assert rice.no_mark is metrics.no_mark
