"""The readers of the port's stage records (``portbench/spans.py``): a
traced run on the CPU prints them, and the four host splits a frame add
up to the window's time a frame; a program without the recorder, or a
window that the records do not match call for call, leaves them silent;
``setup_program_s`` sums the set-up calls."""

import sys
import time
from types import SimpleNamespace

import pytest

from portbench import harness, spans

SPLITS = ("host_enqueue_ms_per_frame", "host_copy_ms_per_frame",
          "host_wait_ms_per_frame", "host_packet_ms_per_frame")
WINDOW = SPLITS + ("host_syncs_per_frame",)


def _read(name, r):
    return harness.reader(name)(r)


def test_a_session_window_splits_into_the_four_kinds():
    """A Golomb-Rice session on the CPU, driven as the frame loop drives
    it: every stage of the window lies in one of the four splits, which
    add up to the calls' time, and two reads a frame block the host (the
    sizes and the bytes down)."""
    import numpy as np
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
    from ffmpeg_ffv2_tpu_torch.utils import metrics
    enc = DeviceFFV1Encoder(32, 32, "yuv420p", FFV1Config(
        level=3, coder=0, slices=4, gop_size=1), device="cpu")
    rng = np.random.RandomState(1)
    frames = [[rng.randint(0, 256, s).astype(np.int32)
               for s in ((32, 32), (16, 16), (16, 16))] for _ in range(4)]
    enc.encode(frames[0])
    from portbench.drivers import frame_loop
    calls = frame_loop.drive(enc, frames, {}, 0, 4, None)
    r = SimpleNamespace(window_calls=calls)
    got = {k: _read(k, r) for k in WINDOW}
    records = metrics.TRACE.calls(calls[0].t0, calls[-1].t1)
    assert sum(got[k] for k in SPLITS) == pytest.approx(
        1e3 * sum(c.t1 - c.t0 for c in records) / 4)
    assert all(got[k] > 0 for k in SPLITS)
    assert got["host_syncs_per_frame"] == 2.0


def _recorder(monkeypatch, ring=1 << 16):
    from ffmpeg_ffv2_tpu_torch.utils import metrics
    tr = metrics.StageTrace(ring)
    monkeypatch.setitem(sys.modules, spans.MODULE, SimpleNamespace(
        TRACE=tr, SYNCS=metrics.SYNCS))
    return tr


def _window(tr, n, stages=("upload", "K1 place", "sizes to host",
                           "bytes to host", "slice bytes")):
    calls = []
    for t in range(n):
        t0 = time.perf_counter()
        with tr.call("encode", 1):
            for s in stages:
                tr(s)
        calls.append(harness.Call(t0, time.perf_counter(), [t], []))
    return SimpleNamespace(window_calls=calls)


def test_the_splits_cover_the_window(monkeypatch):
    tr = _recorder(monkeypatch)
    r = _window(tr, 50)
    w = r.window_calls
    mean = 1e3 * (w[-1].t1 - w[0].t0) / 50
    total = sum(_read(k, r) for k in SPLITS)
    assert total == pytest.approx(1e3 * sum(
        c.t1 - c.t0 for c in tr.calls()) / 50)
    assert total <= mean
    assert _read("host_syncs_per_frame", r) == 2.0


def test_the_readers_are_silent_without_matching_records(monkeypatch):
    from ffmpeg_ffv2_tpu_torch.utils.metrics import StageTrace
    r = _window(StageTrace(), 3)
    monkeypatch.setitem(sys.modules, spans.MODULE, SimpleNamespace())
    for k in WINDOW + ("setup_program_s",):
        assert _read(k, r) is None            # an older port: no TRACE
    tr = _recorder(monkeypatch)
    r = _window(tr, 3)
    r.window_calls.append(harness.Call(time.perf_counter(),
                                       time.perf_counter(), [3], []))
    for k in WINDOW:
        assert _read(k, r) is None            # a call with no record
    tr = _recorder(monkeypatch, ring=8)
    r = _window(tr, 3)
    for k in WINDOW:
        assert _read(k, r) is None            # the ring dropped a call


def test_setup_program_s_sums_the_set_up_calls(monkeypatch):
    tr = _recorder(monkeypatch)
    with tr.call("library load", 0):
        tr("library bind")
    with tr.call("session init", 0):
        tr("session tables")
    r = _window(tr, 3)
    load, init, first = tr.calls()[:3]
    later = _window(tr, 2)
    assert _read("setup_program_s", later) == pytest.approx(
        sum(c.t1 - c.t0 for c in (load, init, first)))
    assert first.name == "encode" and r.window_calls
