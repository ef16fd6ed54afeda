"""The reader of the shape banks in flight
(``portbench/metrics/banks_in_flight_per_frame.py``) on built stage
records: both banks' K4 launched before the call's first lengths read
reads 2 a frame, a bank read before the next is enqueued 1, and records
without banks leave it silent."""

import sys
import time
from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.tests.test_portbench_spans import _read, _recorder


def _banked(tr, n, order):
    """``n`` calls recorded on ``tr`` whose stages are ``order``: (bank,
    stage) pairs, a bank of None for a port that marks no bank."""
    calls = []
    for t in range(n):
        t0 = time.perf_counter()
        with tr.call("encode", 1):
            for b, s in order:
                if b is not None:
                    tr.bank(b)
                tr(s)
        calls.append(harness.Call(t0, time.perf_counter(), [t], []))
    return SimpleNamespace(window_calls=calls)


SERIAL = [(0, "upload"), (0, "K4 rac_render"), (0, "lengths to host"),
          (0, "bytes to host"), (1, "upload"), (1, "K4 rac_render"),
          (1, "lengths to host"), (1, "bytes to host"),
          (0, "slice trailers + CRC")]
PIPELINED = [(0, "upload"), (0, "K4 rac_render"), (1, "K4 rac_render"),
             (0, "lengths to host"), (0, "K4 rac_render"),
             (0, "lengths to host"), (0, "bytes to host"),
             (0, "slice trailers + CRC")]


@pytest.mark.parametrize("order,want", [(PIPELINED, 2.0), (SERIAL, 1.0),
                                        ([(None, s) for _, s in SERIAL[:4]],
                                         1.0)])
def test_banks_in_flight_counts_the_launches_before_the_first_read(
        monkeypatch, order, want):
    """Both banks' K4 before the call's first lengths read: 2 a frame (a
    retry after the read adds none); a bank read before the next is
    enqueued, or a session without banks: 1."""
    tr = _recorder(monkeypatch)
    r = _banked(tr, 4, order)
    assert _read("banks_in_flight_per_frame", r) == want


def test_banks_in_flight_is_silent_without_banks(monkeypatch):
    """Records whose stages carry no bank (a port before shape banks were
    marked) leave the reader silent."""
    from ffmpeg_ffv2_tpu_torch.utils.metrics import StageTrace
    tr = StageTrace()
    r = _banked(tr, 3, PIPELINED)
    old = SimpleNamespace(calls=lambda t0, t1: [
        SimpleNamespace(t0=c.t0, t1=c.t1, stages=[
            SimpleNamespace(name=s.name, kind=s.kind, t0=s.t0, t1=s.t1,
                            attempt=s.attempt) for s in c.stages])
        for c in tr.calls(t0, t1)])
    monkeypatch.setitem(sys.modules, spans.MODULE, SimpleNamespace(
        TRACE=old, SYNCS=()))
    assert _read("banks_in_flight_per_frame", r) is None
    assert _read("host_copy_ms_per_frame", r) > 0
