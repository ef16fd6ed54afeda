"""The shape banks in the stage recorder (``utils/metrics.py``), on the
CPU (every kernel wrapper runs its plain PyTorch version): a 32x33
yuv422p10 session at 4 slices has slice rows of 16 and 17 lines, so it
splits into two shape banks, and its ``encode()`` call record holds one
upload, bank 0's stages up to its K4 launch, then bank 1's, each bank's
cap-retry attempts counted from 0, then the call's own joint reads (a
render retry under the bank that retried), the stages still tiling the
call; a uniform geometry marks nothing new and keeps its stages; and the
benchmark's two readers of the bank spans (``portbench/metrics/bank_*``)."""

import sys
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest

from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu_torch.utils import metrics
from ffmpeg_ffv2_tpu_torch.utils.metrics import STAGE_KINDS, StageTrace
from portbench import harness, spans
from test_torch_formats import torch_one_thread  # noqa: F401

W = 32
SPLITS = ("host_enqueue_ms_per_frame", "host_copy_ms_per_frame",
          "host_wait_ms_per_frame", "host_packet_ms_per_frame")
READERS = ("bank_tail_ms_per_frame", "bank_pipelines_per_frame")


def _frames(n, h, seed=5):
    """10-bit noise over a gradient in luma, 10-bit noise in chroma."""
    rng = np.random.RandomState(seed)
    y = np.indices((h, W)).sum(0) * 29
    return [[((y + 7 * t + rng.randint(0, 64, (h, W))) % 1024)
             .astype(np.int32)]
            + [rng.randint(0, 1024, (h, W // 2)).astype(np.int32)
               for _ in range(2)] for t in range(n)]


def _session(h):
    cfg = FFV1Config(level=3, coder=1, context=1, slices=4, slicecrc=1,
                     gop_size=1)
    enc = DeviceFFV1Encoder(W, h, "yuv422p10", cfg, device="cpu")
    enc.trace = StageTrace()
    return enc


def _native(enc, frames):
    nat = NativeFFV1Codec(enc.p)
    return [nat.encode(f, True) for f in frames]


def _banks(call):
    """The call's stages as runs of one bank: [(bank, [stage, ...])]."""
    runs = []
    for s in call.stages:
        if not runs or runs[-1][0] != s.bank:
            runs.append((s.bank, []))
        runs[-1][1].append(s)
    return runs


def test_torch_bank_spans_two_banks_in_order(torch_one_thread):  # noqa: F811
    """One upload a call, then bank 0's pipeline up to its K4 launch,
    then bank 1's from its phase A, each with its cap-retry attempts
    counted from 0 (a session's first frames grow its caps); both banks'
    K4 launch before the call's one read of their lengths; that read, the
    one read of their bytes, the slice bytes and the trailers are the
    call's own (bank 0, attempt 0); the packets are the native codec's."""
    frames = _frames(2, 33)
    enc = _session(33)
    assert len(enc.banks) == 2
    assert [enc.encode(f) for f in frames] == _native(enc, frames)
    calls = enc.trace.calls()
    assert [c.name for c in calls] == ["encode"] * 2
    for c in calls:
        runs = _banks(c)
        assert [b for b, _ in runs] == [0, 1, 0]
        assert runs[0][1][0].name == "upload"
        assert runs[1][1][0].name == "phase_a"
        for _, st in runs[:2]:
            assert st[-1].name == "K4 rac_render"
            attempts = [s.attempt for s in st]
            assert attempts[0] == 0 and attempts == sorted(attempts)
        assert [(s.name, s.attempt) for s in runs[2][1]] == [
            ("lengths to host", 0), ("bytes to host", 0), ("slice bytes", 0),
            ("slice trailers + CRC", 0)]
        names = [s.name for s in c.stages]
        assert names.count("upload") == names.count("bytes to host") == 1
        assert names.count("lengths to host") == 1
        read = names.index("lengths to host")
        assert [s.bank for s in c.stages[:read]
                if s.name == "K4 rac_render"] == [0, 1]


@pytest.mark.parametrize("retried", [0, 1])
def test_torch_bank_spans_attempts_count_within_a_bank(
        torch_one_thread, retried):  # noqa: F811
    """A layout cap too small in one bank of a settled session: that
    bank's stages carry attempts from 0 up, the other bank's all 0, and the
    packet is still the native codec's."""
    frames = _frames(4, 33, seed=8)
    enc = _session(33)
    got = [enc.encode(f) for f in frames[:3]]     # the caps settle
    enc.banks[retried].caps.tiles_cap = 1
    got.append(enc.encode(frames[3]))
    assert got == _native(enc, frames)
    call = enc.trace.calls()[-1]
    by_bank = {}
    for b, st in _banks(call)[:2]:
        by_bank[b] = [s.attempt for s in st]
    assert by_bank[retried][0] == 0 and max(by_bank[retried]) >= 1
    assert by_bank[retried] == sorted(by_bank[retried])
    assert set(by_bank[1 - retried]) == {0}


@pytest.mark.parametrize("retried", [0, 1])
def test_torch_bank_spans_render_retry_under_its_bank(
        torch_one_thread, retried):  # noqa: F811
    """A render cap too small in one bank of a settled session: after the
    call's joint read of the lengths, that bank's K4 codes again and its
    lengths are read, both under its own bank at its next attempt; then
    the call's own bytes read; the packet is still the native codec's and
    the call reads the card five times."""
    frames = _frames(4, 33, seed=9)
    enc = _session(33)
    got = [enc.encode(f) for f in frames[:3]]     # the caps settle
    enc.banks[retried].caps.render_cap = 64
    got.append(enc.encode(frames[3]))
    assert got == _native(enc, frames)
    st = enc.trace.calls()[-1].stages
    names = [s.name for s in st]
    read = names.index("lengths to host")
    launched = [s for s in st[:read] if s.name == "K4 rac_render"]
    assert [s.bank for s in launched] == [0, 1]
    again = launched[retried].attempt + 1
    assert [(s.name, s.bank, s.attempt) for s in st[read:]] == [
        ("lengths to host", 0, 0), ("K4 rac_render", retried, again),
        ("lengths to host", retried, again), ("bytes to host", 0, 0),
        ("slice bytes", 0, 0), ("slice trailers + CRC", 0, 0)]
    assert sum(n in metrics.SYNCS for n in names) == 5


def test_torch_bank_spans_tile_the_call(torch_one_thread):  # noqa: F811
    """The stages of a two-bank call still tile it, so the benchmark's
    four host splits add up to the calls' time; the bank readers read
    two pipelines a frame and the time of bank 1's stages; a call reads
    the card four times (each bank's sizes, the lengths, the bytes) and
    once more a cap retry."""
    frames = _frames(3, 33, seed=9)
    enc = _session(33)
    enc.encode(frames[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, spans.MODULE, SimpleNamespace(
            TRACE=enc.trace, SYNCS=metrics.SYNCS))
        from portbench.drivers import frame_loop
        calls = frame_loop.drive(enc, frames, {}, 0, 3, None)
        r = SimpleNamespace(window_calls=calls)
        got = {k: harness.reader(k)(r) for k in SPLITS + READERS}
        syncs = harness.reader("host_syncs_per_frame")(r)
    records = enc.trace.calls(calls[0].t0, calls[-1].t1)
    assert len(records) == 3
    for c in records:
        st = c.stages
        assert st[0].t0 == c.t0 and st[-1].t1 == c.t1
        assert all(a.t1 == b.t0 for a, b in zip(st, st[1:]))
        assert all(s.kind == STAGE_KINDS[s.name] for s in st)
    assert sum(got[k] for k in SPLITS) == pytest.approx(
        1e3 * sum(c.t1 - c.t0 for c in records) / 3)
    assert got["bank_pipelines_per_frame"] == sum(
        len({(s.bank, s.attempt) for s in c.stages}) for c in records) / 3
    assert got["bank_pipelines_per_frame"] >= 2.0
    assert got["bank_tail_ms_per_frame"] == pytest.approx(1e3 * sum(
        s.t1 - s.t0 for c in records for s in c.stages if s.bank) / 3)
    assert got["bank_tail_ms_per_frame"] > 0
    reads = [4 + sum(max(s.attempt for s in c.stages if s.bank == b)
                     for b in (0, 1)) for c in records]
    assert syncs == pytest.approx(sum(reads) / 3)
    assert 4 in reads           # a call with no retry


ONE_BANK = ["upload", "phase_a", "layout", "K1 place", "s0", "K2 adapt",
            "emission_pack", "writeback", "unsort", "K3 expand",
            "sizes to host"]
ONE_BANK_TAIL = ["K4 rac_render", "lengths to host", "bytes to host",
                 "slice bytes", "slice trailers + CRC"]


def test_torch_bank_spans_one_bank_marks_nothing_new(
        torch_one_thread):  # noqa: F811
    """A uniform geometry (rows of 17 and 17 lines): one pipeline, every
    stage bank 0, the stages a range call always leaves, in order, its
    K4 read before anything else: the first frame grows its layout caps
    once (a second attempt from the layout on), the second fits."""
    frames = _frames(2, 34)
    enc = _session(34)
    assert len(enc.banks) == 1
    assert [enc.encode(f) for f in frames] == _native(enc, frames)
    first, second = enc.trace.calls()
    assert {s.bank for c in (first, second) for s in c.stages} == {0}
    assert [s.name for s in first.stages] == (ONE_BANK + ONE_BANK[2:]
                                              + ONE_BANK_TAIL)
    assert [s.name for s in second.stages] == ONE_BANK + ONE_BANK_TAIL
    assert [s.attempt for s in first.stages] == [0] * 11 + [1] * 14


def test_torch_bank_spans_recorder_and_helper():
    """``bank(i)`` sets the open call's bank and starts its attempts at
    0, ``bank(i, a)`` at attempt a; outside a call, and on a hook that is
    not a StageTrace, it records nothing."""
    tr = StageTrace()
    tr.bank(1)                      # no open call: nothing
    metrics.bank(metrics.no_mark, 1)
    with tr.call("encode", 1) as call:
        tr("upload")
        tr.retry()
        tr("layout")
        metrics.bank(tr, 1)
        tr("upload")
        tr.retry()
        tr("layout")
        metrics.bank(tr, 0, 2)
        tr("K4 rac_render")
        metrics.bank(tr, 0)
        tr("slice trailers + CRC")
    assert [(s.name, s.attempt, s.bank) for s in call.stages] == [
        ("upload", 0, 0), ("layout", 1, 0), ("upload", 0, 1),
        ("layout", 1, 1), ("K4 rac_render", 2, 0),
        ("slice trailers + CRC", 0, 0)]
    assert tr.counts == {"upload": 2, "layout": 2, "K4 rac_render": 1,
                         "slice trailers + CRC": 1}
    assert call.stage_ms().keys() == {"upload", "layout", "K4 rac_render",
                                      "slice trailers + CRC"}


class _OldStage(NamedTuple):
    """A stage record as a port without bank marks keeps it."""
    name: str
    kind: str | None
    t0: float
    t1: float
    attempt: int


def _built(tr, n, retry_in_bank=None):
    """``n`` two-bank calls recorded on ``tr``, each bank's three stages
    10 ms apart on a made-up clock; one retry in bank ``retry_in_bank``
    of every call."""
    clock = iter(np.arange(0, 1000, 0.01))
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics, "time", SimpleNamespace(
            perf_counter=lambda: next(clock)))
        for t in range(n):
            with tr.call("encode", 1) as rec:
                for b in (0, 1):
                    tr.bank(b)
                    tr("upload")
                    if b == retry_in_bank:
                        tr.retry()
                    tr("layout")
                    tr("bytes to host")
                tr.bank(0)
                tr("slice trailers + CRC")
            calls.append(harness.Call(rec.t0, rec.t1, [t], []))
    return SimpleNamespace(window_calls=calls)


@pytest.mark.parametrize("retry_in_bank,pipelines", [(None, 2.0), (0, 3.0),
                                                     (1, 3.0)])
def test_torch_bank_spans_readers_on_built_records(monkeypatch,
                                                   retry_in_bank, pipelines):
    """Bank 1's three stages take 30 ms a call; the pipelines are the
    (bank, attempt) pairs; records without a bank leave both silent."""
    tr = StageTrace()
    monkeypatch.setitem(sys.modules, spans.MODULE, SimpleNamespace(
        TRACE=tr, SYNCS=metrics.SYNCS))
    r = _built(tr, 4, retry_in_bank)
    tail = harness.reader("bank_tail_ms_per_frame")(r)
    assert tail == pytest.approx(30.0)
    assert harness.reader("bank_pipelines_per_frame")(r) == pipelines
    old = SimpleNamespace(calls=lambda t0, t1: [
        SimpleNamespace(t0=c.t0, t1=c.t1, stages=[
            _OldStage(*s[:5]) for s in c.stages]) for c in tr.calls(t0, t1)])
    monkeypatch.setitem(sys.modules, spans.MODULE, SimpleNamespace(
        TRACE=old, SYNCS=metrics.SYNCS))
    for k in READERS:
        assert harness.reader(k)(r) is None
    assert harness.reader("host_copy_ms_per_frame")(r) > 0
