"""Observability: the stage recorder of the port's sessions, per-frame
codec stats and context-model occupancy.

``FrameStats``, ``packet_slice_sizes`` and ``context_occupancy`` are
copies of ``ffmpeg_ffv2_tpu/utils/metrics.py``.  ``StageTrace`` is the
port's own: the recorder behind every ``mark(stage, inputs=None)`` hook of
the sessions, on the host clock (``time.perf_counter``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import NamedTuple

import torch.autograd.profiler as _profiler

# each stage name's kind: ``copy`` moves frame data between the host and
# the card; ``wait`` blocks the host on a read of the card's results;
# ``host`` is host-only work (the packet, set-up); ``enqueue`` launches
# work on the card (torch ops and the port's kernels)
STAGE_KINDS = {
    # the FFV1 session (ffv1/device_coder.py, ffv1/rice.py)
    "upload": "copy",
    "phase_a": "enqueue",
    "RCT costs to host": "wait",
    "layout": "enqueue",
    "K1 place": "enqueue",
    "s0": "enqueue",
    "K2 adapt": "enqueue",
    "emission_pack": "enqueue",
    "K6 adapt_emission": "enqueue",
    "K5 vlc": "enqueue",
    "writeback": "enqueue",
    "unsort": "enqueue",
    "K3 expand": "enqueue",
    "compact events": "enqueue",
    "ladder kernel": "enqueue",
    "ladder delivery": "enqueue",
    "bit elements": "enqueue",
    "bit assembly": "enqueue",
    "sizes to host": "wait",
    "K4 rac_render": "enqueue",
    "lengths to host": "wait",
    "bytes to host": "copy",
    "slice bytes": "host",
    "slice trailers + CRC": "host",
    # the sharded FFV1 encoder (parallel/ffv1.py)
    "encode": "enqueue",
    "gather": "copy",
    "assemble": "host",
    # FFV2 (ffv2/device.py, ffv2/native.py, parallel/ffv2.py)
    "host pad + header": "host",
    "host cast + upload": "copy",
    "Q12 + K19 lap_pre": "enqueue",
    "block split + transform": "enqueue",
    "zigzag": "enqueue",
    "K18 pvq": "enqueue",
    "pack + copy down": "copy",
    "front_q": "enqueue",
    "host icbrt": "host",
    "host Daala coder": "host",
    "host Daala decode": "host",
    "host concatenate + upload": "copy",
    "inverse zigzag + transform": "enqueue",
    "K19 lap_post": "enqueue",
    "copy down": "copy",
    "upload + Q12 + K19 horizontal": "copy",
    "halo exchange": "wait",
    "K19 vertical + halo slabs": "enqueue",
    "transform + zigzag + K18": "enqueue",
    "gather + copy down": "copy",
    # set-up (_build.load, DeviceFFV1Encoder.__init__)
    "build": "host",
    "library bind": "host",
    "session tables": "host",
}
# the stages that end in a read of the card's results, for which the host
# waits on the stream: every ``wait`` stage and the copies down
SYNCS = frozenset({k for k, v in STAGE_KINDS.items() if v == "wait"}
                  | {"bytes to host", "gather", "copy down",
                     "pack + copy down", "gather + copy down"})
# the prefix of the profiler event that each boundary leaves while a
# ``torch.profiler`` profile records
EVENT_PREFIX = "stage: "
RING = 1 << 16
_CALL_IDS = itertools.count()       # call ids, unique in the process


def no_mark(stage: str, inputs=None):
    """A ``mark`` hook that records nothing: called after each stage with
    its name and, after a kernel, the kernel's inputs (a tuple)."""


class Stage(NamedTuple):
    """One stage of a call: it ran from ``t0`` (the call's previous
    boundary, or its start) to ``t1`` (its own boundary), host clock;
    ``attempt`` is the cap-retry loop's attempt it belongs to, counted
    within its shape bank; ``bank`` is the shape bank whose pipeline it
    belongs to (0 in a session without banks, and for the stages of the
    call outside its bank loop)."""
    name: str
    kind: str | None
    t0: float
    t1: float
    attempt: int
    bank: int = 0


class CallRecord:
    """A call's root span: opened by ``StageTrace.call``, it ends at its
    last boundary (at its close when nothing marked it).  Its stages tile
    it in order; a nested call's time lies inside the enclosing call's
    next stage."""

    __slots__ = ("id", "name", "frames", "t0", "t1", "parent", "attempt",
                 "bank", "last", "marks", "_trace")

    def __init__(self, trace, cid: int, name: str, frames: int):
        self._trace = trace
        self.id, self.name, self.frames = cid, name, frames
        self.t0 = self.t1 = self.last = 0.0
        self.parent = None
        self.attempt = self.bank = 0
        self.marks = []         # (stage, t0, t1, attempt, bank)

    def __enter__(self):
        self._trace._open(self)
        return self

    def __exit__(self, *exc):
        self._trace._close(self)
        return False

    @property
    def stages(self) -> list:
        return [Stage(n, STAGE_KINDS.get(n), a, b, k, bk)
                for n, a, b, k, bk in self.marks]

    def stage_ms(self) -> dict:
        """Stage -> host ms in this call, summed over repeats, in the order
        of each stage's first end."""
        out = {}
        for n, a, b, *_ in self.marks:
            out[n] = out.get(n, 0.0) + (b - a) * 1e3
        return out


class _Open(threading.local):
    """The calling thread's innermost open call."""
    rec = None


class StageTrace:
    """The stage recorder: a ``mark(stage, inputs=None)`` hook that closes
    the named stage of the calling thread's open call at each boundary.

    ``call(name, frames)`` opens a call record (the root span) of a call
    that carries ``frames`` frames.  Each mark inside it records a stage
    from the previous boundary to now; a mark outside any call has no
    start and records nothing.  Closed calls go into a ring that holds
    the last ``ring`` boundaries; the recorder also keeps each stage's
    running total (seconds) and count.  While a ``torch.profiler``
    profile records, each boundary also leaves a zero-length host event
    named ``EVENT_PREFIX + stage``, which encloses no work and no device
    op."""

    def __init__(self, ring: int = RING):
        self.cap = ring
        self.totals = {}        # stage: seconds
        self.counts = {}        # stage: boundaries
        self._ring = deque()    # closed CallRecords, oldest first
        self._held = 0          # boundaries (stages + roots) in the ring
        self._lost_t1 = None    # the latest end of a call the ring dropped
        self._lock = threading.Lock()
        self._local = _Open()

    def __call__(self, stage: str, inputs=None):
        rec = self._local.rec
        if rec is not None:
            t = time.perf_counter()
            rec.marks.append((stage, rec.last, t, rec.attempt, rec.bank))
            rec.last = t
        if _profiler._is_profiler_enabled:
            with _profiler.record_function(EVENT_PREFIX + stage):
                pass

    def call(self, name: str, frames: int) -> CallRecord:
        """A context manager that opens a call record on entry and closes
        it on exit (an exception included); yields the record."""
        return CallRecord(self, next(_CALL_IDS), name, frames)

    def retry(self):
        """The open call's cap-retry loop starts its next attempt."""
        rec = self._local.rec
        if rec is not None:
            rec.attempt += 1

    def bank(self, i: int, attempt: int = 0):
        """The open call's next stages belong to shape bank ``i``, at its
        cap-retry attempt ``attempt`` (a bank's attempts count from 0)."""
        rec = self._local.rec
        if rec is not None:
            rec.bank, rec.attempt = i, attempt

    def _open(self, rec: CallRecord):
        rec.parent = self._local.rec
        rec.t0 = rec.last = time.perf_counter()
        self._local.rec = rec

    def _close(self, rec: CallRecord):
        self._local.rec = rec.parent
        rec.t1 = rec.last if rec.marks else time.perf_counter()
        with self._lock:
            for n, a, b, *_ in rec.marks:
                self.totals[n] = self.totals.get(n, 0.0) + (b - a)
                self.counts[n] = self.counts.get(n, 0) + 1
            self._ring.append(rec)
            self._held += len(rec.marks) + 1
            while self._held > self.cap:
                old = self._ring.popleft()
                self._held -= len(old.marks) + 1
                self._lost_t1 = (old.t1 if self._lost_t1 is None
                                 else max(self._lost_t1, old.t1))

    def calls(self, t0: float = float("-inf"),
              t1: float = float("inf")) -> list | None:
        """The closed root calls (no enclosing call) that lie inside
        [t0, t1] on the host clock, oldest first; None when the ring has
        dropped a call that ended at or after ``t0``."""
        with self._lock:
            if self._lost_t1 is not None and self._lost_t1 >= t0:
                return None
            return [r for r in self._ring if r.parent is None
                    and t0 <= r.t0 and r.t1 <= t1]

    def last(self) -> CallRecord | None:
        """The newest closed call, or None."""
        with self._lock:
            return self._ring[-1] if self._ring else None


def span(mark, name: str, frames: int):
    """``mark.call(name, frames)`` when ``mark`` is a StageTrace, else a
    context that records nothing (a caller's own ``mark`` hook)."""
    return (mark.call(name, frames) if isinstance(mark, StageTrace)
            else nullcontext())


def retry(mark):
    """Count the next cap-retry attempt on ``mark`` when it is a
    StageTrace."""
    if isinstance(mark, StageTrace):
        mark.retry()


def bank(mark, i: int, attempt: int = 0):
    """Start shape bank ``i``'s stages, at its cap-retry attempt
    ``attempt``, on ``mark`` when it is a StageTrace."""
    if isinstance(mark, StageTrace):
        mark.bank(i, attempt)


# the process's recorder: the default ``mark`` of the sessions
TRACE = StageTrace()


@dataclass
class FrameStats:
    """Per-frame encode statistics: bytes per plane/slice, pixel rate."""
    frames: int = 0
    pixels: int = 0
    bytes_out: int = 0
    keyframes: int = 0
    slice_bytes: list = field(default_factory=list)

    def add_frame(self, n_pixels: int, packet: bytes, keyframe: bool,
                  slice_sizes=None):
        self.frames += 1
        self.pixels += n_pixels
        self.bytes_out += len(packet)
        self.keyframes += 1 if keyframe else 0
        if slice_sizes:
            self.slice_bytes.append(list(slice_sizes))

    def report(self) -> dict:
        out = {
            "frames": self.frames,
            "keyframes": self.keyframes,
            "bytes_out": self.bytes_out,
            "bits_per_pixel": round(8 * self.bytes_out
                                    / max(self.pixels, 1), 4),
        }
        if self.slice_bytes:
            flat = [b for fr in self.slice_bytes for b in fr]
            mean = sum(flat) / len(flat)
            out["slice_mean_bytes"] = round(mean, 1)
            out["slice_max_bytes"] = max(flat)
            # load imbalance = max/mean over the last frame (the number
            # a slice-parallel schedule is bound by)
            last = self.slice_bytes[-1]
            out["slice_imbalance"] = round(
                max(last) / max(sum(last) / len(last), 1e-9), 3)
        return out


def packet_slice_sizes(packet: bytes, ec: bool, version: int = 3):
    """Walk an FFV1 packet's slice-trailer chain (ffv1enc.c:1236-1262:
    3-byte big-endian size [+ 5-byte CRC region when ec]) back to front.

    Returns [(offset, length_incl_trailer, crc_ok)] front-to-back —
    per-slice coded sizes for ANY backend's packets (native, device,
    hybrid), since the trailer layout is normative.  crc_ok is None when
    ec is off (nothing to check).  version <= 2 packets are one region.

    A complete walk covers the packet exactly (every v3+ slice carries a
    trailer, ffv1enc.c:1236).  If the chain is malformed, the leading
    bytes the walk could not attribute are returned as a first region
    with crc_ok=False so callers can tell coverage is partial.
    """
    from ..core.crc import crc32_ieee
    trailer = 3 + (5 if ec else 0)
    if version < 3:
        return [(0, len(packet), None)]
    regions = []
    end = len(packet)
    while trailer <= end:
        size = int.from_bytes(packet[end - trailer:end - trailer + 3],
                              "big")
        if size + trailer > end:
            break
        off, length = end - size - trailer, size + trailer
        crc_ok = (crc32_ieee(packet[off:off + length]) == 0) if ec \
            else None
        regions.append((off, length, crc_ok))
        end -= size + trailer
    if end > 0:
        regions.append((0, end, False))     # residual: walk incomplete
    regions.reverse()
    return regions


def context_occupancy(rc_stat2) -> dict:
    """Context-model usage from 2-pass stats (rc_stat2[nctx, 32, 2],
    ffv1/twopass.py): how much of the quantized context space the
    content actually visits, and how concentrated the symbol mass is —
    the observable SURVEY §5 asks for (reference analogue: the rc_stat
    tables ffv1enc.c:793 drives its initial-state search with)."""
    import numpy as np
    s = np.asarray(rc_stat2, dtype=np.uint64)
    per_ctx = s.sum(axis=(1, 2))
    total = int(per_ctx.sum())
    used = int((per_ctx > 0).sum())
    top = np.sort(per_ctx)[::-1]
    k = max(1, used // 10)
    return {
        "contexts": int(s.shape[0]),
        "contexts_used": used,
        "occupancy": round(used / max(s.shape[0], 1), 4),
        "symbols": total,
        "top10pct_mass": round(float(top[:k].sum()) / max(total, 1), 4),
    }
