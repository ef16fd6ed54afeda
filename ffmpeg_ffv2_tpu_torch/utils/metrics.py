"""Copy of ``ffmpeg_ffv2_tpu/utils/metrics.py``.

Observability: structured per-stage timing and per-frame codec stats.

The framework counterpart of the reference's START_TIMER/STOP_TIMER TSC
macros (libavutil/timer.h), `ffmpeg -benchmark` reporting, and the Daala
EC's entropy-vs-bits accounting (daala_entropy.c:612).  Collectors are
explicit objects, not globals, so sessions can expose their own stats.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    """Accumulates wall time per named stage; use as a context manager."""
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 4),
                       "calls": self.counts[name],
                       "avg_ms": round(1000 * self.totals[name]
                                       / max(self.counts[name], 1), 3)}
                for name in sorted(self.totals)}

    def json(self) -> str:
        return json.dumps(self.report())


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
