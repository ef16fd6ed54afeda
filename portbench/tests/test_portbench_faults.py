"""Whole runs on the CPU at a small size, through ``run_cell`` with all
its guards, the port standing in on its plain versions (``CpuPort``, no
counters): sound runs come out correct and print the benchmark's last
line; the control and each fault that a cell can have come out not
correct."""

import dataclasses
import json

import pytest

from portbench import harness
from portbench.tests.faults import CpuPort, program_for

SEED = 2 ** 31 + 11


def small(cell_name: str, gop: int | None = None) -> harness.Cell:
    """The cell at 192x160 (its slices still fit), a pool of 8 frames,
    batches of 2; ``gop`` where a test asks for inter frames."""
    c = harness.load_cell(cell_name)
    tr = {**c.traffic, "pool": 8, "warmup_calls": 2, "trace_calls": 2}
    if "batch" in tr:
        tr["batch"] = 2
    return dataclasses.replace(
        c, config={**c.config, "width": 192, "height": 160,
                   "gop": gop or c.config["gop"]}, traffic=tr)


def run(cell, program=None, trace=False, seconds=0.5, gop=None):
    lines = []
    out = harness.run_cell(small(cell, gop), SEED, seconds, trace,
                           program=program or CpuPort(),
                           log=lambda *a, **k: lines.append(" ".join(a)))
    return out, lines


def check_schema(out, lines, trace):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    json.dumps(out)
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert out["checks"]["packets_wrong"]["limit"] == 0
    assert lines[-1].startswith("check packets_wrong ")
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        for k in ("device_ops", "idle_gaps"):
            assert len(out["breakdown"][k]) <= 10


@pytest.mark.parametrize("cell", ["range-1080p-stream", "rice-1080p-stream",
                                  "range-1080p-intra-b8"])
def test_a_sound_run_is_correct(cell):
    out, lines = run(cell)
    check_schema(out, lines, False)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert {"encode_mpix_s", "setup_s"} <= set(out["metrics"])


def test_a_traced_run_prints_the_breakdown():
    out, lines = run("rice-1080p-stream", trace=True, seconds=3.0)
    check_schema(out, lines, True)
    assert out["correct"]
    # the untraced window after the traced calls holds the tail
    assert "frame_ms_p95.host_paced" in out["metrics"]


@pytest.mark.parametrize("cell,fault", [
    ("range-1080p-stream", "control"),
    ("rice-1080p-stream", "control"),
    ("range-1080p-intra-b8", "control"),
    ("range-1080p-intra-b8", "half_batch"),
    ("range-1080p-stream", "altered_byte"),
    ("rice-1080p-stream", "altered_byte"),
    ("range-1080p-intra-b8", "altered_byte"),
])
def test_the_control_and_each_fault_come_out_not_correct(cell, fault):
    out, lines = run(cell, program_for(fault, CpuPort()))
    check_schema(out, lines, False)
    assert not out["correct"]
    assert out["checks"]["packets_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", ["range-1080p-stream", "rice-1080p-stream"])
def test_a_step_that_keeps_its_state_comes_out_not_correct(cell):
    """The configurations are all-intra, so no cell carries context
    states across frames yet; a stream cell with inter frames (gop 4
    here) catches a step that hands its states back unchanged."""
    out, lines = run(cell, gop=4)
    assert out["correct"]
    out, lines = run(cell, program_for("stale_state", CpuPort()), gop=4)
    check_schema(out, lines, False)
    assert not out["correct"]
    assert out["checks"]["packets_wrong"]["value"] > 0
