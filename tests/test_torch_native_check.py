"""``ffmpeg_ffv2_tpu_torch/tools/native_check.py`` on this host at 160x120:
builds of the native runtime at the shipped flags and at -O3 give an -O0
build's packets, pass-1 tallies and decodes in every case, and the check
reports what differs."""

import json

from ffmpeg_ffv2_tpu_torch.ffv1 import native
from ffmpeg_ffv2_tpu_torch.tools import native_check as nc

W, H = 160, 120


def test_torch_native_check_builds_agree(tmp_path):
    """The tool's matrix passes for the shipped and -O3 builds and exits
    0; its summary names no failing case."""
    assert nc.main(["--size", f"{W}x{H}", "--variants", "shipped,O3",
                    "--out", str(tmp_path)]) == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["failing"] == []
    assert set(summary["matrix"]["O3"]) == set(nc.CASES)
    assert all(v == "ok" for r in summary["matrix"].values()
               for v in r.values())


def test_torch_native_check_reports_a_difference():
    """A reference whose tallies or packet differ is not ``ok``; the
    frames are ``chip_smoke.synth_1080p_frames``' recipe at this size."""
    case = "yuv420p_range_stats"
    refs = nc.references(nc.build_variants(["O0"]),
                         [case], 2, W, H)
    frames, (pkts, tallies) = refs[case]
    lib = native.get_lib()
    assert nc.check_case(lib, case, frames, (pkts, tallies), W, H) == "ok"
    bad = tallies[:-1] + bytes([tallies[-1] ^ 1])
    assert "tallies differ" in nc.check_case(lib, case, frames,
                                             (pkts, bad), W, H)
    longer = [pkts[0], pkts[1] + b"\0"]
    assert "frame 1:" in nc.check_case(lib, case, frames, (longer, tallies),
                                       W, H)


def test_torch_native_build_keyed_by_compiler(monkeypatch):
    """The native library's build path changes with the compiler's
    version, so that a checkout copied between hosts never loads a build
    of another g++; it stays with the same compiler, flags and sources."""
    path = native.library_path()
    assert native.library_path() == path
    monkeypatch.setattr(native, "_compiler_id", lambda: "g++ (other) 13.3.0")
    assert native.library_path() != path
    assert native.library_path(["-O2"]) != native.library_path()
