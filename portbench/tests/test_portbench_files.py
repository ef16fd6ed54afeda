"""The harness finds every configuration, cell, traffic mix and metric by
name, and a file added beside them is found with no edit to its code."""

import ast
import json
import os
import shutil

import pytest

from portbench import harness

ROOT = harness.ROOT
PB = os.path.join(ROOT, "portbench")
BANNED = {"jax", "jaxlib", "ffmpeg_ffv2_tpu"}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["width"] * c.config["height"] > 0
    loop = harness.part("drivers", c.traffic["driver"])
    loop.check(c.traffic, c.config)
    assert callable(loop.drive)
    assert callable(harness.part("reference", c.config["reference"]).packets)
    assert callable(harness.part("gen", c.config["frames"]).pool)
    assert os.path.exists(os.path.join(PB, "programs",
                                       c.config["program"] + ".py"))
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))


def test_every_metric_has_a_reader_and_a_moved_metric():
    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert os.path.exists(os.path.join(PB, "metrics", m["name"] + ".py"))
    for m in s["per_layer"]:
        assert m["moves"] in e2e


def test_config_files_match_their_entries():
    for c in spec()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]


def test_added_files_are_found_without_a_code_edit(tmp_path):
    """A configuration with a program adapter of its own, a traffic mix
    with a driver loop of its own, a cell and a metric, added as files and
    entries only, are found, and a whole run of the new cell goes through
    the new adapter and the new driver loop."""
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    s = spec()
    s["configs"].append({"name": "ffv1-v3-range-360p",
                         "source": "https://example.org/x",
                         "file": "portbench/configs/ffv1-v3-range-360p.json",
                         "reduced": [], "why": "a new deployment"})
    with open(os.path.join(PB, "configs", "ffv1-v3-range-1080p.json")) as f:
        conf = json.load(f)
    conf.update(width=192, height=160, gop=3, program="cpu_port")
    # a program adapter of its own: here the port on the CPU
    (tmp_path / "portbench/programs/cpu_port.py").write_text(
        "from portbench.tests.faults import CpuPort as Program\n")
    (tmp_path / "portbench/configs/ffv1-v3-range-360p.json").write_text(
        json.dumps(conf))
    (tmp_path / "portbench/drivers/paced_loop.py").write_text(
        "import time\n"
        "from portbench.harness import Call\n"
        "def check(traffic, config):\n"
        "    pass\n"
        "def drive(enc, pool, traffic, first, n, until):\n"
        "    calls, t = [], first\n"
        "    while n is None or len(calls) < n:\n"
        "        t0 = time.perf_counter()\n"
        "        if until is not None and t0 >= until:\n"
        "            break\n"
        "        pk = enc.encode(pool[t % len(pool)])\n"
        "        calls.append(Call(t0, time.perf_counter(), [t], [pk]))\n"
        "        t += 1\n"
        "        time.sleep(traffic['gap_s'])\n"
        "    return calls\n")
    (tmp_path / "portbench/traffic/paced.json").write_text(json.dumps(
        {"driver": "paced_loop", "gap_s": 0.01, "pool": 6,
         "warmup_calls": 2, "trace_calls": 2}))
    (tmp_path / "portbench/metrics/frames_in_window.py").write_text(
        "def read(run):\n    return len(run.window_calls)\n")
    s["workloads"].append({"name": "range-360p-paced",
                           "config": "ffv1-v3-range-360p",
                           "traffic": "paced", "chips": 1, "why": "new"})
    s["per_layer"].append({"name": "frames_in_window", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "session", "moves": "encode_mpix_s",
                           "workloads": ["range-360p-paced"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    c = harness.load_cell("range-360p-paced", root=str(tmp_path))
    assert c.config["height"] == 160 and c.traffic["gap_s"] == 0.01
    assert "frames_in_window" in [m["name"] for m in c.per_layer]
    out = harness.run_cell(c, 2 ** 31 + 5, 0.3, False,
                           log=lambda *a, **k: None)
    assert out["correct"] and out["attempted"] >= 1
    run = harness.Run(cell=c, seconds=1.0, setup_s=1.0,
                      window_calls=[None] * 3, pixels_per_frame=1,
                      launches={}, n_calls=3, n_frames=3,
                      peak_window_bytes=0)
    assert harness.reader("frames_in_window", str(tmp_path))(run) == 3
    other = harness.load_cell("range-1080p-stream", root=str(tmp_path))
    assert "frames_in_window" not in [m["name"] for m in other.per_layer]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _py_files(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_file_imports_jax_or_the_jax_package():
    for path in _py_files(PB):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & BANNED, (path, tops & BANNED)


def test_the_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(PB, "reference")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "ffmpeg_ffv2_tpu_torch" not in tops, path
        assert tops <= {"__future__", "binascii", "concurrent", "ctypes",
                        "hashlib", "importlib", "numpy", "os", "subprocess",
                        "tempfile", "threading"}, (path, tops)
