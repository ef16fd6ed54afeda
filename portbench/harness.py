"""One run of one cell: set-up, the measured window, the traced segment,
the check against the reference, and the result.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``; its configuration in the file that the configuration
names, and through it the program adapter (``programs/<program>.py``), the
plain reference (``reference/<reference>.py``) and the frame generator
(``gen/<frames>.py``); its traffic mix in ``traffic/<traffic>.json``, and
through it the driver loop (``drivers/<driver>.py``); and each metric's
reader in ``metrics/<metric>.py``.  A new cell, configuration, codec,
traffic mix, driver loop or metric is a new file and a new entry, never
an edit here.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "ffmpeg_ffv2_tpu")
# the numbers that decide ``correct``, each with its limit
LIMITS = {"packets_wrong": 0}


class RunFailed(RuntimeError):
    """A run that must print no result."""


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    root: str = ROOT


def load_cell(name: str, root: str = ROOT) -> Cell:
    """Cell ``name`` of ``root``'s BENCHMARK.json, with its configuration
    file, its traffic file and the metrics that it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise RunFailed(f"no cell {name!r} in BENCHMARK.json; cells: "
                        f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return Cell(name, config, traffic, w["chips"], mine(spec["end_to_end"]),
                mine(spec["per_layer"]), root)


def part(kind: str, name: str, root: str = ROOT):
    """The module ``portbench/<kind>/<name>.py`` of ``root``: a driver
    loop, a program adapter, a reference, a frame generator or a metric's
    reader.  Loaded once a process."""
    path = os.path.join(root, "portbench", kind, name + ".py")
    modname = f"portbench.{kind}.{name.replace('.', '_')}"
    mod = sys.modules.get(modname)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    """The ``read(run)`` function of ``portbench/metrics/<metric>.py``."""
    return part("metrics", metric, root).read


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


@dataclass
class Call:
    """One call into the encoder, as a driver loop records it: host-clock
    start and end, the session's frame numbers it carried, and the packets
    it returned (one a frame, in order)."""
    t0: float
    t1: float
    frames: list
    packets: list


@dataclass
class Trace:
    """The traced segment as the profiler saw it (seconds)."""
    window_s: float
    busy_s: float
    frames: int
    lib_s: dict = field(default_factory=dict)    # library kernel: seconds
    other_s: dict = field(default_factory=dict)  # other device op: seconds
    gaps_s: dict = field(default_factory=dict)   # host op: idle seconds


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    seconds: float
    setup_s: float
    window_calls: list          # the untraced calls returned inside the window
    pixels_per_frame: int
    launches: dict              # kernel: launches over the run's calls
    n_calls: int                # calls whose launches ``launches`` holds
    n_frames: int
    peak_window_bytes: int
    trace: Trace | None = None
    work: list | None = None    # the reference's work counts, a pool frame
    traced_pool_frames: list | None = None


def _short(name: str) -> str:
    """A device op's name without its return type, arguments and template
    arguments: ``void (anonymous namespace)::k<4, f<2>>(int*)`` -> ``k``,
    ``void at::native::f<g::operator()(int)>(int)`` -> ``at::native::f``."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    out, depth = [], 0
    for ch in n:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif depth == 0:
            if ch == "(":
                break
            out.append(ch)
    return "".join(out).strip()


def _on_device(e) -> bool:
    import torch
    return e.device_type != torch.autograd.DeviceType.CPU


def device_times(prof, lib_names: set) -> tuple:
    """A device-only profile's seconds by op, split into the library's
    kernels and the rest (torch's kernels and copies), and the seconds in
    which any of them ran (their union)."""
    lib_s, other_s, spans = {}, {}, []
    for e in prof.events():
        if not _on_device(e) or e.name.startswith("portbench."):
            continue    # a host op, or the benchmark's own span
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        spans.append((s, t))
        short = _short(e.name)
        book = lib_s if short.split("::")[-1] in lib_names else other_s
        book[short] = book.get(short, 0.0) + (t - s)
    busy, cur = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    return lib_s, other_s, busy


def idle_gaps(prof, span: str) -> dict:
    """A host and device profile's idle device seconds inside ``span``, by
    the host op in progress in the middle of each gap (the innermost;
    ``host: outside torch ops`` where only the benchmark's span runs)."""
    import bisect

    dev, host, win = [], [], None
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith("portbench."):
            if e.name == span and not _on_device(e):
                win = (s, t)
        elif _on_device(e):
            dev.append((s, t))
        else:
            host.append((s, t, e.name))
    if win is None:
        raise RunFailed(f"the profile holds no {span!r} span")
    host.sort()
    starts = [h[0] for h in host]
    gaps, cur = {}, win[0]
    for s, t in sorted(dev) + [(win[1], win[1])]:
        if s > cur:
            mid = (cur + min(s, win[1])) / 2
            name = "host: outside torch ops"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 5000, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            gaps[name] = gaps.get(name, 0.0) + min(s, win[1]) - cur
        cur = max(cur, t)
    return gaps


def traced_segment(drive, enc, pool, tr, first, program) -> tuple:
    """The first ``trace_calls`` calls under a device-only profile, whose
    host cost is small (the device's times and busy share), then as many
    under a host and device profile, whose per-op host cost stretches the
    gaps (what the host did in each gap).  Returns their calls, the
    device-only span's seconds on the host clock, the two profiles, and
    the pool frames of the device-only profile."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = tr["trace_calls"]
    with profile(activities=program.activities()) as light:
        program.sync()
        t0 = time.perf_counter()
        calls = drive(enc, pool, tr, first, n, None)
        program.sync()
        window_s = time.perf_counter() - t0
    with profile(activities=list({ProfilerActivity.CPU,
                                  *program.activities()})) as heavy:
        with record_function("portbench.host"):
            more = drive(enc, pool, tr, calls[-1].frames[-1] + 1, n, None)
            program.sync()
    pool_frames = [t % len(pool) for k in calls for t in k.frames]
    return calls + more, window_s, light, heavy, pool_frames


def summarize(window_s, light, heavy, frames: int, lib_names: set) -> Trace:
    """The traced segment's Trace, from its two profiles."""
    lib_s, other_s, busy = device_times(light, lib_names)
    return Trace(window_s=window_s, busy_s=busy, frames=frames, lib_s=lib_s,
                 other_s=other_s, gaps_s=idle_gaps(heavy, "portbench.host"))


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().replace("\n", "; ") or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def host_probe_ms() -> float:
    """The milliseconds a fixed piece of Python work takes: the host's
    speed, printed before and after each window so that a drift of the
    host between runs shows beside their rates."""
    t, x = time.perf_counter(), 0
    for i in range(300_000):
        x = (x * 31 + i) & 0xFFFF
    return 1e3 * (time.perf_counter() - t)


def check(calls: list, expected: list) -> dict:
    """Every packet of ``calls`` against the reference's: frame t of the
    session is pool frame t % len(expected).  A packet that differs by a
    byte is wrong, and so is every frame of a call that returned another
    number of packets than it took frames."""
    wrong = checked = 0
    for c in calls:
        for k, t in enumerate(c.frames):
            checked += 1
            if (len(c.packets) != len(c.frames)
                    or c.packets[k] != expected[t % len(expected)]):
                wrong += 1
    return {"packets_wrong": wrong, "packets_checked": checked}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             program=None, t_start: float | None = None,
             log=print) -> dict:
    """One run; returns the result line's object.  ``program`` is the
    system under test, the configuration's program adapter by default."""
    t_start = time.perf_counter() if t_start is None else t_start
    c, tr = cell.config, cell.traffic
    loop = part("drivers", tr["driver"], cell.root)
    loop.check(tr, c)
    if program is None:
        program = part("programs", c["program"], cell.root).Program()
    program.load()
    plain0 = program.plain_calls()
    pool = part("gen", c["frames"], cell.root).pool(seed, tr["pool"], c)
    enc = program.encoder(c)
    warm = loop.drive(enc, pool, tr, 0, tr["warmup_calls"], None)
    first = warm[-1].frames[-1] + 1
    del warm
    program.sync()
    setup_peak = program.peak_bytes()
    program.reset_peak()
    gc.collect()
    found = banned_modules()
    if found:
        raise RunFailed(f"set-up loaded {found}")
    launches0 = program.launches()
    setup_s = time.perf_counter() - t_start
    probe = [host_probe_ms()]

    traced, trace_summary, traced_pool = [], None, None
    if trace:
        # the traced calls, then a window of ``seconds`` untraced ones
        traced, span_s, light, heavy, traced_pool = traced_segment(
            loop.drive, enc, pool, tr, first, program)
        first = traced[-1].frames[-1] + 1
    # what set-up left behind is never collected again; no collection
    # pauses the window
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        end = time.perf_counter() + seconds
        calls = traced + loop.drive(enc, pool, tr, first, None, end)
    finally:
        gc.enable()
    probe.append(host_probe_ms())
    launches = {k: v - launches0[k] for k, v in program.launches().items()}
    peak_window = program.peak_bytes()
    memory_peak = max(setup_peak, peak_window)
    if program.plain_calls() != plain0:
        raise RunFailed("a kernel's plain version ran during the run")
    silent = [k for k in program.path_kernels(enc) if not launches.get(k)]
    if silent:
        raise RunFailed(f"the path's kernels {silent} never launched")

    del enc
    gc.collect()
    program.release()
    if trace:
        trace_summary = summarize(
            span_s, light, heavy, len(traced_pool), program.library_kernels())
        del light, heavy
    expected, work = part("reference", c["reference"], cell.root).packets(
        c, pool)
    verdict = check(calls, expected)

    # the window's calls that returned inside it
    window = [k for k in calls[len(traced):] if k.t1 <= end]
    run = Run(cell=cell, seconds=seconds, setup_s=setup_s,
              window_calls=window,
              pixels_per_frame=c["width"] * c["height"],
              launches=launches, n_calls=len(calls),
              n_frames=sum(len(k.frames) for k in calls),
              peak_window_bytes=peak_window, trace=trace_summary,
              work=work, traced_pool_frames=traced_pool)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], cell.root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    found = banned_modules()     # once the window and the check are done
    if found:
        raise RunFailed(f"the run loaded {found}")
    correct = all(verdict[k] <= lim for k, lim in LIMITS.items())
    out = {"correct": correct, "attempted": verdict["packets_checked"],
           "failed": verdict["packets_wrong"], "metrics": metrics,
           "device": {**program.device(), "memory_peak_bytes":
                      int(memory_peak)}}
    if trace:
        t = trace_summary
        out["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {
            "device_ops": top({**t.lib_s, **t.other_s}),
            "idle_gaps": top(t.gaps_s)}
        log(f"traced span: busy_s {t.busy_s} of window_s {t.window_s} over "
            f"{t.frames} frames", file=sys.stderr)
    log(f"host probe: {probe[0]:.2f} ms before the window, {probe[1]:.2f} "
        f"after", file=sys.stderr)
    out["checks"] = {k: {"value": verdict[k], "limit": lim}
                     for k, lim in LIMITS.items()}
    for k, lim in LIMITS.items():
        log(f"check {k} {verdict[k]} limit {lim} "
            f"(of {verdict['packets_checked']} packets)", file=sys.stderr)
    return out


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest entries of ``d`` as [name, seconds] pairs."""
    ranked = sorted(d.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:160], v] for k, v in ranked]
