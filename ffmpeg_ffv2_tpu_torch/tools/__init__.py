"""The port's counterparts of the repository's Pallas tools: the sort-shape
microbenchmarks (``microbench_sort``), the primitive microbenchmarks
(``microbench_prims``) and the capability probes (``probes``).  Each runs
its hand-written CUDA kernels on the card unless the caller passes
``device="cpu"``, where the plain versions run and every printed line
says so.

    python -m ffmpeg_ffv2_tpu_torch.tools.microbench_sort [case substring]
    python -m ffmpeg_ffv2_tpu_torch.tools.microbench_prims
    python -m ffmpeg_ffv2_tpu_torch.tools.probes
    python -m ffmpeg_ffv2_tpu_torch.tools.bench_batch_scale [B ...]

``bench_batch_scale`` gates ``encode_batch`` against the native codec and
times it at each B beside ``encode()`` (the counterpart of the
repository's ``tools/bench_batch_scale.py``).

``kernel_times.py`` (run by its path, with ``--root`` naming the checkout
whose kernels it times) gives the CUDA-event times of the range path's
kernels K4, K2, K6, K3 and K1 (and of K1 on the Golomb-Rice path) at the
main path's shapes; ``latency.py``
measures the latencies of the dependent chains that bound them
(``latency.cu``, for ``chip_smoke.py``'s chain bounds).
"""

from __future__ import annotations

import time

import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
# no int32 rate is published; the float32 non-tensor peak is no lower
OPS_PER_S = 67e12
PROFILE_TRIES = 3


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time of the work on an H100: bytes over the memory rate
    or operations over the peak rate, whichever is larger."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def device_ms(fn, reps: int, device) -> float:
    """Median time of fn() over reps runs after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    dev = torch.device(device)
    fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def device_ms_once(fn, device) -> tuple:
    """fn()'s result and the time of that one run (a plain version's
    comparison run is its timed run)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def profiled_ms(fn, reps: int, device, kernels: int) -> tuple:
    """The device time alone of one fn() call (the spans of its kernels
    and copies on the card, ``torch.profiler`` over ``reps`` calls after a
    warm-up) and the kernels the profiler saw a call; (None, None) off
    the card.  ``kernels`` is the count of kernels fn() launches: the
    profiler drops a call's device events now and then, so the profile is
    taken again while it saw another count, and after PROFILE_TRIES such
    profiles the call fails (AssertionError) rather than report a time
    short of kernels."""
    if torch.device(device).type != "cuda":
        return None, None
    seen = []
    for _ in range(PROFILE_TRIES):
        prof = device_profile(fn, reps, device)
        n = round(reps * sum(c for name, (_, c) in prof.items()
                             if not name.startswith(("Memcpy", "Memset"))))
        if n == reps * kernels:
            return sum(ms for ms, _ in prof.values()), kernels
        seen.append(n / reps)
    raise AssertionError(f"the profiler saw {seen} kernels a call in "
                         f"{PROFILE_TRIES} profiles, not the {kernels} "
                         "launched")


def device_profile(fn, reps: int, device) -> dict:
    """{name: [ms, count]} a fn() call of each kernel or copy on the card,
    from ``torch.profiler`` over ``reps`` calls after a warm-up; empty
    off the card or where the profiler saw no device activity."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            acc = out.setdefault(e.name, [0.0, 0.0])
            acc[0] += e.time_range.elapsed_us() / reps / 1e3
            acc[1] += 1 / reps
    return out


def device_label(device) -> str:
    """What a printed line names its device by."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu (plain versions, no kernel)"


def launches_of(fn, kernels) -> tuple:
    """fn()'s result and how many times each of ``kernels`` (``_build.
    Kernel``s) launched during it."""
    before = [k.launches for k in kernels]
    out = fn()
    return out, {k.name: k.launches - b for k, b in zip(kernels, before)}
