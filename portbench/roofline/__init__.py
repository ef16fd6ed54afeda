"""The bytes each of the port's kernels needs for a frame's data, and the
share of its roofline that the traced segment reached.

Every kernel of the coders is bound by memory (PERF.md, the kernel table),
so its least time is its bytes over the card's published bandwidth:
3.35 TB/s, NVIDIA's H100 SXM5 80 GB data sheet, at its 700 W power limit.
The run prints the card's ``power.limit`` on standard error beside the
result.  Each ``<kernel>.py`` here names the device kernels it covers
(``KERNELS``) and counts, in ``need(work)``, the bytes that one frame's
data needs (each input byte read once, each output byte written once),
from the reference's work counts of that frame: never the program's caps.
"""

import importlib.util
import os

PEAK_BYTES_S = 3.35e12
_HERE = os.path.dirname(os.path.abspath(__file__))


def kernel(name: str):
    """The module ``portbench/roofline/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "portbench.roofline." + name, os.path.join(_HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def share(run, names) -> float | None:
    """100 x the roofline time of ``names``' kernels over the traced
    frames, over their device time there; None where the run was not
    traced or one of them never ran."""
    if run.trace is None or not run.traced_pool_frames:
        return None
    need_s = dev_s = 0.0
    for name in names:
        mod = kernel(name)
        t = sum(run.trace.lib_s.get(k, 0.0) for k in mod.KERNELS)
        if t <= 0:
            return None
        dev_s += t
        need_s += sum(mod.need(run.work[i])
                      for i in run.traced_pool_frames) / PEAK_BYTES_S
    return 100.0 * need_s / dev_s
