"""The seconds of set-up that the program's own call records cover: the
first load of the kernel library (``library load``, with nvcc's
``build`` when it runs), the session's ``session init``, and the
session's first call (its first warm-up call, which allocates and
initialises what every later call reuses), all before the window.  The
rest of ``setup_s`` is imports, the CUDA context, the frame pool and the
other warm-up calls."""

from portbench import spans


def read(run):
    _, trace = spans.recorder()
    if trace is None or not run.window_calls:
        return None
    calls = trace.calls(float("-inf"), run.window_calls[0].t0)
    if not calls:
        return None
    load = [c for c in calls if c.name == "library load"]
    init = [i for i, c in enumerate(calls) if c.name == "session init"]
    if not load or not init or init[-1] + 1 >= len(calls):
        return None
    first = calls[init[-1] + 1]
    return sum(c.t1 - c.t0 for c in (load[-1], calls[init[-1]], first))
