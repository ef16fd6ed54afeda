"""The port's own stage records of a run: the call records that its
recorder (``ffmpeg_ffv2_tpu_torch.utils.metrics.TRACE``, a ``StageTrace``)
kept for the calls of the untraced window, each split into stages of one
kind (``copy``, ``wait``, ``host``, ``enqueue``) on the host clock that
the driver loops time the calls with.

The recorder is looked up among the modules that the program adapter
already loaded, so nothing is imported here.  A program without one (an
older port) leaves every reader of this module silent: it returns None,
as it does when the ring no longer holds every call of the window, or
holds another number of calls than the driver loop made.
"""

import sys

MODULE = "ffmpeg_ffv2_tpu_torch.utils.metrics"


def recorder():
    """The port's metrics module and its recorder, or (None, None)."""
    mod = sys.modules.get(MODULE)
    trace = getattr(mod, "TRACE", None)
    if not callable(getattr(trace, "calls", None)):
        return None, None
    return mod, trace


def window(run):
    """The call records of ``run``'s window calls, in order, or None."""
    _, trace = recorder()
    if trace is None or not run.window_calls:
        return None
    calls = trace.calls(run.window_calls[0].t0, run.window_calls[-1].t1)
    if calls is None or len(calls) != len(run.window_calls):
        return None
    return calls


def frames(run) -> int:
    return sum(len(c.frames) for c in run.window_calls)


def ms_per_frame(run, kind: str):
    """The host milliseconds a frame of the window's stages of ``kind``."""
    calls = window(run)
    if calls is None:
        return None
    return 1e3 * sum(s.t1 - s.t0 for c in calls for s in c.stages
                     if s.kind == kind) / frames(run)
