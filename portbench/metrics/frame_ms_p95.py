"""The 95th percentile (numpy's linear interpolation), over every frame
of the window's untraced calls, of the milliseconds from the start of the
call that took the frame to its packet's bytes on the host: a frame's
``encode()`` call, or the ``encode_batch()`` pass that held it."""

import numpy as np


def read(run):
    ms = [1e3 * (c.t1 - c.t0) for c in run.window_calls for _ in c.frames]
    return float(np.percentile(ms, 95)) if ms else None
