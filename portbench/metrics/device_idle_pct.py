"""The share of a frame's time in which no operation runs on the card, in
%: one less the device's busy seconds a frame in the traced segment
(``torch.profiler``'s device events, merged) over the host-clock seconds
a frame of the untraced window that follows.  The traced segment's own
span is not the denominator: the profiler's cost a launch stretches it."""


def read(run):
    t, w = run.trace, run.window_calls
    if t is None or not t.frames or not w:
        return None
    frames = sum(len(c.frames) for c in w)
    return 100.0 * (1.0 - t.busy_s / t.frames * frames
                    / (w[-1].t1 - w[0].t0))
