"""Encode throughput: the pixels of every frame whose packet came back to
the host inside the window, in millions, over the window's seconds."""


def read(run):
    frames = sum(len(c.frames) for c in run.window_calls)
    return frames * run.pixels_per_frame / 1e6 / run.seconds
