"""Device milliseconds a frame of the port's own kernels (the library
built from ``ffmpeg_ffv2_tpu_torch/csrc``).  From the traced segment."""


def read(run):
    t = run.trace
    if t is None or not t.frames or not t.lib_s:
        return None
    return 1e3 * sum(t.lib_s.values()) / t.frames
