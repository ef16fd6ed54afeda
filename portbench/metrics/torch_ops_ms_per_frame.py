"""Device milliseconds a frame of every operation on the card that is not
one of the port's own kernels: torch's kernels (phase A, the layout's
sorts and scans, the unsort, the writeback, the Rice bit assembly) and its
copies (the upload, the sizes and bytes down).  From the traced segment."""


def read(run):
    t = run.trace
    if t is None or not t.frames or not t.other_s:
        return None
    return 1e3 * sum(t.other_s.values()) / t.frames
