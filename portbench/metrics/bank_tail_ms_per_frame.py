"""Host milliseconds a frame that the session spends in every shape bank
after the first: the window's stages whose ``bank`` is 1 or more, from
the port's stage records (``portbench/spans.py``).  A frame of a
non-uniform slice geometry runs one pipeline a bank (upload, launches,
reads); this is what the banks after the first add to the host's time.
None where the records carry no bank (a port that does not mark them)."""

from portbench import spans


def read(run):
    calls = spans.window(run)
    if calls is None or not all(hasattr(s, "bank") for c in calls
                                for s in c.stages):
        return None
    return 1e3 * sum(s.t1 - s.t0 for c in calls for s in c.stages
                     if s.bank >= 1) / spans.frames(run)
