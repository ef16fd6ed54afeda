"""Pipelines a frame: the distinct (shape bank, cap-retry attempt) pairs
of each window call's stages, over the window's frames, from the port's
stage records (``portbench/spans.py``).  A frame of two shape banks reads
2 plus its cap retries; a frame coded in one pipeline reads 1.  None
where the records carry no bank (a port that does not mark them)."""

from portbench import spans


def read(run):
    calls = spans.window(run)
    if calls is None or not all(hasattr(s, "bank") for c in calls
                                for s in c.stages):
        return None
    return sum(len({(s.bank, s.attempt) for s in c.stages})
               for c in calls) / spans.frames(run)
