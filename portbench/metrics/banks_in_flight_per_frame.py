"""Shape banks in flight a frame: for each window call, the distinct
banks with a ``K4 rac_render`` stage before the call's first ``lengths
to host``, summed over the calls, over the window's frames, from the
port's stage records (``portbench/spans.py``).  A session that reads a
bank's lengths before it enqueues the next bank reads 1; one that
launches both banks' K4 before the first read reads 2.  None where the
records carry no bank (a port that does not mark them)."""

from portbench import spans


def read(run):
    calls = spans.window(run)
    if calls is None or not all(hasattr(s, "bank") for c in calls
                                for s in c.stages):
        return None
    n = 0
    for c in calls:
        banks = set()
        for s in c.stages:
            if s.name == "lengths to host":
                break
            if s.name == "K4 rac_render":
                banks.add(s.bank)
        n += len(banks)
    return n / spans.frames(run)
