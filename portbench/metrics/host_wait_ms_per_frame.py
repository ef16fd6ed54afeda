"""Host milliseconds a frame that the session spends blocked on a read
of the card's results: its ``wait`` stages (``sizes to host``,
``lengths to host``), from the port's stage records of the untraced
window (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.ms_per_frame(run, "wait")
