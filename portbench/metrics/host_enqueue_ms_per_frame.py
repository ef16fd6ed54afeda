"""Host milliseconds a frame that the session spends launching work on
the card: its ``enqueue`` stages (phase A, the layout, the port's kernels
and torch's ops between them), from the port's stage records of the
untraced window (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.ms_per_frame(run, "enqueue")
