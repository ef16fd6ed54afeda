"""Host milliseconds a frame that the session spends moving frame data
between the host and the card: its ``copy`` stages (``upload`` and
``bytes to host``), from the port's stage records of the untraced
window (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.ms_per_frame(run, "copy")
