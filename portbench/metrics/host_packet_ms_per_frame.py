"""Host milliseconds a frame that the session spends building the packet
on the host: its ``host`` stages (``slice bytes``, the slices' bytes cut
from the copied buffer, and ``slice trailers + CRC``), from the port's
stage records of the untraced window (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.ms_per_frame(run, "host")
