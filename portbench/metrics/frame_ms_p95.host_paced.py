"""``frame_ms_p95``, as a per-layer metric of the cells where the card is
idle for more than half of a frame's time (``device_idle_pct``): there
the host paces the tail."""

from portbench.harness import reader


def read(run):
    return reader("frame_ms_p95", run.cell.root)(run)
