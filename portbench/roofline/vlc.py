"""K5 vlc (``csrc/vlc.cu``, Golomb-Rice): the walk of each context's
chain with the adaptive Rice parameter.  It reads each cell (4 bytes),
reads and writes each slice's VLC states once (6 bytes a context, as
FFmpeg's ``VlcState``), and writes each Rice code's length and value (4
bytes).  Bound by bytes:
``roofline.PEAK_BYTES_S``, 3.35 TB/s (NVIDIA's H100 SXM5 data sheet, at its
700 W power limit; each run prints the card's ``power.limit``)."""

KERNELS = ("vlc_kernel",)


def need(work: dict) -> int:
    return 4 * work["samples"] + 4 * work["codes"] + 2 * 6 * work["contexts"]
