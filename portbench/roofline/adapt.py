"""K2 adapt (``csrc/adapt.cu``, range coder): the walk of each context's
chain.  It reads each cell (4 bytes), reads and writes each slice's
context states once (32 bytes a context), and writes the state that each
binary decision codes with (1 byte).  Bound by bytes:
``roofline.PEAK_BYTES_S``, 3.35 TB/s (NVIDIA's H100 SXM5 data sheet, at its
700 W power limit; each run prints the card's ``power.limit``)."""

KERNELS = ("adapt_kernel",)


def need(work: dict) -> int:
    return 4 * work["samples"] + work["decisions"] + 2 * 32 * work["contexts"]
