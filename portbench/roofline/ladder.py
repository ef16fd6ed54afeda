"""The ladder (``csrc/ladder.cu``, Golomb-Rice): the run-index scan over
each slice's runs.  It reads each run's length (4 bytes) and writes its
run index (4 bytes).  Bound by bytes:
``roofline.PEAK_BYTES_S``, 3.35 TB/s (NVIDIA's H100 SXM5 data sheet, at its
700 W power limit; each run prints the card's ``power.limit``)."""

KERNELS = ("chunk_maps", "chunk_carries", "replay")


def need(work: dict) -> int:
    return 8 * work["runs"]
