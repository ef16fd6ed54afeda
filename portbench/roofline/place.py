"""K1 place (``csrc/place.cu``, both coders): every coded sample's cell
moved once into its context's chain.  It reads the sample's payload (its
context and residual, one 4-byte word) and its destination (4 bytes), and
writes the cell (4 bytes).  Bound by bytes:
``roofline.PEAK_BYTES_S``, 3.35 TB/s (NVIDIA's H100 SXM5 data sheet, at its
700 W power limit; each run prints the card's ``power.limit``)."""

KERNELS = ("place_slots_kernel", "place_rows_kernel")


def need(work: dict) -> int:
    return 12 * work["samples"]
