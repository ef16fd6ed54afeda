"""emission_pack (``csrc/adapt.cu``, range coder): each binary decision's
state (1 byte) moved from its chain's order into the order the coder
emits it.  Bound by bytes:
``roofline.PEAK_BYTES_S``, 3.35 TB/s (NVIDIA's H100 SXM5 data sheet, at its
700 W power limit; each run prints the card's ``power.limit``)."""

KERNELS = ("emission_pack_kernel",)


def need(work: dict) -> int:
    return 2 * work["decisions"]
