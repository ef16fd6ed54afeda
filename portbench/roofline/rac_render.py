"""K4 rac_render (``csrc/rac_render.cu``, range coder): the range coder
over each slice's binary decisions.  It reads one 4-byte op word a
decision and writes the packet's bytes.  A slice is serial, which the
roofline does not see.  Bound by bytes:
``roofline.PEAK_BYTES_S``, 3.35 TB/s (NVIDIA's H100 SXM5 data sheet, at its
700 W power limit; each run prints the card's ``power.limit``)."""

KERNELS = ("rac_render_kernel",)


def need(work: dict) -> int:
    return 4 * work["decisions"] + work["packet_bytes"]
