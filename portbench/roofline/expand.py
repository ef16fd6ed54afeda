"""K3 expand (``csrc/expand.cu``, range coder): each sample's symbol
turned into its binary decisions.  It reads each sample's residual (4
bytes) and each decision's state (1 byte), and writes one 4-byte op word
a decision: the slices' decisions only, not the op buffer's fill.
Bound by bytes:
``roofline.PEAK_BYTES_S``, 3.35 TB/s (NVIDIA's H100 SXM5 data sheet, at its
700 W power limit; each run prints the card's ``power.limit``)."""

KERNELS = ("chunk_ops_kernel", "expand_kernel")


def need(work: dict) -> int:
    return 4 * work["samples"] + 5 * work["decisions"]
