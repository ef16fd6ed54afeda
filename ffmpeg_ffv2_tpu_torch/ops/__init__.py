"""Data-movement kernels (PyTorch/CUDA port of ffmpeg_ffv2_tpu.ops).

* ``place`` — the cell placement (K1);
* ``sort`` — the multi-operand bitonic row sort ``sort_rows`` (K8, K9),
  the counterpart of ``sort_rows_pallas``.
"""

from .sort import sort_rows  # noqa: F401
