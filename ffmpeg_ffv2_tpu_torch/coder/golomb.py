"""Copy of ``ffmpeg_ffv2_tpu/coder/golomb.py``: the run ladder and the VLC
context state.

``LOG2_RUN`` is the run-length ladder of the Golomb-Rice run mode and
``VlcState`` the adaptive (drift, error_sum, bias, count) context state of
ffv1.h; the device encoder codes the symbols themselves (ffv1/rice.py).
"""

from __future__ import annotations

from dataclasses import dataclass

# Run-length ladder shared by encoder and decoder (libavcodec/bitstream.c:39).
LOG2_RUN = [
    0, 0, 0, 0, 1, 1, 1, 1,
    2, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 5, 5, 6, 6, 7, 7,
    8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23,
    24,
]


@dataclass
class VlcState:
    drift: int = 0
    error_sum: int = 4
    bias: int = 0
    count: int = 1
