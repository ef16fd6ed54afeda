"""Copy of ``SliceState`` from ``ffmpeg_ffv2_tpu/ffv1/codec_py.py``.

The per-slice coder state: the encoder reads its per-plane context counts
and quant-table indices, and the slice header writer its RCT fields.
"""

from __future__ import annotations

import numpy as np

from ..coder.golomb import VlcState
from .params import FFV1Params, CODER_GOLOMB, CONTEXT_SIZE


class SliceState:
    """Per-slice adaptive coder state for all planes."""

    def __init__(self, p: FFV1Params):
        self.p = p
        self.plane_ctx_count = []
        self.plane_qt_index = []
        for _ in range(p.plane_count):
            self.plane_qt_index.append(p.context_model)
            self.plane_ctx_count.append(p.context_counts[p.context_model])
        self.states = None       # list of uint8[ctx][32] (range coder)
        self.vlc_states = None   # list of list[VlcState] (golomb)
        self.run_index = 0
        self.slice_rct_by = 1
        self.slice_rct_ry = 1
        self.slice_coding_mode = 0
        self.slice_reset_contexts = 0
        self.damaged = False
        self.alloc()

    def alloc(self):
        p = self.p
        if p.ac != CODER_GOLOMB:
            self.states = [
                np.full((self.plane_ctx_count[i], CONTEXT_SIZE), 128,
                        dtype=np.uint8)
                for i in range(p.plane_count)]
        else:
            self.vlc_states = [
                [VlcState() for _ in range(self.plane_ctx_count[i])]
                for i in range(p.plane_count)]

    def clear(self):
        """ff_ffv1_clear_slice_state: reset to initial states."""
        p = self.p
        if p.ac != CODER_GOLOMB:
            for i in range(p.plane_count):
                qt = self.plane_qt_index[i]
                init = p.initial_states[qt] if p.initial_states else None
                if init is not None:
                    self.states[i][:] = init[:self.plane_ctx_count[i]]
                else:
                    self.states[i][:] = 128
        else:
            for i in range(p.plane_count):
                for st in self.vlc_states[i]:
                    st.drift = 0
                    st.error_sum = 4
                    st.bias = 0
                    st.count = 1
