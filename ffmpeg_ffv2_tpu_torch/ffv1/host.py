"""Host-side numpy helpers of the device FFV1 encoder.

numpy-only copies of the helpers that the JAX package keeps inside modules
that import jax, so the port can run where jax is not installed:

* ``ffmpeg_ffv2_tpu/ffv1/device_coder.py:72-160``: ``transition_tables``,
  ``packed_transition_table``, ``quantize_cap``, ``k_max_for_bits``,
  ``payload_field``, ``n_sv_words``, ``n_ev_words``;
* ``device_coder.py:326-365``: ``RecordingRangeEncoder``,
  ``plan_slice_prefix``, ``TERMINATOR_SV``;
* ``device_coder.py:423,646-649``: ``GCAP``, ``SLOT_AT_ROW``,
  ``ROW_OF_SLOT``;
* ``ffmpeg_ffv2_tpu/ffv1/tpu_encoder.py:89-111``: ``TPUFFV1Encoder.
  _build_plan`` as ``build_crop_plan``;
* ``ffmpeg_ffv2_tpu/ffv1/expand_pallas.py:68``: ``OP_GRAN``, the op-cap
  granularity.

tests/test_torch_host.py holds every copy equal to its original.
"""

from __future__ import annotations

import numpy as np

from ..coder.rac import RangeEncoder, DEFAULT_ZERO_STATE, DEFAULT_ONE_STATE
from . import headers as H
from .params import FFV1Params, CODER_RANGE_CUSTOM
from .slice_state import SliceState

GCAP = 4096          # max pixels per lane (sub-lane size for split groups)
OP_GRAN = 4096       # op_cap granularity
TERMINATOR_SV = 129  # ff_rac_terminate version-1 bit (rangecoder.c:109)

# The 32 slot states of a lane live in PERMUTED order: row r holds slot
# 4*(r&7) + (r>>3), so the packed sv word j = rows j, j+8, j+16, j+24
# holds slots 4j..4j+3 little-endian.
SLOT_AT_ROW = np.array([4 * (r & 7) + (r >> 3) for r in range(32)],
                       dtype=np.int32)
ROW_OF_SLOT = np.array([8 * (s & 3) + (s >> 2) for s in range(32)],
                       dtype=np.int32)


def transition_tables(p: FFV1Params) -> tuple[np.ndarray, np.ndarray]:
    """(zero_state, one_state) uint8[256] used by this stream's slices."""
    if p.ac == CODER_RANGE_CUSTOM:
        one = np.asarray(p.state_transition, dtype=np.uint8).copy()
        zero = np.zeros(256, dtype=np.uint8)
        idx = np.arange(1, 256)
        zero[256 - idx] = (256 - one[idx].astype(np.int64)).astype(np.uint8)
        return zero, one
    return (np.asarray(DEFAULT_ZERO_STATE, dtype=np.uint8),
            np.asarray(DEFAULT_ONE_STATE, dtype=np.uint8))


def packed_transition_table(p: FFV1Params) -> np.ndarray:
    """zero_state ++ one_state packed little-endian into 128 int32 words:
    byte bit*256 + s is the next state after coding ``bit`` in state s."""
    zero, one = transition_tables(p)
    return np.concatenate([zero, one]).view("<u4").astype(np.int32)


def quantize_cap(need: int, cap_max: int, gran: int = 1) -> int:
    """Snap an adaptive working-domain size to a coarse rung m * 2^e,
    m in [4, 8), rounded up to ``gran`` and clamped to ``cap_max``."""
    if need >= cap_max:
        return cap_max
    v = max(int(need), 1)
    e = max(0, v.bit_length() - 3)
    v = -(-v >> e) << e
    v = -(-v // gran) * gran
    return min(v, cap_max)


def k_max_for_bits(bits: int) -> int:
    """Worst-case rac ops per pixel: 2*e_max + 3, e_max = bits-1."""
    if bits > 17:
        raise ValueError("slot-grid expansion needs e <= 16 (bits <= 17)")
    return 2 * (bits - 1) + 3


def payload_field(code_bits: int) -> tuple[int, int, int]:
    """(mask, bias, valid_bit) of the cell payload's diff field."""
    if code_bits > 16:
        return 0x1FFFF, 65536, 17
    if code_bits > 10:
        return 0xFFFF, 32768, 16
    return 0xFFF, 2048, 13


def n_sv_words(bits: int) -> int:
    """Packed sv words per cell: 8 base + ceil(R/2) repeat-pair words."""
    r = max(0, bits - 10)
    return 8 + (r + 1) // 2


def n_ev_words(bits: int) -> int:
    """Emission-order byte words per cell: ceil(k_max / 4)."""
    return (k_max_for_bits(bits) + 3) // 4


class RecordingRangeEncoder(RangeEncoder):
    """RangeEncoder that logs the (state value, bit) of every put()."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.ops_sv = []
        self.ops_bit = []

    def put(self, states, idx, bit):
        self.ops_sv.append(int(states[idx]))
        self.ops_bit.append(1 if bit else 0)
        super().put(states, idx, bit)


def plan_slice_prefix(p: FFV1Params, ss: SliceState, si: int, rect,
                      keyframe: bool) -> tuple[np.ndarray, np.ndarray]:
    """(sv, bit) ops preceding the plane data in slice si's rac stream:
    the keyframe bit for slice 0, the in-band v0/v1 keyframe header and
    the v3+ slice header.  The keyframe bit and the v0/v1 header use the
    default transition tables; the custom table applies from the slice
    header on."""
    c = RecordingRangeEncoder()
    if si == 0:
        key_state = np.array([128], dtype=np.uint8)
        c.put(key_state, 0, 1 if keyframe else 0)
        if keyframe and p.version < 2:
            H.write_v01_header(c, p)
    if p.ac == CODER_RANGE_CUSTOM:
        c.set_state_tables(p.state_transition)
    if p.version > 2:
        H.write_slice_header(c, p, ss, rect)
    return (np.array(c.ops_sv, dtype=np.uint8),
            np.array(c.ops_bit, dtype=np.uint8))


def ceil_rshift(v: int, s: int) -> int:
    return -(-v >> s) if s else v


def build_crop_plan(p: FFV1Params) -> list:
    """Per coded plane: the list of slice rects (x, y, w, h) in that
    plane's resolution."""
    plan = []
    if p.colorspace == 1:
        plane_dims = [(p.width, p.height, 0, 0)] * (3 + p.transparency)
    else:
        plane_dims = [(p.width, p.height, 0, 0)]
        if p.chroma_planes:
            hs, vs = p.chroma_h_shift, p.chroma_v_shift
            cw, ch = ceil_rshift(p.width, hs), ceil_rshift(p.height, vs)
            plane_dims += [(cw, ch, hs, vs)] * 2
        if p.transparency:
            plane_dims.append((p.width, p.height, 0, 0))
    rects = p.rects()
    for (pw, ph, hs, vs) in plane_dims:
        prects = []
        for (x, y, w, h) in rects:
            px, py = x >> hs, y >> vs
            pw2, ph2 = ceil_rshift(w, hs), ceil_rshift(h, vs)
            prects.append((px, py, pw2, ph2))
        plan.append(prects)
    return plan
