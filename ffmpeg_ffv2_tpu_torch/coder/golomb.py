"""Copy of ``ffmpeg_ffv2_tpu/coder/golomb.py``.

Signed/unsigned Golomb-Rice codes and the FFV1 VLC context state.

Bit-exact with the reference's golomb.h (set_ur_golomb/get_ur_golomb ffv1
flavour, limit/esc_len as used by put_vlc_symbol / get_vlc_symbol) and the
adaptive (k, bias, drift) state machine of ffv1.h:update_vlc_state.
"""

from __future__ import annotations

from dataclasses import dataclass

from .bitio import BitWriter, BitReader

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


def _fold(diff: int, bits: int) -> int:
    """Sign-extend ``diff`` to ``bits`` (ffv1.h:fold)."""
    diff &= (1 << bits) - 1
    if diff & (1 << (bits - 1)):
        diff -= 1 << bits
    return diff


def update_vlc_state(state: VlcState, v: int):
    drift = state.drift
    count = state.count
    state.error_sum = (state.error_sum + abs(v)) & 0xFFFF
    drift += v
    if count == 128:
        count >>= 1
        drift >>= 1
        state.error_sum >>= 1
    count += 1
    if drift <= -count:
        state.bias = max(state.bias - 1, -128)
        drift = max(drift + count, -count + 1)
    elif drift > 0:
        state.bias = min(state.bias + 1, 127)
        drift = min(drift - count, 0)
    state.drift = drift
    state.count = count


def put_ur_golomb(pb: BitWriter, i: int, k: int, limit: int, esc_len: int):
    assert i >= 0
    e = i >> k
    if e < limit:
        pb.put(e + k + 1, (1 << k) + (i & ((1 << k) - 1)))
    else:
        pb.put(limit + esc_len, i - limit + 1)


def get_ur_golomb(gb: BitReader, k: int, limit: int, esc_len: int) -> int:
    # A 1 within the first `limit` bits ends the unary prefix (normal case,
    # zeros <= limit-1); `limit` consecutive zeros signal the escape.
    zeros = 0
    while zeros < limit:
        if gb.get1():
            return (zeros << k) + gb.get(k)
        zeros += 1
    return gb.get(esc_len) + limit - 1


def put_sr_golomb(pb: BitWriter, i: int, k: int, limit: int, esc_len: int):
    # C: v = -2*i - 1; v ^= v >> 31  =>  zigzag map
    v = 2 * i if i >= 0 else -2 * i - 1
    put_ur_golomb(pb, v, k, limit, esc_len)


def get_sr_golomb(gb: BitReader, k: int, limit: int, esc_len: int) -> int:
    v = get_ur_golomb(gb, k, limit, esc_len)
    return (v >> 1) ^ -(v & 1)


def put_vlc_symbol(pb: BitWriter, state: VlcState, v: int, bits: int):
    """ffv1enc.c:put_vlc_symbol — adaptive-k signed Rice write."""
    v = _fold(v - state.bias, bits)
    i = state.count
    k = 0
    while i < state.error_sum:
        k += 1
        i += i
    assert k <= 13
    code = v if (2 * state.drift + state.count) >= 0 else -v - 1
    # C: code = v ^ ((2*drift + count) >> 31) — arithmetic shift gives 0/-1
    put_sr_golomb(pb, code, k, 12, bits)
    update_vlc_state(state, v)


def get_vlc_symbol(gb: BitReader, state: VlcState, bits: int) -> int:
    i = state.count
    k = 0
    while i < state.error_sum:
        k += 1
        i += i
    v = get_sr_golomb(gb, k, 12, bits)
    if (2 * state.drift + state.count) < 0:
        v = -v - 1  # v ^= -1
    ret = _fold(v + state.bias, bits)
    update_vlc_state(state, v)
    return ret
