"""The FFV1 constants the reference needs, from the format itself.

QUANT11 and QUANT5 are RFC 9043's 8-bit context quantisation tables
(FFmpeg ffv1enc.c ``quant11`` and ``quant5``), written here as their
runs; ``-context 0`` quantises three sample differences with QUANT11,
``-context 1`` two with QUANT11 and three with QUANT5.  VER2_STATE is the
custom state-transition table that ``-coder 1`` puts in the extradata
(ffv1enc.c ``ver2_state``).  ``build_rac_states`` is FFmpeg's
``ff_build_rac_states`` (rangecoder.c), the default table of
``-coder 0``'s range-coded slice headers.
"""

import numpy as np

_RUNS11 = [(0, 1), (1, 1), (2, 3), (3, 7), (4, 23), (5, 93), (-5, 94),
           (-4, 23), (-3, 7), (-2, 3), (-1, 1)]
QUANT11 = np.concatenate([np.full(n, v, np.int32) for v, n in _RUNS11])
_RUNS5 = [(0, 1), (1, 3), (2, 124), (-2, 125), (-1, 3)]
QUANT5 = np.concatenate([np.full(n, v, np.int32) for v, n in _RUNS5])

VER2_STATE = np.array([
    0, 10, 10, 10, 10, 16, 16, 16, 28, 16, 16, 29, 42, 49, 20, 49,
    59, 25, 26, 26, 27, 31, 33, 33, 33, 34, 34, 37, 67, 38, 39, 39,
    40, 40, 41, 79, 43, 44, 45, 45, 48, 48, 64, 50, 51, 52, 88, 52,
    53, 74, 55, 57, 58, 58, 74, 60, 101, 61, 62, 84, 66, 66, 68, 69,
    87, 82, 71, 97, 73, 73, 82, 75, 111, 77, 94, 78, 87, 81, 83, 97,
    85, 83, 94, 86, 99, 89, 90, 99, 111, 92, 93, 134, 95, 98, 105, 98,
    105, 110, 102, 108, 102, 118, 103, 106, 106, 113, 109, 112, 114, 112,
    116, 125,
    115, 116, 117, 117, 126, 119, 125, 121, 121, 123, 145, 124, 126, 131,
    127, 129,
    165, 130, 132, 138, 133, 135, 145, 136, 137, 139, 146, 141, 143, 142,
    144, 148,
    147, 155, 151, 149, 151, 150, 152, 157, 153, 154, 156, 168, 158, 162,
    161, 160,
    172, 163, 169, 164, 166, 184, 167, 170, 177, 174, 171, 173, 182, 176,
    180, 178,
    175, 189, 179, 181, 186, 183, 192, 185, 200, 187, 191, 188, 190, 197,
    193, 196,
    197, 194, 195, 196, 198, 202, 199, 201, 210, 203, 207, 204, 205, 206,
    208, 214,
    209, 211, 221, 212, 213, 215, 224, 216, 217, 218, 219, 220, 222, 228,
    223, 225,
    226, 224, 227, 229, 240, 230, 231, 232, 233, 234, 235, 236, 238, 239,
    237, 242,
    241, 243, 242, 244, 245, 246, 247, 248, 249, 250, 251, 252, 252, 253,
    254, 255,
], np.uint8)


def build_rac_states(factor: int = int(0.05 * (1 << 32)),
                     max_p: int = 256 - 8) -> np.ndarray:
    """ff_build_rac_states(c, 0.05 * (1LL << 32), 256 - 8): one_state."""
    one = 1 << 32
    one_state = np.zeros(256, np.int64)
    last_p8, p = 0, one // 2
    for _ in range(128):
        p8 = (256 * p + one // 2) >> 32
        if p8 <= last_p8:
            p8 = last_p8 + 1
        if last_p8 and last_p8 < 256 and p8 <= max_p:
            one_state[last_p8] = p8
        p += ((one - p) * factor + one // 2) >> 32
        last_p8 = p8
    for i in range(256 - max_p, max_p + 1):
        if one_state[i]:
            continue
        p = (i * one + 128) >> 8
        p += ((one - p) * factor + one // 2) >> 32
        p8 = min(max((256 * p + one // 2) >> 32, i + 1), max_p)
        one_state[i] = p8
    return one_state.astype(np.uint8)


def zero_state(one_state: np.ndarray, default: bool) -> np.ndarray:
    """The zero-bit transitions paired with ``one_state``: zero[k] = 256 -
    one[256 - k] for k in 1..254 (the default table, rangecoder.c) or in
    1..255 (a custom one, ffv1enc.c)."""
    zero = np.zeros(256, np.int64)
    k = np.arange(1, 255 if default else 256)
    zero[k] = 256 - one_state[256 - k].astype(np.int64)
    return (zero & 0xFF).astype(np.uint8)
