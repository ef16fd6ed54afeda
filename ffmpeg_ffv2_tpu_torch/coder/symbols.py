"""Copy of ``ffmpeg_ffv2_tpu/coder/symbols.py``.

FFV1 symbol coding on top of the binary range coder.

A symbol uses a 32-entry state vector: state 0 codes "is zero", states 1..10
the unary exponent, 11..21 the sign, 22..31 the mantissa bits
(ffv1enc.c:put_symbol_inline / ffv1dec.c:get_symbol_inline).
"""

from __future__ import annotations

import numpy as np

from .rac import RangeEncoder, RangeDecoder

CONTEXT_SIZE = 32


def new_states(n: int = 1) -> np.ndarray:
    """``n`` fresh 32-byte state vectors initialised to 128."""
    return np.full((n, CONTEXT_SIZE), 128, dtype=np.uint8)


def put_symbol(c: RangeEncoder, states: np.ndarray, v: int, is_signed: bool):
    """Code signed/unsigned int ``v`` adapting ``states`` (a uint8[>=32])."""
    if v:
        a = abs(v)
        e = a.bit_length() - 1
        c.put(states, 0, 0)
        if e <= 9:
            for i in range(e):
                c.put(states, 1 + i, 1)
            c.put(states, 1 + e, 0)
            for i in range(e - 1, -1, -1):
                c.put(states, 22 + i, (a >> i) & 1)
            if is_signed:
                c.put(states, 11 + e, 1 if v < 0 else 0)
        else:
            for i in range(e):
                c.put(states, 1 + min(i, 9), 1)
            c.put(states, 1 + 9, 0)
            for i in range(e - 1, -1, -1):
                c.put(states, 22 + min(i, 9), (a >> i) & 1)
            if is_signed:
                c.put(states, 11 + 10, 1 if v < 0 else 0)
    else:
        c.put(states, 0, 1)


def get_symbol(c: RangeDecoder, states: np.ndarray, is_signed: bool) -> int:
    if c.get(states, 0):
        return 0
    e = 0
    while c.get(states, 1 + min(e, 9)):
        e += 1
        if e > 31:
            raise ValueError("invalid exponent in symbol")
    a = 1
    for i in range(e - 1, -1, -1):
        a += a + c.get(states, 22 + min(i, 9))
    if is_signed and c.get(states, 11 + min(e, 10)):
        return -a
    return a
