"""Copy of ``ffmpeg_ffv2_tpu/core/crc.py``.

CRC-32/IEEE as used by the FFV1 bitstream (slice + extradata trailers).

Semantics match libavutil's ``av_crc(av_crc_get_table(AV_CRC_32_IEEE), 0, ...)``
(reference: libavutil/crc.c: av_crc_init le=0 bits=32 poly=0x04C11DB7, then
byte-swapped table consumed LSB-first).  The encoder appends the CRC little-
endian so that re-running the CRC over data+trailer yields 0.
"""

from __future__ import annotations

import numpy as np

_POLY = 0x04C11DB7


def _build_table() -> np.ndarray:
    tab = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = (i << 24) & 0xFFFFFFFF
        for _ in range(8):
            mask = 0xFFFFFFFF if (c & 0x80000000) else 0
            c = ((c << 1) & 0xFFFFFFFF) ^ (_POLY & mask)
        # byte-swap, as av_crc_init does for big-endian polynomials
        c = ((c & 0xFF) << 24) | ((c & 0xFF00) << 8) | ((c >> 8) & 0xFF00) | (c >> 24)
        tab[i] = c
    return tab


CRC32_IEEE_TABLE = _build_table()

# uint32 view for the vectorized path
_TAB32 = CRC32_IEEE_TABLE.astype(np.uint32)


def crc32_ieee(data: bytes | bytearray | memoryview | np.ndarray, crc: int = 0) -> int:
    """CRC over ``data`` starting from ``crc`` (usually 0)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    c = np.uint32(crc)
    tab = _TAB32
    for b in buf.tolist():
        c = tab[(int(c) ^ b) & 0xFF] ^ (c >> np.uint32(8))
    return int(c)


def crc32_trailer(data: bytes) -> bytes:
    """4-byte little-endian CRC trailer; crc32_ieee(data + trailer) == 0."""
    return int(crc32_ieee(data)).to_bytes(4, "little")
