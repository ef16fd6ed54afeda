"""Copy of ``ffmpeg_ffv2_tpu/coder/bitio.py``.

MSB-first bit writer/reader (put_bits.h / get_bits.h equivalents).

Only the FFV1 Golomb-Rice coding mode uses these; the flush semantics
(zero-padding to a byte boundary) match the reference encoder's
``flush_put_bits``.
"""

from __future__ import annotations


class BitWriter:
    __slots__ = ("_acc", "_nbits", "out")

    def __init__(self):
        self._acc = 0       # bit accumulator, MSB-first
        self._nbits = 0     # bits currently in the accumulator
        self.out = bytearray()

    def put(self, n: int, value: int):
        """Write the ``n`` low bits of ``value``, MSB first."""
        if n == 0:
            return
        assert 0 <= n <= 31
        value &= (1 << n) - 1
        self._acc = (self._acc << n) | value
        self._nbits += n
        while self._nbits >= 8:
            self._nbits -= 8
            self.out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def bit_count(self) -> int:
        return len(self.out) * 8 + self._nbits

    def flush(self) -> bytes:
        """Zero-pad to a byte boundary and return the buffer."""
        if self._nbits:
            self.out.append((self._acc << (8 - self._nbits)) & 0xFF)
            self._acc = 0
            self._nbits = 0
        return bytes(self.out)


class BitReader:
    __slots__ = ("buf", "pos", "size_bits")

    def __init__(self, data: bytes, offset_bytes: int = 0):
        self.buf = data
        self.pos = offset_bytes * 8   # bit position
        self.size_bits = len(data) * 8

    def bits_left(self) -> int:
        return self.size_bits - self.pos

    def get1(self) -> int:
        byte = self.buf[self.pos >> 3] if (self.pos >> 3) < len(self.buf) else 0
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get1()
        return v

    def peek(self, n: int) -> int:
        save = self.pos
        v = self.get(n)
        self.pos = save
        return v

    def skip(self, n: int):
        self.pos += n

    def bit_count(self) -> int:
        return self.pos
