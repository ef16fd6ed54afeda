"""Copy of ``ffmpeg_ffv2_tpu/utils/psnr.py``.

Raw-file comparator producing FATE-identical transcript lines.

Replicates tests/tiny_psnr.c's fixed-point integer math (F=100, log16 over
the exp16 table, bitwise int_sqrt) so the "stddev/PSNR/MAXDIFF/bytes" line
is byte-identical to the committed FATE references.
"""

from __future__ import annotations

import numpy as np

F = 100

_EXP16 = [
    65537, 65538, 65540, 65544, 65552, 65568, 65600, 65664, 65793, 66050,
    66568, 67616, 69763, 74262, 84150, 108051, 178145, 484249, 3578144,
    195360063, 582360139072,
]


def _log16(a: int) -> int:
    if a < (1 << 16):
        return -_log16((1 << 32) // a)
    a <<= 16
    out = 0
    for i in range(20, -1, -1):
        b = _EXP16[i]
        if a < (b << 16):
            continue
        out |= 1 << i
        a = ((a // b) << 16) + (((a % b) << 16) + b // 2) // b
    return out


def _int_sqrt(a: int) -> int:
    ret = 0
    ret_sq = 0
    for s in range(31, -1, -1):
        b = ret_sq + (1 << (s * 2)) + ((ret << s) * 2)
        if b <= a:
            ret_sq = b
            ret += 1 << s
    return ret


def psnr_u8(a: bytes, b: bytes):
    """(stddev_fp, psnr_fp, maxdiff, size_a, size_b) with F=100 fixed point."""
    xa = np.frombuffer(a, dtype=np.uint8).astype(np.int64)
    xb = np.frombuffer(b, dtype=np.uint8).astype(np.int64)
    n = min(len(xa), len(xb))
    d = xa[:n] - xb[:n]
    sse = int(np.sum(d * d))
    maxdist = int(np.abs(d).max()) if n else 0
    i = n if n else 1
    dev = _int_sqrt((sse // i) * F * F + (((sse % i) * F * F) + i // 2) // i)
    if sse:
        psnr = ((2 * _log16(255 << 16) + _log16(i) - _log16(sse))
                * 284619 * F + (1 << 31)) >> 32
    else:
        psnr = 1000 * F - 1
    return dev, psnr, maxdist, len(a), len(b)


def tiny_psnr_line(a: bytes, b: bytes) -> str:
    dev, psnr, maxdist, s0, s1 = psnr_u8(a, b)
    return (f"stddev:{dev // F:5d}.{dev % F:02d} "
            f"PSNR:{psnr // F:3d}.{psnr % F:02d} "
            f"MAXDIFF:{maxdist:5d} bytes:{s0:9d}/{s1:9d}")
