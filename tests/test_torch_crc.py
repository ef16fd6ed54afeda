"""The port's slice CRC: the native runtime's table loop (``ffv1rt_crc32``
behind ``ffv1.native.crc32_trailer``, which the encoders call) equals the
port's plain Python loop (``core.crc``) and the JAX package's
``crc32_ieee``, on seeded buffers and on every slice of real packets, and
its trailer zeroes the CRC of data + trailer."""

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.core.crc import crc32_ieee as j_crc32_ieee
from ffmpeg_ffv2_tpu_torch.core import crc as tcrc
from ffmpeg_ffv2_tpu_torch.ffv1 import native
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config, params_from_config


@pytest.mark.parametrize("n", [0, 1, 7, 4096, 1 << 20])
@pytest.mark.parametrize("start", [0, 0x9E3779B9])
def test_torch_crc_native_matches_loops(n, start):
    data = np.random.RandomState(n).randint(0, 256, n).astype(
        np.uint8).tobytes()
    got = native.crc32(data, start)
    assert got == tcrc.crc32_ieee(data, start)
    assert got == j_crc32_ieee(data, start)
    if start == 0:
        trailer = native.crc32_trailer(data)
        assert trailer == tcrc.crc32_trailer(data)
        assert trailer == got.to_bytes(4, "little")
        assert tcrc.crc32_ieee(data + trailer) == 0
        assert native.crc32(data + trailer) == 0


def _slices(pkt: bytes, ec: bool) -> list:
    """A version-3 packet's slices, each with its trailer (24-bit size,
    and with ``ec`` the error byte and the CRC), found from the end."""
    tail = 3 + (5 if ec else 0)
    out, end = [], len(pkt)
    while end > 0:
        size = int.from_bytes(pkt[end - tail:end - tail + 3], "big")
        start = end - tail - size
        assert start >= 0
        out.append(pkt[start:end])
        end = start
    return out[::-1]


@pytest.mark.parametrize("pix,coder", [("yuv420p", 1), ("yuv420p", 0),
                                       ("gbrp10", 1)])
def test_torch_crc_native_packets(pix, coder):
    """Every slice of NativeFFV1Codec's slice-CRC packets: its CRC over
    data + trailer is 0 in every implementation, and the trailer is what
    the native crc32_trailer gives for the bytes before it."""
    w, h = 64, 48
    cfg = FFV1Config(level=3, coder=coder, slices=4, slicecrc=1)
    p = params_from_config(cfg, pix, w, h)
    nat = NativeFFV1Codec(p)
    rng = np.random.RandomState(11)
    planes = [rng.randint(0, 1 << p.bits, s).astype(np.int32)
              for s in ([(h, w)] * 3 if p.colorspace else
                        [(h, w), (h // 2, w // 2), (h // 2, w // 2)])]
    n = 0
    for t in range(2):
        slices = _slices(nat.encode(planes, t == 0), p.ec)
        assert len(slices) == p.slice_count
        for sl in slices:
            assert native.crc32(sl) == 0
            assert tcrc.crc32_ieee(sl) == 0
            assert j_crc32_ieee(sl) == 0
            assert native.crc32_trailer(sl[:-4]) == sl[-4:]
            assert native.crc32(sl[:-4]) == tcrc.crc32_ieee(sl[:-4])
            n += 1
    assert n == 2 * p.slice_count
