"""The port's copy of the FATE synthetic sources
(``ffmpeg_ffv2_tpu_torch.testsrc``) against the JAX package's
``ffmpeg_ffv2_tpu.testsrc``, element for element: the LCG sequences, the
exact RGB24 -> yuv420p conversion, vsynth1 and vsynth3 at seeded sizes and
frame counts, and rotozoom on a seeded texture written to a PNM file (the
reference's ``tests/reference.pnm`` is not in the repository)."""

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.testsrc import rotozoom as jrot
from ffmpeg_ffv2_tpu.testsrc import videogen as jvg
from ffmpeg_ffv2_tpu_torch.testsrc import rotozoom, videogen
from ffmpeg_ffv2_tpu_torch import testsrc


def _same_frames(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for fa, fb in zip(a, b):
        assert len(fa) == len(fb)
        for pa, pb in zip(fa, fb):
            assert pa.dtype == pb.dtype and np.array_equal(pa, pb)


@pytest.mark.parametrize("seed, n", [(0, 1), (1, 7), (12345, 300),
                                     (2 ** 32 - 1, 1000)])
def test_torch_testsrc_lcg_sequences(seed, n):
    """lcg_sequence and myrnd_sequence (n 256, 50 and 21) equal the
    original's."""
    got = videogen.lcg_sequence(seed, n)
    assert got.dtype == np.uint64
    assert np.array_equal(got, jvg.lcg_sequence(seed, n))
    for m in (256, 50, 21):
        assert np.array_equal(videogen.myrnd_sequence(seed, n, m),
                              jvg.myrnd_sequence(seed, n, m))


@pytest.mark.parametrize("seed, wh", [(0, (34, 34)), (1, (64, 48)),
                                      (2, (352, 288))])
def test_torch_testsrc_rgb24_to_yuv420p(seed, wh):
    w, h = wh
    rgb = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    _same_frames([testsrc.rgb24_to_yuv420p(rgb)],
                 [jvg.rgb24_to_yuv420p(rgb)])


@pytest.mark.parametrize("n, wh", [(3, (64, 48)), (5, (96, 80)),
                                   (2, (352, 288))])
def test_torch_testsrc_vsynth1(n, wh):
    """vsynth1 at seeded sizes (objects clipped at the frame's edges, the
    noise patch cropped) equals the original's."""
    rng = np.random.RandomState(n)
    w, h = wh[0] + 2 * rng.randint(0, 4), wh[1] + 2 * rng.randint(0, 4)
    _same_frames(testsrc.vsynth1_frames(n, w, h),
                 jvg.vsynth1_frames(n, w, h))


@pytest.mark.parametrize("n", [1, 4])
def test_torch_testsrc_vsynth3(n):
    """vsynth3, the odd 34x34 clip, equals the original's."""
    _same_frames(testsrc.vsynth3_frames(n), jvg.vsynth3_frames(n))


@pytest.mark.parametrize("seed, n, wh", [(3, 3, (64, 48)),
                                         (4, 2, (352, 288))])
def test_torch_testsrc_rotozoom(tmp_path, seed, n, wh):
    """rotozoom on a seeded 256x256 P6 texture (its 15-byte header skip
    included) equals the original's, and load_texture reads the same
    tables."""
    body = np.random.RandomState(seed).randint(0, 256, 3 * 256 * 256)
    pnm = tmp_path / "texture.pnm"
    pnm.write_bytes(b"P6\n256 256\n255\n" + body.astype(np.uint8).tobytes())
    for a, b in zip(rotozoom.load_texture(str(pnm)),
                    jrot.load_texture(str(pnm))):
        assert np.array_equal(a, b)
    _same_frames(testsrc.rotozoom_frames(str(pnm), n, *wh),
                 jrot.rotozoom_frames(str(pnm), n, *wh))
