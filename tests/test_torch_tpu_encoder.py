"""The PyTorch port's hybrid TPUFFV1Encoder on the CPU: phase A's per-slice
(ctx, diff) crops equal the JAX TPUFFV1Encoder's, and its packets equal the
port's native codec's and decode back to the input (test_tpu_phase_a.py's
cases)."""

import numpy as np
import pytest
import torch

from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config as JConfig
from ffmpeg_ffv2_tpu.ffv1.tpu_encoder import TPUFFV1Encoder as JEncoder
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu_torch.ffv1.tpu_encoder import TPUFFV1Encoder
from test_torch_formats import torch_one_thread  # noqa: F401


def _planes(seed, w, h, bits=8, hs=1, vs=1, nplanes=3):
    """test_tpu_phase_a.py:_planes: a luma ramp with 2-bit noise, noisy
    chroma."""
    rng = np.random.RandomState(seed)
    mx = (1 << bits) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(((xx * 3 + yy + seed) % (mx + 1)) // 8 * 8
                + rng.randint(0, 3, (h, w)), 0, mx)
    out = [y.astype(np.int64)]
    cw, ch = -(-w >> hs), -(-h >> vs)
    for _ in range(nplanes - 1):
        out.append(rng.randint(0, mx + 1, (ch, cw)).astype(np.int64))
    return out


def _check(fmt, cfg, w, h, frames, key_of):
    """Phase A against JAX on every frame, packets against the native
    codec and its decode."""
    enc = TPUFFV1Encoder(w, h, fmt, FFV1Config(**cfg), device="cpu")
    jenc = JEncoder(w, h, fmt, JConfig(**cfg))
    nat, dec = NativeFFV1Codec(enc.p), NativeFFV1Codec(enc.p)
    assert enc.extradata == jenc.extradata
    for t, planes in enumerate(frames):
        ctx, diff = enc.phase_a(planes)
        jctx, jdiff = jenc.phase_a(planes)
        for a, b in zip(ctx + diff, list(jctx) + list(jdiff)):
            assert a.dtype == np.int16 and a.shape == np.asarray(b).shape
            assert np.array_equal(a, np.asarray(b)), f"frame {t}: phase A"
        key = key_of(t)
        a = enc.encode(planes, force_keyframe=key)
        assert a == nat.encode(planes, key), f"frame {t}: packet"
        for x, y in zip(planes, dec.decode(a)):
            assert np.array_equal(x, y), f"frame {t}: decode"


CASES = [
    ("v3-golomb", dict(slices=4), "yuv420p", 8, 1, 1),
    ("v3-range", dict(slices=4, coder=2), "yuv420p", 8, 1, 1),
    ("v0", dict(), "yuv420p", 8, 1, 1),
    ("v3-ctx1", dict(slices=4, context=1, coder=2), "yuv420p", 8, 1, 1),
    ("v3-16bit", dict(level=3, slices=4), "yuv444p16", 16, 0, 0),
    ("v3-gray", dict(slices=4), "gray", 8, 0, 0),
]


@pytest.mark.parametrize("name,cfg,fmt,bits,hs,vs", CASES,
                         ids=[c[0] for c in CASES])
def test_torch_tpu_encoder_matches_jax_and_native(name, cfg, fmt, bits, hs,
                                                  vs):
    """Odd slice geometries: 70x44 4:2:0 (chroma slices overlap a column),
    69x47 for the 4:4:4 and gray cases."""
    w, h = (70, 44) if hs or vs else (69, 47)
    frames = []
    for t in range(3):
        if bits == 16:
            rng = np.random.RandomState(t)
            frames.append([rng.randint(0, 65536, (h, w)).astype(np.int64)
                           for _ in range(3)])
        else:
            frames.append(_planes(20 + t, w, h, bits, hs, vs,
                                  1 if fmt == "gray" else 3))
    gop = FFV1Config(**cfg).gop_size
    _check(fmt, cfg, w, h, frames, lambda t: t % gop == 0)


@pytest.mark.parametrize("pix,coder", [
    ("bgr0", 1),          # 8-bit RGB, range coder
    ("bgr0", -1),         # 8-bit RGB, Golomb-Rice (shared run index)
    ("gbrp10", 1),        # 9..14-bit planar: the G/B swap
])
def test_torch_tpu_encoder_rgb(pix, coder):
    """RGB phase A with the fixed RCT, row-interleaved planes and the
    bits + 1 coding depth (ffv1enc_template.c:encode_rgb_frame)."""
    rng = np.random.RandomState(2)
    w, h = 64, 48
    cfg = dict(level=3, coder=coder, slices=4)
    mx = (1 << (10 if pix == "gbrp10" else 8)) - 1
    frames = [[rng.randint(0, mx + 1, (h, w)).astype(np.int32)
               for _ in range(3)] for _ in range(3)]
    _check(pix, cfg, w, h, frames, lambda t: t % 2 == 0)


def test_torch_tpu_encoder_scope():
    """What the JAX hybrid leaves out raises here too, and the default
    device is the card."""
    with pytest.raises(NotImplementedError, match="version <= 3"):
        TPUFFV1Encoder(64, 48, "bgr0", FFV1Config(level=4, slices=4),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="14 bpc"):
        TPUFFV1Encoder(64, 48, "rgb48", FFV1Config(level=3, slices=4),
                       device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TPUFFV1Encoder(64, 48, "yuv420p", FFV1Config(slices=4))
