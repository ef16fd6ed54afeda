"""The PyTorch port's DeviceFFV1Encoder on deep YUV and RGB formats, end to
end on the CPU (every kernel wrapper runs its plain PyTorch version on CPU
tensors): packets equal NativeFFV1Codec's (the port's own copy) byte for
byte over key, inter and flat frames, and decode back to the input; rgb48
at version 4 also equals the JAX DeviceFFV1Encoder's packets and state
table.  Shape banks and the emission-order walk: test_torch_banks.py."""

import numpy as np
import pytest
import torch

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config, params_from_config


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """The plain versions' tensor ops run on one thread per process: the
    suite runs its files in parallel processes, and a thread pool in each
    would oversubscribe the cores (the torch test files import this)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(p, w, h):
    if p.colorspace == 1:
        return [(h, w)] * (3 + p.transparency)
    return [(h, w)] + ([(-(-h >> p.chroma_v_shift), -(-w >> p.chroma_h_shift))]
                       * 2 if p.chroma_planes else [])


def _frames(p, w, h, seed):
    """Key (full-range noise), inter (a ramp with sparse noise), flat."""
    rng = np.random.RandomState(seed)
    mx = 1 << p.bits
    key = [rng.randint(0, mx, s).astype(np.int32) for s in _shapes(p, w, h)]
    inter = []
    for c, (hh, ww) in enumerate(_shapes(p, w, h)):
        yy, xx = np.mgrid[0:hh, 0:ww]
        ramp = (xx * (mx // 61 + 1) + yy * 7 + 99 * c) % mx
        inter.append(np.where(rng.rand(hh, ww) < 0.1,
                              rng.randint(0, mx, (hh, ww)), ramp)
                     .astype(np.int32))
    flat = [np.full(s, mx // 3, np.int32) for s in _shapes(p, w, h)]
    return [key, inter, flat]


def _run(pix, wh, level, coder, emission=False, lossless=True):
    w, h = wh
    cfg = FFV1Config(level=level, coder=coder, slices=4, slicecrc=1)
    p = params_from_config(cfg, pix, w, h)
    enc = DeviceFFV1Encoder(w, h, pix, cfg, device="cpu",
                            emission_order=emission)
    nat, dec, dec2 = (NativeFFV1Codec(p) for _ in range(3))
    for t, planes in enumerate(_frames(p, w, h, 5)):
        a = enc.encode(planes, force_keyframe=t == 0)
        b = nat.encode(planes, t == 0)
        assert a == b, f"{pix} frame {t}: {len(a)} vs {len(b)} bytes"
        # non-uniform geometries may leave the last ceil-rounded chroma
        # column uncoded: compare with the native round trip there
        ref = planes if lossless else dec2.decode(b)
        for x, y in zip(dec.decode(a), ref):
            assert np.array_equal(x, y), f"{pix} frame {t}: decode"
    return enc


@pytest.mark.parametrize("pix,wh", [("yuv420p12", (32, 24)),
                                    ("yuv444p16", (24, 16)),
                                    ("gray16", (32, 24))])
def test_torch_encoder_deep_yuv(pix, wh):
    enc = _run(pix, wh, 3, 1).banks[0]
    assert enc.code_bits > 10 and enc.wide in (16, 17)


@pytest.mark.parametrize("pix,wh,level", [("bgr0", (32, 24), 3),
                                          ("bgr0", (32, 24), 4),
                                          ("gbrp10", (32, 24), 4),
                                          ("rgb48", (24, 16), 3),
                                          ("rgb48", (24, 16), 4)])
def test_torch_encoder_rgb(pix, wh, level):
    enc = _run(pix, wh, level, 1).banks[0]
    assert enc.v4rgb == (level == 4)
    if pix == "rgb48":
        assert enc.p.use32bit and enc.code_bits == 17


def test_torch_encoder_rgb_rice():
    """FATE's bgr0 Golomb-Rice configuration: one run-index ladder over
    the line-interleaved stream."""
    enc = _run("bgr0", (32, 24), 3, 0)
    assert enc.kernels == ("phase_a", "place", "vlc", "ladder")


@pytest.fixture(scope="module")
def jax_rgb48():
    """The JAX encoder (its XLA reference path) on an rgb48 v4 keyframe and
    an inter frame."""
    w, h = 24, 16
    cfg = FFV1Config(level=4, coder=1, slices=4, slicecrc=1)
    p = params_from_config(cfg, "rgb48", w, h)
    frames = _frames(p, w, h, 9)[:2]
    jenc = jdc.DeviceFFV1Encoder(w, h, "rgb48", cfg, use_pallas=False)
    pkts, states = [], []
    for t, planes in enumerate(frames):
        pkts.append(jenc.encode(planes, force_keyframe=t == 0))
        states.append(np.asarray(jenc.canonical).copy())
    return dict(w=w, h=h, cfg=cfg, frames=frames, pkts=pkts, states=states)


def test_torch_encoder_rgb48_v4_matches_jax(jax_rgb48):
    j = jax_rgb48
    enc = DeviceFFV1Encoder(j["w"], j["h"], "rgb48", j["cfg"], device="cpu")
    for t, planes in enumerate(j["frames"]):
        assert enc.encode(planes, force_keyframe=t == 0) == j["pkts"][t]
        assert np.array_equal(enc.state(), j["states"][t]), t
