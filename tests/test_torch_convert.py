"""The port's pixel-format conversions on the CPU: its numpy models
(``convert/yuv_rgb.py``, a copy) and their tables against the JAX
package's, and each function of ``convert/device.py`` (plain PyTorch,
``device="cpu"``) against JAX ``convert/tpu.py`` and the numpy models,
exactly, at ``tests/test_convert_tpu.py``'s 96x128 inputs and seeds."""

import filecmp
import os

import numpy as np
import pytest
import torch

from ffmpeg_ffv2_tpu.convert import tpu as jdev
from ffmpeg_ffv2_tpu.convert import yuv_rgb as jhost
from ffmpeg_ffv2_tpu.ffv1 import tpu as jtpu
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu.ffv1.params import params_from_config as jparams
from ffmpeg_ffv2_tpu_torch.convert import device as dev
from ffmpeg_ffv2_tpu_torch.convert import yuv_rgb as host
from ffmpeg_ffv2_tpu_torch.ffv1 import phase_a as pa
from ffmpeg_ffv2_tpu_torch.ffv1.params import params_from_config
from test_torch_formats import torch_one_thread  # noqa: F401

H, W = 96, 128
TABLES = ("rgb2yuv_bgr0.npz", "rgb2yuv_rgb48.npz", "rgb2yuv_gbrp16.npz",
          "yuv2rgb_bgr0.npz")


def _yuv(seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (H, W)).astype(np.uint8),
            rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8),
            rng.randint(0, 256, (H // 2, W // 2)).astype(np.uint8))


def _np(t):
    return t.numpy()


@pytest.mark.parametrize("name", TABLES)
def test_torch_convert_tables_are_copies(name):
    """The port's tables equal the JAX package's byte for byte."""
    a = os.path.join(os.path.dirname(host.__file__), name)
    b = os.path.join(os.path.dirname(jhost.__file__), name)
    assert filecmp.cmp(a, b, shallow=False)


def test_torch_convert_host_models_match_jax():
    """The port's numpy models equal the JAX package's on every
    conversion."""
    y, u, v = _yuv(0)
    assert np.array_equal(host.yuv420p_to_bgr0(y, u, v),
                          jhost.yuv420p_to_bgr0(y, u, v))
    assert np.array_equal(host.yuv420p_to_rgb48(y, u, v),
                          jhost.yuv420p_to_rgb48(y, u, v))
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (H, W, 4)).astype(np.uint8)
    img48 = rng.randint(0, 65536, (H, W, 3)).astype(np.int64)
    g, b, r = (rng.randint(0, 65536, (H, W)).astype(np.int64)
               for _ in range(3))
    for fn, args in ((host.bgr0_to_yuv420p, (img,)),
                     (host.rgb48_to_yuv420p, (img48,)),
                     (host.gbrp16_to_yuv420p, (g, b, r))):
        ref = getattr(jhost, fn.__name__)(*args)
        for a, o in zip(fn(*args), ref):
            assert np.array_equal(a, o), fn.__name__


def test_torch_yuv420p_to_bgr0():
    y, u, v = _yuv(0)
    out = dev.yuv420p_to_bgr0(y, u, v, device="cpu")
    assert out.dtype == torch.uint8 and out.shape == (H, W, 4)
    assert np.array_equal(_np(out), host.yuv420p_to_bgr0(y, u, v))
    assert np.array_equal(_np(out), np.asarray(jdev.yuv420p_to_bgr0(y, u,
                                                                    v)))


def _unwrapped_rgb48_sums(y, u, v):
    """The rgb48 writer's sums without the int32 wrap (Python ints)."""
    y = y.astype(np.int64)
    uu = np.repeat(np.repeat(u.astype(np.int64), 2, 0), 2, 1)[:H, :W]
    vv = np.repeat(np.repeat(v.astype(np.int64), 2, 0), 2, 1)[:H, :W]
    Y1 = ((y << 9) - host._YO) * host._YC + (1 << 13)
    U, V = (uu - 128) << 9, (vv - 128) << 9
    return [V * host._V2R + Y1, V * host._V2G + U * host._U2G + Y1,
            U * host._U2B + Y1]


@pytest.mark.parametrize("case", ["random", "wraps"])
def test_torch_yuv420p_to_rgb48(case):
    """Seed 1 as test_convert_tpu.py, and an input whose sums pass 2^31 -
    1 (bright luma with the largest u and v), so the int32 wrap shows."""
    y, u, v = _yuv(1)
    if case == "wraps":
        y[:H // 2] = 255 - np.arange(W, dtype=np.uint8) % 24
        u[:H // 4] = 255 - np.arange(W // 2, dtype=np.uint8) % 8
        v[:H // 4] = 255
        over = [int((s > 2 ** 31 - 1).sum())
                for s in _unwrapped_rgb48_sums(y, u, v)]
        assert over[2] > 0, over            # B's sum wraps
    out = dev.yuv420p_to_rgb48(y, u, v, device="cpu")
    assert out.dtype == torch.int32 and out.shape == (H, W, 3)
    ref = host.yuv420p_to_rgb48(y, u, v)
    assert np.array_equal(_np(out), ref)
    assert np.array_equal(_np(out).astype(np.uint16),
                          np.asarray(jdev.yuv420p_to_rgb48(y, u, v)))


def test_torch_bgr0_to_yuv420p():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (H, W, 4)).astype(np.uint8)
    got = dev.bgr0_to_yuv420p(img, device="cpu")
    for a, b, c in zip(got, host.bgr0_to_yuv420p(img),
                       jdev.bgr0_to_yuv420p(img)):
        assert a.dtype == torch.uint8
        assert np.array_equal(_np(a), b)
        assert np.array_equal(_np(a), np.asarray(c))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_torch_rgb48_to_yuv420p(as_tensor):
    """numpy uint16 input, and an int32 tensor (the form yuv420p_to_rgb48
    returns)."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 65536, (H, W, 3)).astype(np.int64)
    arg = (torch.as_tensor(img.astype(np.int32)) if as_tensor
           else img.astype(np.uint16))
    got = dev.rgb48_to_yuv420p(arg, device="cpu")
    for a, b, c in zip(got, host.rgb48_to_yuv420p(img),
                       jdev.rgb48_to_yuv420p(img.astype(np.uint16))):
        assert np.array_equal(_np(a), b)
        assert np.array_equal(_np(a), np.asarray(c))


def test_torch_gbrp16_to_yuv420p():
    rng = np.random.RandomState(4)
    g, b, r = (rng.randint(0, 65536, (H, W)).astype(np.int64)
               for _ in range(3))
    u16 = [x.astype(np.uint16) for x in (g, b, r)]
    got = dev.gbrp16_to_yuv420p(*u16, device="cpu")
    for a, o, c in zip(got, host.gbrp16_to_yuv420p(g, b, r),
                       jdev.gbrp16_to_yuv420p(*u16)):
        assert np.array_equal(_np(a), o)
        assert np.array_equal(_np(a), np.asarray(c))


def test_torch_fused_bgr0_phase_a():
    """The fused conversion + phase A == JAX's fused program, and == the
    staged numpy conversion + the port's plane_context_diff."""
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (H, W, 4)).astype(np.uint8)
    cfg = FFV1Config(level=3)
    qt = pa.lut_for(params_from_config(cfg, "yuv420p", W, H), 0)
    jqt = jtpu.lut_for(jparams(cfg, "yuv420p", W, H), 0)
    fused = dev.fused_bgr0_phase_a(img, qt, 8, False, device="cpu")
    jfused = jdev.fused_bgr0_phase_a(img, jqt, 8, False)
    for (fc, fd), (jc, jd), pl in zip(fused, jfused,
                                      host.bgr0_to_yuv420p(img)):
        sc, sd = pa.plane_context_diff(
            pa._wrap16(torch.as_tensor(pl.astype(np.int32))), qt, 8, False)
        assert torch.equal(fc, sc) and torch.equal(fd, sd)
        assert np.array_equal(_np(fc), np.asarray(jc))
        assert np.array_equal(_np(fd), np.asarray(jd))


def test_torch_convert_needs_a_card_for_cuda(monkeypatch):
    """device="cuda" with no card raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y, u, v = _yuv(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dev.yuv420p_to_bgr0(y, u, v)
