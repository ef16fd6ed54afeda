"""The port's Golomb-Rice device encoder at coding depths 13-16 (the 16-bit
rice cell payload, pb = 16) against the JAX package and the native codec,
on the CPU.  The params are forced to Golomb-Rice with
``dataclasses.replace`` (the config picks the range coder above 8 bits);
a 12-bit format is the control at pb = 12.  Inputs are seeded numpy;
every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu.ffv1 import device_rice as jdr
from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu.ffv1.params import (CODER_GOLOMB, FFV1Config,
                                         params_from_config)
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.ffv1 import rice
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.vlc import vlc_adapt, vlc_adapt_plain
from test_torch_formats import torch_one_thread  # noqa: F401

W, H = 64, 48
CFG = FFV1Config(level=3, slices=4)


def _params(pix):
    return dataclasses.replace(params_from_config(CFG, pix, W, H),
                               ac=CODER_GOLOMB)


def _frames(p, n=3):
    """RandomState(3) frames over the full sample range."""
    rng = np.random.RandomState(3)
    shapes = [(H, W)]
    if p.chroma_planes:
        shapes += [(H >> p.chroma_v_shift, W >> p.chroma_h_shift)] * 2
    return [[rng.randint(0, 1 << p.bits, s).astype(np.int32)
             for s in shapes] for _ in range(n)]


@pytest.mark.parametrize("pix,pb", [("yuv420p16", 16), ("gray16", 16),
                                    ("yuv420p12", 12)])
def test_torch_rice_deep_matches_native_and_jax(pix, pb):
    """3 frames (the first a keyframe): the port's packets equal JAX
    ``DeviceFFV1Encoder(use_pallas=False)``'s and the native codec's, and
    its vcanon equals JAX's after each frame; the path ran the plain
    versions of every rice kernel."""
    p = _params(pix)
    assert rice.rice_pb(p.bits) == pb
    enc = DeviceFFV1Encoder(W, H, pix, CFG, device="cpu", params=p)
    assert enc.banks[0].rice_pb == pb
    jenc = jdc.DeviceFFV1Encoder(W, H, pix, CFG, use_pallas=False, params=p)
    nat = NativeFFV1Codec(p)
    _build.reset_counts()
    for t, planes in enumerate(_frames(p)):
        key = t == 0
        a = enc.encode(planes, force_keyframe=key)
        assert a == nat.encode(planes, key), f"frame {t} vs native"
        assert a == jenc.encode(planes, force_keyframe=key), \
            f"frame {t} vs JAX"
        assert np.array_equal(np.asarray(enc.state()),
                              np.asarray(jenc.vcanon)), f"frame {t} vcanon"
    for name in enc.kernels:
        k = _build.KERNELS[name]
        assert k.launches == 0 and k.plain_calls > 0, name


@pytest.fixture(scope="module")
def cells16():
    """One yuv420p16 frame's K5 inputs from the JAX encoder's stages, with a
    random canonical vlc table (the states the walk starts from).  The
    frame's lower half is flat, so it holds runs (silent cells) too."""
    p = _params("yuv420p16")
    dev = jdc.DeviceFFV1Encoder(W, H, "yuv420p16", CFG, use_pallas=False,
                                params=p)
    planes = _frames(p, 1)[0]
    for x in planes:
        x[x.shape[0] // 2:] = 40000
    ctx, streams = dev._phase_a_rice([jnp.asarray(x) for x in planes])
    plan = dev._s_rice_layout(ctx, streams["payload"], dev.tiles_cap,
                              dev.cellrows_cap)
    ch1c, _ = dev._s_scatter(plan, dev.cellrows_cap)
    vrng = np.random.RandomState(4)
    rows = dev.vcanon.shape[0]
    vcanon = np.stack([-vrng.randint(0, 129, rows),
                       vrng.randint(0, 1 << 16, rows),
                       vrng.randint(-128, 128, rows),
                       vrng.randint(1, 129, rows)], 1).astype(np.int32)
    s0 = jdr.build_vlc_s0(plan, jnp.asarray(vcanon), dev.tiles_cap)
    args = (ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
            s0)
    ref = jdr.vlc_adapt_reference(*args, dev.tiles_cap, 16)
    return dict(args=[torch.as_tensor(np.array(a)) for a in args],
                ref=[np.asarray(r) for r in ref], n_rows=int(plan["n_rows"]),
                n_tiles=int(plan["n_tiles"]), payload=streams["payload"])


def test_torch_vlc_adapt_plain_pb16(cells16):
    """``vlc_adapt_plain`` at pb = 16 equals the JAX ``vlc_adapt_reference``
    on one frame's cells (code cells and live tiles' end states), and the
    wrapper takes it on CPU tensors; the 16-bit payloads really use the
    high field (diffs past 12 bits) and the silent flag at bit 16."""
    pay = np.asarray(cells16["payload"])
    diff = (pay & 0xFFFF) - (1 << 15)
    assert np.abs(diff).max() >= 1 << 11
    assert ((pay >> 16) & 1).any()
    code, ends = vlc_adapt_plain(*cells16["args"], 16)
    ref_code, ref_ends = cells16["ref"]
    nr, nt = cells16["n_rows"], cells16["n_tiles"]
    assert np.array_equal(code[:nr].numpy(), ref_code[:nr])
    assert np.array_equal(ends[:nt].numpy(), ref_ends[:nt])
    assert (code[:nr] >> 18).max() > 12 + 8      # codes longer than 8-bit's
    _build.reset_counts()
    got = vlc_adapt(*cells16["args"], 16)
    k = _build.KERNELS["vlc"]
    assert k.plain_calls == 1 and k.launches == 0
    assert all(torch.equal(a, b) for a, b in zip(got, (code, ends)))


def test_torch_build_rice_streams_pb16():
    """The 16-bit payload field (diff + 2^15 | silent << 16) equals JAX's."""
    rng = np.random.default_rng(12)
    planes = []
    for h, w in ((6, 37), (3, 19), (3, 19)):
        diff = rng.integers(-40000, 40000, size=(2, h, w)).astype(np.int32)
        diff[rng.random((2, h, w)) < 0.5] = 0
        ctx = rng.integers(0, 5, size=(2, h, w)).astype(np.int32)
        planes.append((ctx, diff))
    got = rice.build_rice_streams([torch.as_tensor(c) for c, _ in planes],
                                  [torch.as_tensor(d) for _, d in planes],
                                  pb=16)
    ref = jdr.build_rice_streams([jnp.asarray(c) for c, _ in planes],
                                 [jnp.asarray(d) for _, d in planes], pb=16)
    for k in ref:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k


def test_torch_rice_depth17_refused():
    """rgb48 codes at depth 17, past the 16-bit cell payload: the port
    refuses Golomb-Rice there, in the encoder and in ``rice_pb``, while
    the range coder still takes it."""
    p = _params("rgb48")
    with pytest.raises(NotImplementedError, match="coding depth 17"):
        DeviceFFV1Encoder(W, H, "rgb48", CFG, device="cpu", params=p)
    with pytest.raises(NotImplementedError):
        rice.rice_pb(17)
    assert rice.rice_pb(16) == 16 and rice.rice_pb(12) == 12
    enc = DeviceFFV1Encoder(W, H, "rgb48", CFG, device="cpu").banks[0]
    assert not enc.golomb and enc.code_bits == 17
