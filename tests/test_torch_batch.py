"""The port's DeviceFFV1Encoder.encode_batch on the CPU (every kernel
wrapper runs its plain PyTorch version on CPU tensors), at 64x48 / 4
slices, against three references: the JAX DeviceFFV1Encoder's
encode_batch (its XLA reference path, use_pallas=False), the native codec
frame by frame (and its lossless decode), and the session afterwards (its
state table, picture number and layout caps as they were, and its next
inter frame equal to a native session's).  yuv420p and 2-pass here; deep
YUV, RGB and the emission-order walk in test_torch_batch_formats.py; the
refusals (shape banks, v4 RGB, Golomb-Rice) here."""

import dataclasses

import numpy as np
import pytest
import torch

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.convert import device as conv
from ffmpeg_ffv2_tpu_torch.convert import yuv_rgb
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from test_torch_formats import torch_one_thread  # noqa: F401

W, H = 64, 48
CFG = FFV1Config(level=3, coder=1, slices=4)


def shapes_of(p, w=W, h=H):
    if p.colorspace == 1:
        return [(h, w)] * (3 + p.transparency)
    return [(h, w)] + ([(-(-h >> p.chroma_v_shift), -(-w >> p.chroma_h_shift))]
                       * 2 if p.chroma_planes else [])


def random_frames(p, n, seed=3, flat=None):
    """``n`` frames of full-range noise from ``RandomState(seed)``; frame
    ``flat`` (if given) is flat (test_device_coder.py:221)."""
    rng = np.random.RandomState(seed)
    shapes = shapes_of(p)
    frames = [[rng.randint(0, 1 << p.bits, s).astype(np.int32)
               for s in shapes] for _ in range(n)]
    if flat is not None:
        frames[flat] = [np.full(s, 77 << max(0, p.bits - 8), np.int32)
                        for s in shapes]
    return frames


def check_batch(pix, frames, cfg=CFG, params=None, emission=False):
    """encode_batch(frames) against JAX's encode_batch, the native codec
    frame by frame and its decode; the session (one key frame before the
    batch, one inter frame after) against a native session.  Returns the
    port's encoder."""
    p = params if params is not None else params_from_config(cfg, pix, W, H)
    enc = DeviceFFV1Encoder(W, H, pix, cfg, device="cpu", params=params,
                            emission_order=emission)
    sess, nat, dec = (NativeFFV1Codec(p) for _ in range(3))
    before, after = random_frames(p, 2, seed=17)
    assert enc.encode(before, force_keyframe=True) == sess.encode(before,
                                                                  True)
    state = enc.state()
    caps = (enc.banks[0].caps.tiles_cap, enc.banks[0].caps.cellrows_cap,
            enc.picture_number)
    _build.reset_counts()
    pkts = enc.encode_batch(frames)
    assert len(pkts) == len(frames)
    for name, k in _build.KERNELS.items():
        assert k.launches == 0
        assert (k.plain_calls > 0) == (name in enc.kernels), name
    for t, (f, pkt) in enumerate(zip(frames, pkts)):
        ref = nat.encode(f, True)
        assert pkt == ref, f"frame {t}: {len(pkt)} vs {len(ref)} bytes"
        for a, b in zip(dec.decode(pkt), f):
            assert np.array_equal(a, b), f"frame {t}"
    jenc = jdc.DeviceFFV1Encoder(W, H, pix, cfg, use_pallas=False,
                                 params=params)
    assert jenc.encode_batch(frames) == pkts
    assert np.array_equal(enc.state(), state)
    assert (enc.banks[0].caps.tiles_cap, enc.banks[0].caps.cellrows_cap,
            enc.picture_number) == caps
    assert enc.encode(after, force_keyframe=False) == sess.encode(after,
                                                                  False)
    return enc


@pytest.mark.parametrize("B", [1, 3])
def test_torch_encode_batch_yuv420p(B):
    """B = 3 has a flat frame between two noise frames, as the JAX test;
    the batch keeps caps of its own per B."""
    p = params_from_config(CFG, "yuv420p", W, H)
    enc = check_batch("yuv420p", random_frames(p, B, flat=1 if B > 1
                                               else None))
    assert list(enc.banks[0].batch_caps) == [B]


def test_torch_encode_batch_twopass_initial_states():
    """2-pass params= with per-context initial states (one quant table's
    set, the other's left at None): every frame of the batch starts from
    them, tiled over B x S slices."""
    p = params_from_config(CFG, "yuv420p", W, H)
    rng = np.random.RandomState(12)
    init = [None] * len(p.context_counts)
    init[p.context_model] = rng.randint(
        1, 256, (p.context_counts[p.context_model], 32)).astype(np.uint8)
    p = dataclasses.replace(p, initial_states=init)
    enc = check_batch("yuv420p", random_frames(p, 2, flat=1), params=p)
    bank = enc.banks[0]
    key = bank.key_canonical(2 * bank.S).numpy()
    assert np.array_equal(key[:-1], np.tile(bank.canonical_key1.numpy(),
                                            (2 * bank.S, 1)))
    assert np.any(key[:-1] != 128) and np.all(key[-1] == 128)


def test_torch_encode_batch_takes_device_tensors():
    """The capture path: bgr0 frames through bgr0_to_yuv420p (device
    "cpu"), their tensors handed to encode_batch as they are; packets
    equal the native codec's on the numpy model's planes."""
    rng = np.random.RandomState(6)
    imgs = [rng.randint(0, 256, (H, W, 4)).astype(np.uint8)
            for _ in range(3)]
    p = params_from_config(CFG, "yuv420p", W, H)
    enc = DeviceFFV1Encoder(W, H, "yuv420p", CFG, device="cpu")
    planes = [conv.bgr0_to_yuv420p(img, device="cpu") for img in imgs]
    assert all(torch.is_tensor(x) and x.dtype == torch.uint8
               for f in planes for x in f)
    nat = NativeFFV1Codec(p)
    refs = [nat.encode([x.astype(np.int32) for x in
                        yuv_rgb.bgr0_to_yuv420p(img)], True) for img in imgs]
    assert enc.encode_batch(planes) == refs


@pytest.mark.parametrize("pix,wh,level,match", [
    ("yuv420p", (35, 33), 3, "non-uniform"),
    ("bgr0", (64, 48), 4, "v4 RGB")])
def test_torch_encode_batch_refuses(pix, wh, level, match):
    """Shape banks and v4 RGB raise NotImplementedError, as the JAX
    encode_batch does."""
    w, h = wh
    cfg = FFV1Config(level=level, coder=1, slices=4)
    enc = DeviceFFV1Encoder(w, h, pix, cfg, device="cpu")
    p = params_from_config(cfg, pix, w, h)
    frame = [np.zeros(s, np.int32) for s in shapes_of(p, w, h)]
    with pytest.raises(NotImplementedError, match=match):
        enc.encode_batch([frame])
    jenc = jdc.DeviceFFV1Encoder(w, h, pix, cfg, use_pallas=False)
    with pytest.raises(NotImplementedError):
        jenc.encode_batch([frame])


def test_torch_encode_batch_refuses_golomb_rice():
    """Golomb-Rice raises NotImplementedError.  The reason: the JAX
    encode_batch runs the range pipeline under a rice stream header, so
    its packets differ from the native codec's (yuv420p 64x48, coder=0,
    RandomState(3): 6470 bytes against 6092)."""
    cfg = FFV1Config(level=3, coder=0, slices=4)
    p = params_from_config(cfg, "yuv420p", W, H)
    frames = random_frames(p, 3, flat=1)
    enc = DeviceFFV1Encoder(W, H, "yuv420p", cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="Golomb-Rice"):
        enc.encode_batch(frames)
    jpk = jdc.DeviceFFV1Encoder(W, H, "yuv420p", cfg,
                                use_pallas=False).encode_batch(frames)
    ref = NativeFFV1Codec(p).encode(frames[0], True)
    assert (len(jpk[0]), len(ref)) == (6470, 6092)


def test_torch_bench_batch_scale_cpu():
    """tools/bench_batch_scale.py's steps on the CPU (plain versions) at
    64x48: the gate passes, a row a B with K4 on the batch's B x S
    slices, and one for encode()."""
    from ffmpeg_ffv2_tpu_torch.tools import bench_batch_scale as bbs
    p = params_from_config(CFG, "yuv420p", W, H)
    frames = random_frames(p, 2)
    enc = DeviceFFV1Encoder(W, H, "yuv420p", CFG, device="cpu")
    pkts = bbs.gate(enc, frames, (1, 2))
    assert pkts[2][:1] == pkts[1]
    staged = [enc.upload(f) for f in frames]
    row, (k4, n_ops) = bbs.time_batch(enc, staged, 2, 1)
    assert row["slices"] == 8 and k4[0].shape[0] == n_ops.shape[0] == 8
    assert row["k4_live_steps"] == int(n_ops.max()) <= row["k4_steps"]
    assert bbs.time_encode(enc, staged, 1)["frames"] == 2
