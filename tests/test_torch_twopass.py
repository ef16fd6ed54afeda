"""The PyTorch port's 2-pass flow on the CPU: its twopass module against the
JAX package's (stats text, the pass-2 transition table and initial
states), and DeviceFFV1Encoder with pass-2 parameters against
NativeFFV1Codec(p2), decoded through the extradata (test_twopass.py:
102-132 in the port's form)."""

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.ffv1 import headers as JH
from ffmpeg_ffv2_tpu.ffv1 import twopass as jtp
from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec as JNative
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config as JConfig
from ffmpeg_ffv2_tpu.ffv1.params import params_from_config as jparams
from ffmpeg_ffv2_tpu_torch.ffv1 import host
from ffmpeg_ffv2_tpu_torch.ffv1 import twopass as tp
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config, params_from_config
from test_torch_formats import torch_one_thread  # noqa: F401

W, H = 64, 48


def _frames(n=3, seed=5):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    out = []
    for t in range(n):
        y = ((xx * 3 + yy * 2 + 7 * t) % 256 // 4 * 4
             + rng.randint(0, 4, (H, W)))
        out.append([y.astype(np.int32)] + [
            ((xx[::2, ::2] + yy[::2, ::2] * k + t) % 256
             + rng.randint(0, 2, (H // 2, W // 2))).astype(np.int32)
            for k in (1, 3)])
    return out


def _pass1(cfg_kw, frames):
    """Stats text of a native pass-1 session of the port."""
    p1 = params_from_config(FFV1Config(**cfg_kw), "yuv420p", W, H)
    enc = NativeFFV1Codec(p1)
    enc.enable_stats()
    for t, f in enumerate(frames):
        enc.encode(f, t == 0)
    rc, rc2, gob = tp.collect_stats(enc)
    return p1, rc, rc2, gob, tp.stats_to_text(p1, rc, rc2, gob)


@pytest.mark.parametrize("coder", [2, 1])
def test_torch_twopass_matches_jax(coder):
    """collect_stats and stats_to_text equal the JAX session's; the port's
    apply_pass2 of the JAX stats text gives the JAX arrays; parse_stats
    inverts stats_to_text."""
    cfg_kw = dict(level=3, coder=coder, slices=4)
    frames = _frames()
    p1, rc, rc2, gob, txt = _pass1(cfg_kw, frames)
    jenc = JNative(jparams(JConfig(**cfg_kw), "yuv420p", W, H))
    jenc.enable_stats()
    for t, f in enumerate(frames):
        jenc.encode(f, t == 0)
    jrc, jrc2, jgob = jtp.collect_stats(jenc)
    assert gob == jgob == 1
    assert np.array_equal(rc, jrc) and np.array_equal(rc2, jrc2)
    jtxt = jtp.stats_to_text(jenc.p, jrc, jrc2, jgob)
    assert txt == jtxt

    a, b, g = tp.parse_stats(jtxt, p1)
    assert np.array_equal(a, rc) and g == gob
    assert np.array_equal(b[p1.context_model], rc2)

    p2 = tp.apply_pass2(params_from_config(FFV1Config(**cfg_kw), "yuv420p",
                                           W, H), jtxt)
    j2 = jtp.apply_pass2(jparams(JConfig(**cfg_kw), "yuv420p", W, H), jtxt)
    assert p2.state_transition.dtype == j2.state_transition.dtype
    assert np.array_equal(p2.state_transition, j2.state_transition)
    assert len(p2.initial_states) == len(j2.initial_states)
    for x, y in zip(p2.initial_states, j2.initial_states):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.any(p2.initial_states[p2.context_model] != 128)
    if coder == 2:
        # the sorted table reaches the device coder's packed table
        assert not np.array_equal(p2.state_transition, p1.state_transition)
        assert np.array_equal(host.packed_transition_table(p2),
                              host.packed_transition_table(j2))
        assert not np.array_equal(host.packed_transition_table(p2),
                                  host.packed_transition_table(p1))
    assert np.array_equal(tp.find_best_state(p2.state_transition),
                          jtp.find_best_state(j2.state_transition))


def test_torch_twopass_device_encoder():
    """DeviceFFV1Encoder(params=p2) (the custom initial states at every
    keyframe, the sorted transition table) == NativeFFV1Codec(p2) over key
    and inter frames; the decode reads the port's extradata through the
    JAX headers.read_extradata."""
    cfg_kw = dict(level=3, coder=2, slices=4, slicecrc=1)
    frames = _frames()
    *_, txt = _pass1(cfg_kw, frames)
    mk = lambda: tp.apply_pass2(params_from_config(  # noqa: E731
        FFV1Config(**cfg_kw), "yuv420p", W, H), txt)
    p2 = mk()
    enc = DeviceFFV1Encoder(W, H, "yuv420p", FFV1Config(**cfg_kw),
                            device="cpu", params=p2)
    nat = NativeFFV1Codec(mk())
    bank = enc.banks[0]
    key = bank.canonical_key.numpy()
    assert np.array_equal(key[:bank.rows_per_slice],
                          key[bank.rows_per_slice:2 * bank.rows_per_slice])
    assert np.any(key[:-1] != 128) and np.all(key[-1] == 128)
    pkts = []
    for t, f in enumerate(frames + frames[:1]):
        a = enc.encode(f, force_keyframe=t in (0, 3))
        assert a == nat.encode(f, t in (0, 3)), f"frame {t}"
        pkts.append(a)
    jp = JH.read_extradata(enc.extradata, W, H)
    assert np.array_equal(jp.state_transition, p2.state_transition)
    dec = NativeFFV1Codec(jp)
    for t, f in enumerate(frames + frames[:1]):
        for x, y in zip(dec.decode(pkts[t]), f):
            assert np.array_equal(x, y), f"frame {t}"


def test_torch_twopass_device_encoder_banks():
    """A non-uniform geometry (35x33): every shape bank starts its
    keyframes from the pass-2 initial states."""
    cfg_kw = dict(level=3, coder=1, slices=4)
    p1 = params_from_config(FFV1Config(**cfg_kw), "yuv420p", 35, 33)
    rng = np.random.RandomState(9)
    frames = [[rng.randint(0, 256, s).astype(np.int32) // 8 * 8
               for s in ((33, 35), (17, 18), (17, 18))] for _ in range(2)]
    nat1 = NativeFFV1Codec(p1)
    nat1.enable_stats()
    for t, f in enumerate(frames):
        nat1.encode(f, t == 0)
    txt = tp.stats_to_text(p1, *tp.collect_stats(nat1))
    mk = lambda: tp.apply_pass2(params_from_config(  # noqa: E731
        FFV1Config(**cfg_kw), "yuv420p", 35, 33), txt)
    enc = DeviceFFV1Encoder(35, 33, "yuv420p", FFV1Config(**cfg_kw),
                            device="cpu", params=mk())
    assert len(enc.banks) > 1
    for b in enc.banks:
        assert np.any(b.canonical_key.numpy()[:-1] != 128)
    nat = NativeFFV1Codec(mk())
    for t, f in enumerate(frames):
        assert enc.encode(f, force_keyframe=t == 0) == nat.encode(f, t == 0)


def test_torch_twopass_rice_initial_states_raise():
    """Initial states are a range-coder feature (as in the JAX encoder)."""
    p = params_from_config(FFV1Config(level=3, coder=0, slices=4),
                           "yuv420p", W, H)
    p.initial_states = [np.full((c, 32), 100, np.uint8)
                        for c in p.context_counts]
    with pytest.raises(NotImplementedError, match="range-coder"):
        DeviceFFV1Encoder(W, H, "yuv420p", device="cpu", params=p)
