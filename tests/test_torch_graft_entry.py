"""The port's twin of ``__graft_entry__.py``
(``ffmpeg_ffv2_tpu_torch.graft_entry``) against the JAX package, exactly.

``entry(device="cpu")``'s step on seeded int32 planes of its example's
shape equals the JAX ``entry()`` step's (ctx, diff), jitted on the CPU.
``dryrun_multichip(4, device="cpu")`` runs once, as a gloo world of 4 CPU
ranks with a 120 s deadline (the kernels' plain versions): every FFV1
config's packets equal the JAX host ``FFV1Encoder``'s on the same lanes
(the oracle of the JAX ``_run_config``), and the sharded FFV2 front equals
the JAX ``ffv2.tpu.encode_front_q``."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from ffmpeg_ffv2_tpu.ffv1.encoder import FFV1Encoder
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu.ffv2 import dsp as jdsp
from ffmpeg_ffv2_tpu.ffv2.tpu import encode_front_q
from ffmpeg_ffv2_tpu_torch import graft_entry as ge
from test_torch_formats import torch_one_thread  # noqa: F401

RANKS = 4
CONFIGS = ge.dryrun_configs(RANKS)


@pytest.fixture(scope="module")
def jax_step():
    fn, example = jentry.entry()
    return jax.jit(fn), example


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_torch_graft_entry_step(jax_step, seed):
    """The step on the example (zeros) and on seeded planes spanning more
    than 16 bits (the int16 wrap) equals JAX's, as int32."""
    jfn, (jex,) = jax_step
    fn, (ex,) = ge.entry(device="cpu")
    assert ex.shape == jex.shape and ex.dtype == torch.int32
    assert ex.device.type == "cpu"
    x = (np.zeros(jex.shape, np.int32) if seed is None else
         np.random.RandomState(seed).randint(-70000, 70000, jex.shape)
         .astype(np.int32))
    got = fn(torch.from_numpy(x))
    want = jfn(x)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def dryrun():
    return ge.dryrun_multichip(RANKS, device="cpu", timeout_s=120)


def test_torch_graft_entry_matrix(dryrun):
    """The JAX dry run's matrix on 4 devices without its pallas config:
    range and Golomb-Rice, yuv420p and bgr0 on a (2, 2) mesh, key + inter,
    the 36x33 two-bank case, the 4-lane 96x64 rice case, the FFV2 front
    over 4 ranks."""
    assert list(dryrun) == [c["name"] for c in CONFIGS] + [
        "ffv2/gray/64x256/slice4"]
    assert [c["mesh"] for c in CONFIGS] == [(2, 2)] * 4 + [(4, 1)]
    assert [(c["pix"], c["coder"], c["wh"], c["inter"]) for c in CONFIGS] \
        == [("yuv420p", 1, (64, 32), True), ("yuv420p", 0, (64, 32), False),
            ("bgr0", 1, (64, 32), False), ("yuv420p", 1, (36, 33), False),
            ("yuv420p", 0, (96, 64), False)]
    for rec in dryrun.values():
        assert len(rec["launches"]) == RANKS
        assert not any(n for r in rec["launches"] for n in r.values())


@pytest.mark.parametrize("i", range(len(CONFIGS)),
                         ids=[c["name"] for c in CONFIGS])
def test_torch_graft_entry_dryrun_ffv1(dryrun, i):
    """Every lane's packets equal the JAX host FFV1Encoder's on the same
    frames; every rank ran the path's plain versions."""
    c = CONFIGS[i]
    rec = dryrun[c["name"]]
    lanes = ge.dryrun_lanes(c["pix"], c["coder"], c["wh"], c["mesh"][0],
                            c["inter"])
    cfg = FFV1Config(level=3, coder=c["coder"], slices=c["n_slices"],
                     slicecrc=1)
    assert len(rec["packets"]) == c["mesh"][0]
    for b, frames in enumerate(lanes):
        enc = FFV1Encoder(*c["wh"], c["pix"], cfg)
        assert rec["packets"][b] == [enc.encode(f, t == 0)
                                     for t, f in enumerate(frames)], b
    path = ["place", "vlc", "ladder"] if c["coder"] == 0 else [
        "place", "adapt", "emission_pack", "expand", "rac_render"]
    for plain in rec["plain_calls"]:
        assert all(plain[k] > 0 for k in path), plain


def test_torch_graft_entry_dryrun_ffv2(dryrun):
    """The SB-banded front over 4 ranks equals the JAX single-device
    encode_front_q."""
    rec = dryrun["ffv2/gray/64x256/slice4"]
    pl2 = ge.dryrun_ffv2_plane(RANKS)
    want = encode_front_q(pl2, 8, 16, list(jdsp.band_starts(jdsp.SB_SIZE)))
    for g, w in zip(rec["front"], want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    for plain in rec["plain_calls"]:
        assert plain["pvq"] > 0 and plain["lap_pre"] > 0, plain
