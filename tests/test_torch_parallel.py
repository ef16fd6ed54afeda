"""The port's multi-device FFV1 encoder (``ffmpeg_ffv2_tpu_torch.parallel``)
on a gloo world of CPU ranks, against the JAX package, exactly.

One world of 4 ranks (``spawn_world``, a 60 s deadline) runs every case,
with ``device="cpu"`` (the kernels' plain versions): ParallelFFV1Encoder on
a (2, 2) mesh (yuv420p range and Golomb-Rice, key then inter frames, two
lanes), on (1, 4) (bgr0 range and rice), on (1, 2) over ranks 0-1 (a
non-uniform geometry in two shape banks), continuing from the JAX
ParallelFFV1Encoder's carried state, and its refusal of a slice count the
mesh does not divide; gather_slice_bytes on uneven lengths; and
phase_a_sharded.  Each packet is held against the JAX host FFV1Encoder,
the single-device port and (Golomb-Rice) the JAX ParallelFFV1Encoder on
the virtual (2, 2) CPU mesh (tests/conftest.py)."""

import time

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from ffmpeg_ffv2_tpu.ffv1.decoder import FFV1Decoder
from ffmpeg_ffv2_tpu.ffv1.encoder import FFV1Encoder
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config as JConfig
from ffmpeg_ffv2_tpu.parallel import slices as jslices
from ffmpeg_ffv2_tpu.parallel.ffv1 import ParallelFFV1Encoder as JParallel
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu_torch.ffv1.phase_a import lut_for
from ffmpeg_ffv2_tpu_torch.parallel.world import (run_cases, spawn_world,
                                                  stall)
from test_torch_formats import torch_one_thread  # noqa: F401

W, H = 64, 32
BW, BH = 36, 33                 # tests/test_parallel_ffv1.py:86-111
KEYS = [True, False]


def _frames(w, h, n, seed, rgb=False):
    """tests/test_parallel_ffv1.py's content."""
    rng = np.random.RandomState(seed)

    def plane(ph, pw, k, t):
        yy, xx = np.mgrid[0:ph, 0:pw]
        base = ((xx * (2 + k) + yy * (3 + k) + 5 * t) % 256) // 8 * 8
        return (base + rng.randint(0, 4, (ph, pw))).astype(np.int32) & 0xFF

    if rgb:
        return [[plane(h, w, k, t) for k in range(3)] for t in range(n)]
    return [[plane(h, w, 0, t), plane(h // 2, w // 2, 1, t),
             plane(h // 2, w // 2, 2, t)] for t in range(n)]


def _banked_frames():
    rng = np.random.RandomState(2)

    def frame(t):
        def plane(ph, pw, k):
            yy, xx = np.mgrid[0:ph, 0:pw]
            base = ((xx * (2 + k) + yy * (3 + k) + 5 * t) % 256) // 8 * 8
            return (base + rng.randint(0, 4, (ph, pw))).astype(np.int32)
        return [plane(BH, BW, 0), plane((BH + 1) // 2, (BW + 1) // 2, 1),
                plane((BH + 1) // 2, (BW + 1) // 2, 2)]
    return [frame(0), frame(1)]


def _cfg(coder, **kw):
    return dict(level=3, coder=coder, slices=16, slicecrc=1, **kw)


LANES = [_frames(W, H, 2, seed) for seed in (7, 11)]
RGB = _frames(W, H, 1, 3, rgb=True)[0]
BANKED = _banked_frames()
GATHER_LENS = [[5, 0, 17], [1, 40, 3], [9, 9, 9], [0, 0, 2]]
CROPS = np.random.RandomState(4).randint(-300, 300, (2, 8, 6, 10)).astype(
    np.int32)
QT = lut_for(params_from_config(FFV1Config(level=3), "gray", 16, 16), 0)


def _jax_mesh(data, ns):
    devs = jax.devices()
    return Mesh(np.array(devs[:data * ns]).reshape(data, ns),
                ("data", "slice"))


@pytest.fixture(scope="module")
def jax_rice():
    """The JAX ParallelFFV1Encoder, Golomb-Rice on the virtual (2, 2) mesh:
    its packets of both steps and its units' _state after the key
    frame."""
    par = JParallel(W, H, "yuv420p", JConfig(**_cfg(0, gop_size=2)),
                    _jax_mesh(2, 2), use_pallas=False)
    pkts, state = [], None
    for t, kf in enumerate(KEYS):
        pkts.append(par.encode_batch([lane[t] for lane in LANES],
                                     force_keyframe=kf))
        if t == 0:
            state = [np.asarray(u._state) for u in par.units]
    return pkts, state


@pytest.fixture(scope="module")
def world(jax_rice):
    """Every case on one gloo world of 4 CPU ranks; returns (seconds, the
    results by case name: a list over ranks)."""
    _, jstate = jax_rice
    lane_case = dict(kind="ffv1", mesh=(2, 2), width=W, height=H,
                     pix_fmt="yuv420p", lanes=LANES, keyframes=KEYS)
    cases = [
        dict(lane_case, name="range", cfg=FFV1Config(**_cfg(1, gop_size=2))),
        dict(lane_case, name="rice", cfg=FFV1Config(**_cfg(0, gop_size=2)),
             state_after=0),
        dict(lane_case, name="rice from jax state",
             cfg=FFV1Config(**_cfg(0, gop_size=2)),
             lanes=[[lane[1]] for lane in LANES], keyframes=[False],
             load_state=(jstate, 1), state_after=0),
        dict(kind="ffv1", name="bgr0 range", mesh=(1, 4), width=W, height=H,
             pix_fmt="bgr0", cfg=FFV1Config(**_cfg(1)), lanes=[[RGB]],
             keyframes=[True]),
        dict(kind="ffv1", name="bgr0 rice", mesh=(1, 4), width=W, height=H,
             pix_fmt="bgr0", cfg=FFV1Config(**_cfg(0)), lanes=[[RGB]],
             keyframes=[True]),
        dict(kind="ffv1", name="bgr0 range K6", mesh=(1, 4), width=W,
             height=H, pix_fmt="bgr0", cfg=FFV1Config(**_cfg(1)),
             lanes=[[RGB]], keyframes=[True], emission_order=True),
        dict(kind="ffv1", name="banked", mesh=(1, 2), group=[0, 1],
             width=BW, height=BH, pix_fmt="yuv420p",
             cfg=FFV1Config(level=3, coder=1, slices=4, slicecrc=1),
             lanes=[BANKED], keyframes=KEYS),
        dict(kind="ffv1", name="not divisible", mesh=(1, 4), width=W,
             height=H, pix_fmt="yuv420p",
             cfg=FFV1Config(level=3, coder=1, slices=6), lanes=[[]],
             expect="ValueError"),
        dict(kind="gather", name="gather", mesh=(1, 4), lens=GATHER_LENS,
             cap=48),
        dict(kind="phase_a", name="phase_a", mesh=(2, 2), crops=CROPS,
             qt=QT, bits=8, five=False, data_axis=True),
    ]
    t0 = time.perf_counter()
    res = spawn_world(run_cases, 4, "gloo", 60, cases, "cpu")
    return time.perf_counter() - t0, {
        c["name"]: [r[i] for r in res] for i, c in enumerate(cases)}


def _check_ranks(results, n_steps, n_lanes):
    """Every rank of the case returned every lane's packets (the same
    digests as rank 0's packets) with the plain versions only."""
    r0 = results[0]
    assert len(r0["packets"]) == n_steps
    assert all(len(step) == n_lanes for step in r0["packets"])
    for r in results:
        if r is None:
            continue
        assert r["digests"] == r0["digests"], r["rank"]
        assert r["transport"] == "gloo"
        assert all(r["plain"][k] > 0 for k in r["kernels"]), r["plain"]
        assert not any(r["launches"].values()), r["launches"]
    return r0["packets"]


@pytest.mark.parametrize("coder", [1, 0])
def test_torch_parallel_matches_host_and_carries_state(world, coder):
    """(2, 2) mesh, 16 slices, key then inter frame on two lanes: every
    lane's packets equal the JAX host FFV1Encoder's and the single-device
    port's, and decode back."""
    _, res = world
    pkts = _check_ranks(res["range" if coder else "rice"], 2, 2)
    cfg = _cfg(coder, gop_size=2)
    for b, frames in enumerate(LANES):
        host = FFV1Encoder(W, H, "yuv420p", JConfig(**cfg))
        port = DeviceFFV1Encoder(W, H, "yuv420p", FFV1Config(**cfg),
                                 device="cpu")
        for t, kf in enumerate(KEYS):
            want = host.encode(frames[t], kf)
            assert pkts[t][b] == want, (coder, b, t)
            assert port.encode(frames[t], force_keyframe=kf) == want
    dec = FFV1Decoder(W, H, port.extradata)
    for t in range(2):
        for a, b in zip(dec.decode(pkts[t][0]), LANES[0][t]):
            assert np.array_equal(np.asarray(a), b)


def test_torch_parallel_rice_matches_jax_mesh(world, jax_rice):
    """Golomb-Rice on (2, 2): the packets equal JAX ParallelFFV1Encoder's
    on the virtual (2, 2) mesh, and state() after the key frame equals the
    JAX units' _state in its layout."""
    _, res = world
    jpkts, jstate = jax_rice
    pkts = _check_ranks(res["rice"], 2, 2)
    assert pkts == jpkts
    state = res["rice"][0]["state"]
    assert [s.shape for s in state] == [s.shape for s in jstate]
    for a, b in zip(state, jstate):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_torch_parallel_load_state_from_jax(world, jax_rice):
    """load_state of the JAX units' _state after a JAX key frame, then an
    inter frame: equal to JAX's inter packets; state() gives the loaded
    layout back after the frame."""
    _, res = world
    jpkts, jstate = jax_rice
    r = res["rice from jax state"]
    assert _check_ranks(r, 1, 2)[0] == jpkts[1]
    assert [s.shape for s in r[0]["state"]] == [s.shape for s in jstate]


@pytest.mark.parametrize("name,coder", [("bgr0 range", 1), ("bgr0 rice", 0),
                                        ("bgr0 range K6", 1)])
def test_torch_parallel_rgb(world, name, coder):
    """bgr0 on a (1, 4) mesh, 16 slices: equal to the JAX host encoder
    (tests/test_parallel_ffv1.py's range and rice cases), and with
    emission_order=True (K6 in place of K2 and emission_pack)."""
    _, res = world
    pkt = _check_ranks(res[name], 1, 1)[0][0]
    assert ("adapt_emission" in res[name][0]["kernels"]) == \
        name.endswith("K6")
    cfg = _cfg(coder)
    assert pkt == FFV1Encoder(W, H, "bgr0", JConfig(**cfg)).encode(RGB, True)
    port = DeviceFFV1Encoder(W, H, "bgr0", FFV1Config(**cfg), device="cpu")
    assert pkt == port.encode(RGB, force_keyframe=True)


def test_torch_parallel_banked_nonuniform(world):
    """36x33 in 4 slices on a (1, 2) mesh over ranks 0 and 1 (ranks 2 and 3
    stay out): two shape banks, each split over the slice axis; equal to
    the JAX host encoder."""
    _, res = world
    r = res["banked"]
    assert r[2] is None and r[3] is None
    assert r[0]["units"] == 2
    pkts = _check_ranks(r, 2, 1)
    cfg = JConfig(level=3, coder=1, slices=4, slicecrc=1)
    enc = FFV1Encoder(BW, BH, "yuv420p", cfg)
    for t, kf in enumerate(KEYS):
        assert pkts[t][0] == enc.encode(BANKED[t], kf), t


def test_torch_parallel_rejects_bad_mesh(world):
    """6 slices over a slice axis of 4: ValueError naming "divisible", as
    the JAX encoder raises."""
    _, res = world
    assert all("divisible" in r["error"] for r in res["not divisible"])


def test_torch_parallel_gather_uneven_lengths(world):
    """gather_slice_bytes on the slice axis, lengths 0..40 in buffers of 48:
    the lengths, then each row's bytes up to the largest length (zeros
    past a row's own), in rank order, on every rank, as host tensors."""
    _, res = world
    L = max(max(x) for x in GATHER_LENS)
    for r in res["gather"]:
        assert r["device"] == "cpu"
        assert r["ln"].tolist() == sum(GATHER_LENS, [])
        assert r["by"].shape == (12, L) and r["by"].dtype == np.uint8
        for s, lens in enumerate(GATHER_LENS):
            for row, n in enumerate(lens):
                want = np.zeros(L, np.uint8)
                want[:n] = (37 * s + 11 * row + np.arange(n)) % 256
                assert np.array_equal(r["by"][3 * s + row], want)


def test_torch_parallel_phase_a_sharded(world):
    """phase_a_sharded on [2, 8, 6, 10] crops over (2, 2) with the data
    axis: equal to the JAX phase_a_sharded on the virtual mesh."""
    _, res = world
    jctx, jdiff = jslices.phase_a_sharded(CROPS, QT, 8, False,
                                          _jax_mesh(2, 2), data_axis=True)
    for r in res["phase_a"]:
        assert np.array_equal(r["ctx"], np.asarray(jctx))
        assert np.array_equal(r["diff"], np.asarray(jdiff))


def test_torch_parallel_world_within_deadline(world):
    """The world ran its cases inside the fixture's 60 s deadline; a world
    whose rank 0 waits in a barrier that rank 1 never enters fails within
    its deadline and leaves no rank running."""
    seconds, _ = world
    assert seconds < 60
    t0 = time.perf_counter()
    with pytest.raises((RuntimeError, TimeoutError)):
        spawn_world(stall, 2, "gloo", 5, 60)
    assert time.perf_counter() - t0 < 30
