"""The port's SB-banded FFV2 front (``parallel/ffv2.py``) on a gloo world of
CPU ranks, its one-direction K19 entry, and the ``front_q=`` hook of the
FFV2 sessions, against the JAX package, exactly.

One world of 4 ranks (``spawn_world``, a 60 s deadline) runs every case
with ``device="cpu"`` (K18's and K19's plain versions): the front of a gray
(1, 256, 64) frame banded one SB row a rank over (1, 4), as
``__graft_entry__.dryrun_multichip`` builds it, and two SB rows a rank
over (1, 2) on ranks 0-1 (an interior boundary in each band); a 256x256
yuv444p packet through ``NativeFFV2Encoder.encode(front_q=...)``; and the
refusal of a height that does not split into the bands."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ffmpeg_ffv2_tpu.ffv2 import FFV2Config as JConfig
from ffmpeg_ffv2_tpu.ffv2 import native as jnat
from ffmpeg_ffv2_tpu.ffv2 import tpu as jtpu
from ffmpeg_ffv2_tpu.parallel import ffv2 as jpar
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.ffv2 import FFV2Config, dsp
from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
from ffmpeg_ffv2_tpu_torch.ffv2 import native as tnat
from ffmpeg_ffv2_tpu_torch.parallel.world import run_cases, spawn_world
from test_torch_formats import torch_one_thread  # noqa: F401

QP = 16
BANDS = list(dsp.band_starts(dsp.SB_SIZE))


def _gray():
    """__graft_entry__.py:218-222's frame at 4 devices: (1, 256, 64)."""
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:256, 0:64]
    return (((xx * 2 + yy * 3) % 256) // 8 * 8
            + rng.randint(0, 4, yy.shape)).astype(np.int32)[None] & 0xFF


def _planes(w, h, n=3, seed=9):
    """tests/test_ffv2_shard.py:44-48's content."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return [(((xx * (k + 2) + yy * (k + 3)) % 256) // 4 * 4
             + rng.randint(0, 4, (h, w))).astype(np.int32) & 0xFF
            for k in range(n)]


GRAY = _gray()
PLANES = _planes(256, 256)


@pytest.fixture(scope="module")
def world():
    """Every case on one gloo world of 4 CPU ranks: the results by case
    name (a list over ranks)."""
    front = dict(kind="ffv2", planes=GRAY, depth=8, qp=QP)
    cases = [
        dict(front, name="one row a rank", mesh=(1, 4)),
        dict(front, name="two rows a rank", mesh=(1, 2), group=[0, 1]),
        dict(kind="ffv2", name="packet", mesh=(1, 4), packet=True,
             width=256, height=256, pix_fmt="yuv444p", qp=QP,
             planes=PLANES),
        dict(front, name="uneven bands", mesh=(1, 4), planes=GRAY[:, :192],
             expect="ValueError"),
    ]
    res = spawn_world(run_cases, 4, "gloo", 60, cases, "cpu")
    return {c["name"]: [r[i] for r in res] for i, c in enumerate(cases)}


def _check_ranks(results):
    """Every rank of the case returned the same result, after K18's and
    K19's plain versions (no launch)."""
    r0 = results[0]
    for r in results:
        if r is None:
            continue
        assert r["digest"] == r0["digest"], r["rank"]
        assert r["transport"] == "gloo"
        assert r["plain"]["pvq"] > 0 and r["plain"]["lap_pre"] > 0
        assert not any(r["launches"].values())
    return r0["result"]


def _equal(got, want):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b)


def test_torch_parallel_ffv2_front_matches_jax(world):
    """(1, 256, 64) gray, one SB row a rank on (1, 4): the (dc, pulses,
    igain) of every rank equal JAX encode_front_q_sharded on the virtual
    (4,) mesh and the port's single-device encode_front_q."""
    got = _check_ranks(world["one row a rank"])
    for r in world["one row a rank"]:
        assert list(r["stage_ms"]) == [
            "upload + Q12 + K19 horizontal", "halo exchange",
            "K19 vertical + halo slabs", "transform + zigzag + K18",
            "gather + copy down"]
    mesh = Mesh(np.array(jax.devices()[:4]), ("slice",))
    _equal(got, jpar.encode_front_q_sharded(GRAY, 8, QP, BANDS, mesh))
    _equal(got, dv.encode_front_q(GRAY, 8, QP, BANDS, device="cpu"))


def test_torch_parallel_ffv2_front_interior_boundaries(world):
    """The same frame, two SB rows a rank on (1, 2) over ranks 0 and 1 (so
    each band has an interior boundary beside its halo slab): equal to
    the single-device front."""
    r = world["two rows a rank"]
    assert r[2] is None and r[3] is None
    _equal(_check_ranks(r), dv.encode_front_q(GRAY, 8, QP, BANDS,
                                              device="cpu"))


def test_torch_parallel_ffv2_packet_matches_encode(world):
    """A 256x256 yuv444p qp-16 packet through encode(front_q=the sharded
    front on (1, 4)) equals encode(), encode_host() and the JAX
    NativeFFV2Encoder's encode()."""
    pkt = _check_ranks(world["packet"])
    enc = tnat.NativeFFV2Encoder(256, 256, "yuv444p", FFV2Config(qp=QP),
                                 device="cpu")
    assert pkt == enc.encode(PLANES)
    assert pkt == enc.encode_host(PLANES)
    jenc = jnat.NativeFFV2Encoder(256, 256, "yuv444p", JConfig(qp=QP))
    assert pkt == jenc.encode(PLANES)


def test_torch_parallel_ffv2_rejects_uneven_bands(world):
    """192 rows cannot split into 4 bands of 64-row SB rows: ValueError, as
    the JAX function asserts."""
    assert all("must split into 4 SB-row bands" in r["error"]
               for r in world["uneven bands"])


def test_torch_lap_dir_slab_matches_jax_filter_slab():
    """The one-direction K19 entry on one 32-row boundary slab [P, 32, W]
    (sb = 16, its only boundary at row 16), the halo slab of the sharded
    front: its plain version equals JAX _filter_slab
    (parallel/ffv2.py:42-46), on Q12 content and on hostile int32."""
    rng = np.random.RandomState(3)
    for slab in (rng.randint(-2600, 2600, (3, 32, 96)),
                 rng.randint(-2 ** 31, 2 ** 31, (2, 32, 64), dtype=np.int64)):
        slab = slab.astype(np.int32)
        _build.reset_counts()
        got = dv.lap_dir(torch.tensor(slab), 16, True, True)
        assert _build.KERNELS["lap_pre"].plain_calls == 1
        want = np.asarray(jpar._filter_slab(jnp.asarray(slab)))
        assert np.array_equal(got.numpy(), want)


def test_torch_lap_dir_directions_and_guard():
    """lap_frame is lap_dir's two directions in order (pre: horizontal
    then vertical; post: the reverse); two boundaries closer than 32
    raise, as does a slab that leaves the extent."""
    rng = np.random.RandomState(4)
    c = rng.randint(-2600, 2600, (2, 128, 192)).astype(np.int32)
    for forward, order in ((True, (False, True)), (False, (True, False))):
        want = dv.lap_frame(torch.tensor(c), 64, forward)
        got = torch.tensor(c)
        for vertical in order:
            dv.lap_dir(got, 64, forward, vertical)
        assert torch.equal(got, want)
        assert not torch.equal(got, torch.tensor(c))
    with pytest.raises(ValueError, match="overlap"):
        dv.lap_dir(torch.zeros((1, 64, 8), dtype=torch.int32), 16, True,
                   True)
    with pytest.raises(ValueError, match="leaves the extent"):
        dv.lap_dir(torch.zeros((1, 40, 8), dtype=torch.int32), 32, True,
                   True)


def _recorder(calls, front):
    def hook(padded, depth, qp, bands):
        calls.append((np.array(padded), depth, qp, bands))
        return front(padded, depth, qp, bands)
    return hook


def _same_calls(got, want):
    assert len(got) == len(want)
    for (p, d, q, b), (jp, jd, jq, jb) in zip(got, want):
        assert p.dtype == jp.dtype and np.array_equal(p, jp)
        assert (type(d), d, type(q), q) == (type(jd), jd, type(jq), jq)
        assert type(b) is type(jb) and b == jb


def test_torch_ffv2_encode_front_q_hook():
    """encode(planes, front_q=device.encode_front_q) equals encode(planes),
    and a recording hook sees the JAX session's argument list: the padded
    planes, depth, qp and band starts of JAX NativeFFV2Encoder.encode's
    call (ffv2/native.py:153-156,226)."""
    planes = _planes(130, 66, seed=2)
    enc = tnat.NativeFFV2Encoder(130, 66, "yuv444p", FFV2Config(qp=QP),
                                 device="cpu")
    port_front = partial(dv.encode_front_q, device="cpu")
    assert enc.encode(planes, front_q=port_front) == enc.encode(planes)
    calls, jcalls = [], []
    pkt = enc.encode(planes, front_q=_recorder(calls, port_front))
    jenc = jnat.NativeFFV2Encoder(130, 66, "yuv444p", JConfig(qp=QP))
    jpkt = jenc.encode(planes, front_q=_recorder(jcalls, jtpu.encode_front_q))
    assert pkt == jpkt
    _same_calls(calls, jcalls)


def test_torch_ffv2_encode_stream_front_q_hook():
    """PipelinedFFV2Encoder.encode_stream(frames, front_q=...) equals
    encode_stream(frames), with JAX's argument list a frame."""
    frames = [_planes(96, 64, seed=s) for s in (1, 2)]
    port_front = partial(dv.encode_front_q, device="cpu")
    pipe = tnat.PipelinedFFV2Encoder(96, 64, "yuv444p", FFV2Config(qp=QP),
                                     device="cpu")
    jpipe = jnat.PipelinedFFV2Encoder(96, 64, "yuv444p", JConfig(qp=QP))
    try:
        calls, jcalls = [], []
        got = pipe.encode_stream(frames,
                                 front_q=_recorder(calls, port_front))
        assert got == pipe.encode_stream(frames)
        want = jpipe.encode_stream(
            frames, front_q=_recorder(jcalls, jtpu.encode_front_q))
        assert got == want
        _same_calls(calls, jcalls)
    finally:
        pipe.close()
        jpipe.close()
