"""The ladder kernels' algorithm (``rice.run_index_scan_chunked_plain``:
chunk maps of the 41 states, the carries, the replay, every step the
kernels' one-lookup climb) against the JAX package's ``run_index_scan``
(a ``lax.scan``) and the port's per-event loop ``run_index_scan_plain``,
on the CPU.  Inputs are seeded numpy; every comparison is exact on each
lane's first n_ev slots (the slots past them are unspecified)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffmpeg_ffv2_tpu.ffv1 import device_rice as jdr
from ffmpeg_ffv2_tpu_torch.ffv1 import rice
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.params import (CODER_GOLOMB, FFV1Config,
                                               params_from_config)
from test_torch_formats import torch_one_thread  # noqa: F401


def _random(rng, L, E, cmax):
    cnt = rng.integers(0, cmax, size=(L, E)).astype(np.int32)
    fl = rng.random((L, E)) < 0.2
    va = rng.random((L, E)) < 0.9
    rs = (rng.random((L, E)) < 0.05) & va
    return cnt, fl, va, rs


def _boundaries():
    """Resets, flushes and invalid events on the chunk boundaries of every
    chunk size tested (multiples of 7 and of 128, and their neighbours),
    one lane with none of its events counted, one ending mid-chunk."""
    rng = np.random.default_rng(11)
    L, E = 4, 300
    cnt, fl, va, rs = _random(rng, L, E, 2000)
    for b in (127, 128, 129, 255, 256, 257):
        va[1, b] = False
        rs[2, b] = True
        va[2, b] = True
        fl[3, b] = True
        va[3, b] = True
    for b in range(6, E, 7):
        rs[0, b] = va[0, b] = True
        fl[1, b + 1 if b + 1 < E else b] = True
        va[2, b - 1] = False
    return cnt, fl, va, rs, np.array([E, 0, 129, 200], np.int32)


def _ragged():
    """E a prime (no chunk size divides it) and counts of every size a
    frame gives."""
    rng = np.random.default_rng(12)
    L, E = 5, 211
    cnt, fl, va, rs = _random(rng, L, E, 700)
    return cnt, fl, va, rs, np.array([211, 210, 1, 128, 7], np.int32)


def _climb40():
    """Counts that climb from 0 to the cap (P[40] = 16777500 and more),
    from mid-ladder indices and across the table's edge (P[24] = 540)."""
    rng = np.random.default_rng(13)
    L, E = 3, 150
    cnt, fl, va, rs = _random(rng, L, E, 600)
    cnt[0, ::5] = rice.LADDER_P[40] + rng.integers(0, 1 << 20,
                                                   len(cnt[0, ::5]))
    cnt[1, ::3] = rng.integers(530, 550, len(cnt[1, ::3]))
    cnt[2, ::4] = (1 << 30) + rng.integers(0, 1 << 20, len(cnt[2, ::4]))
    fl[0, ::5] = True                        # keep the climbed index
    return cnt, fl, va, rs, np.array([E, E, 149], np.int32)


def _rice16_frame():
    """The compacted ladder events of a 96x64 yuv420p16 frame (params
    forced to Golomb-Rice; a flat field in steps of 16 columns with 8% of
    the samples spikes, so it runs), from the port's own phase A, run
    planning and ``compact_events``."""
    w, h = 96, 64
    cfg = FFV1Config(level=3, slices=4)
    p = dataclasses.replace(params_from_config(cfg, "yuv420p16", w, h),
                            ac=CODER_GOLOMB)
    enc = DeviceFFV1Encoder(w, h, "yuv420p16", cfg, device="cpu",
                            params=p).banks[0]
    rng = np.random.RandomState(5)
    planes = []
    for sh in [(h, w), (h // 2, w // 2), (h // 2, w // 2)]:
        x = 40000 + np.zeros(sh, np.int64) + np.arange(sh[1]) // 16
        x += (rng.random_sample(sh) < 0.08) * rng.randint(1, 3000, sh)
        planes.append(torch.as_tensor(x.astype(np.int32)))
    _, streams = enc.phase_a_rice(planes)
    ev_cap = int(streams["lad"].sum(dim=1).max()) + 3
    ev = rice.compact_events(streams, ev_cap)
    assert int(ev["n_lad"].min()) > 128      # more than one chunk a lane
    return (ev["count"].numpy(), ev["flush"].numpy(), ev["valid"].numpy(),
            ev["reset"].numpy(), ev["n_lad"].numpy())


CASES = {"boundaries": _boundaries, "ragged": _ragged, "climb40": _climb40,
         "rice16_frame": _rice16_frame}


@pytest.mark.parametrize("chunk", [1, 7, 128, "E"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_ladder_chunked_plain_matches_jax(case, chunk):
    """The chunked algorithm == JAX ``run_index_scan`` (its valid and reset
    flags cleared past each lane's n_ev) == ``run_index_scan_plain``."""
    cnt, fl, va, rs, n_ev = CASES[case]()
    L, E = cnt.shape
    live = np.arange(E)[None, :] < n_ev[:, None]
    C = E if chunk == "E" else chunk
    args = [torch.as_tensor(np.ascontiguousarray(a))
            for a in (cnt, fl, va, rs, n_ev)]
    got = rice.run_index_scan_chunked_plain(*args, chunk=C).numpy()
    ref = np.asarray(jdr.run_index_scan(jnp.asarray(cnt), jnp.asarray(fl),
                                        jnp.asarray(va & live),
                                        jnp.asarray(rs & live)))
    loop = rice.run_index_scan_plain(*args).numpy()
    assert np.array_equal(got[live], ref[live])
    assert np.array_equal(got[live], loop[live])
    if case == "climb40":
        assert (ref[live] == 40).any()


def test_torch_ladder_climb_table_matches_ladder_step():
    """The kernels' climb (a table entry below P[24], the closed form past
    it) == JAX ``ladder_step`` for every start index and counts around
    every P[j]."""
    P = rice.LADDER_P.astype(np.int64)
    c = np.unique(np.clip(np.concatenate(
        [P - 1, P, P + 1, np.arange(0, 1200), [1 << 26, (1 << 26) - 1]]),
        0, 1 << 26)).astype(np.int32)
    i = np.repeat(np.arange(41, dtype=np.int32), len(c))
    cc = np.tile(c, 41)
    pi = torch.as_tensor(P[i].astype(np.int32))
    for flush in (0, 1):
        fl = torch.full((len(i),), 2 | flush, dtype=torch.int32)
        ni, npi = rice.ladder_climb(torch.as_tensor(cc), fl,
                                    torch.as_tensor(i), pi)
        j = np.asarray(jdr.ladder_step(jnp.asarray(i), jnp.asarray(cc))[0])
        want = j if flush else np.maximum(j - 1, 0)
        assert np.array_equal(ni.numpy(), want)
        assert np.array_equal(npi.numpy(), P[want])
