"""The port's FFV2 device front and back (``ffmpeg_ffv2_tpu_torch/ffv2/
device.py``) on the CPU against the JAX module ``ffmpeg_ffv2_tpu/ffv2/
tpu.py``, exactly (equal integers): the float64 transforms, the plain
versions of K19 (the lapped filters) and K18 (PVQ pulses and split sums),
and the frame functions, on seeded numpy inputs, valid and hostile.  It
also records where the numpy reference ``dsp`` differs from JAX: the
transforms' rounding add, which JAX makes in int32."""

import os
import re

import numpy as np
import pytest
import torch

from ffmpeg_ffv2_tpu.ffv2 import dsp as jdsp
from ffmpeg_ffv2_tpu.ffv2 import tpu as jtpu
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
from ffmpeg_ffv2_tpu_torch.ffv2 import dsp
from test_torch_formats import torch_one_thread  # noqa: F401

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _hostile(shape, seed=0):
    """Seeded int32 over the whole range."""
    rng = np.random.RandomState(seed)
    return rng.randint(I32_MIN, I32_MAX + 1, shape, dtype=np.int64).astype(
        np.int32)


def _valid_blocks(n, count, seed):
    """Q12 content: what the prefilter leaves of 8..12-bit pixels."""
    rng = np.random.RandomState(seed)
    return rng.randint(-2600, 2600, (count, n, n)).astype(np.int32)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("kind", ["valid", "hostile"])
def test_torch_ffv2_tx_batch_matches_jax(n, kind):
    if kind == "valid":
        blocks = _valid_blocks(n, 64, n)
        coeffs = jtpu.fwd_tx_batch(blocks)
    else:
        blocks = _hostile((256, n, n), seed=n)
        coeffs = _hostile((256, n, n), seed=n + 1)
    assert np.array_equal(dv.fwd_tx_batch(blocks, device="cpu"),
                          jtpu.fwd_tx_batch(blocks))
    assert np.array_equal(dv.inv_tx_batch(coeffs, device="cpu"),
                          jtpu.inv_tx_batch(coeffs))
    if kind == "valid":
        assert np.array_equal(dv.fwd_tx_batch(blocks, device="cpu"), np.stack(
            [dsp.fwd_tx_2d(b) for b in blocks]))


def _np_tx_round_wrapped(block, inverse):
    """``dsp.fwd_tx_2d`` / ``inv_tx_2d`` with the rounding add wrapped to
    int32 as well, as JAX's int32 add does."""
    n = block.shape[0]
    m = jdsp._basis(n, jdsp.TX_DCT).astype(np.int64)
    r, b = jdsp._ROUND, jdsp._FRAC_BITS
    w = jdsp._wrap32
    x = block.astype(np.int64)
    if not inverse:
        rows = w(w(x @ m.T) + r) >> b
        return (w(w(m @ rows) + r) >> b).astype(np.int32)
    cols = w(w(m.T @ x) + r) >> b
    return (w(w(cols @ m) + r) >> b).astype(np.int32)


def test_torch_ffv2_numpy_reference_rounding_add_finding():
    """The finding: on hostile int32 64x64 blocks (RandomState(0), 6 x 256)
    the numpy reference ``dsp`` differs from JAX ``_tx_batch``, because it
    adds ``_ROUND`` in int64 after its wrap where JAX adds in int32; with
    that add wrapped too, the two agree on every output, and the port
    follows JAX."""
    rng = np.random.RandomState(0)
    fwd_diff = inv_diff = 0
    first = None
    for _ in range(6):
        blocks = rng.randint(I32_MIN, I32_MAX + 1, (256, 64, 64),
                             dtype=np.int64).astype(np.int32)
        for inverse, fn in ((False, jtpu.fwd_tx_batch),
                            (True, jtpu.inv_tx_batch)):
            jx = fn(blocks)
            ref = np.stack([(jdsp.inv_tx_2d if inverse else jdsp.fwd_tx_2d)(b)
                            for b in blocks])
            d = int((ref != jx).sum())
            if inverse:
                inv_diff += d
            else:
                fwd_diff += d
            if d and first is None:
                first = (inverse, np.argwhere(ref != jx)[0].tolist())
            wrapped = np.stack([_np_tx_round_wrapped(b, inverse)
                                for b in blocks])
            assert np.array_equal(wrapped, jx)
            port = (dv.inv_tx_batch if inverse else dv.fwd_tx_batch)(
                blocks, device="cpu")
            assert np.array_equal(port, jx)
    assert (fwd_diff, inv_diff) == (128, 196), (fwd_diff, inv_diff, first)


def _slabs(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "valid":
        return rng.randint(-4096, 4096, (512, 32)).astype(np.int32)
    x = _hostile((512, 32), seed)
    x[0] = I32_MIN
    x[1] = I32_MAX
    x[2, ::2], x[2, 1::2] = I32_MIN, I32_MAX
    x[3, :16], x[3, 16:] = I32_MAX, I32_MIN
    x[4] = rng.choice([I32_MIN, I32_MAX, 0, -1, 1], 32)
    x[5, 16:] = I32_MIN                       # the postfilter's c_div input
    return x


@pytest.mark.parametrize("kind", ["valid", "hostile"])
@pytest.mark.parametrize("forward", [True, False])
def test_torch_ffv2_lap_plain_matches_jax(kind, forward):
    x = _slabs(kind, 3 + forward)
    jfn = jtpu._jx_lap_prefilter if forward else jtpu._jx_lap_postfilter
    ref = np.asarray(jfn(jtpu.jnp.asarray(x), 32))
    got = dv.lap_slab_plain(torch.from_numpy(x), forward).numpy()
    assert np.array_equal(got, ref)
    if kind == "valid":                       # and the numpy reference
        npfn = jdsp.lap_prefilter if forward else jdsp.lap_postfilter
        assert np.array_equal(got, npfn(x, 32))


def test_torch_ffv2_lap_kernel_params_match_dsp():
    """``csrc/ffv2_lap.cu``'s LAP32 table is dsp.LAP_PARAMS[32]."""
    with open(os.path.join(_build.CSRC, "ffv2_lap.cu")) as f:
        body = re.search(r"LAP32\[46\] = \{([^}]*)\}", f.read()).group(1)
    assert [int(v) for v in body.split(",")] == list(dsp.LAP_PARAMS[32])


FRAMES = [((66, 130), 3, 8), ((96, 128), 1, 10), ((66, 130), 1, 12),
          ((96, 128), 3, 12)]


def _padded(hw, P, depth, seed):
    h, w = hw
    rng = np.random.RandomState(seed)
    ph, pw = -(-h // 64) * 64, -(-w // 64) * 64
    yy, xx = np.mgrid[0:ph, 0:pw]
    mx = (1 << depth) - 1
    out = []
    for p in range(P):
        ramp = (xx * (p + 3) + yy * 5) * (mx + 1) // (3 * pw + 5 * ph)
        out.append(np.clip(ramp + rng.randint(-60, 60, (ph, pw)), 0, mx))
    return np.stack(out).astype(np.int32)


@pytest.mark.parametrize("hw,P,depth", FRAMES)
def test_torch_ffv2_frame_functions_match_jax(hw, P, depth):
    """prefilter_frame, encode_front and decode_back (K19's plain
    versions inside) against JAX, on a ramp plus noise."""
    x = _padded(hw, P, depth, depth + P)
    ph, pw = x.shape[1:]
    assert np.array_equal(dv.prefilter_frame(x, depth, device="cpu"),
                          jtpu.prefilter_frame(x, depth))
    streams = jtpu.encode_front(x, depth)
    assert np.array_equal(dv.encode_front(x, depth, device="cpu"), streams)
    assert np.array_equal(
        dv.decode_back(streams, depth, P, ph // 64, pw // 64, device="cpu"),
        jtpu.decode_back(streams, depth, P, ph // 64, pw // 64))


@pytest.mark.parametrize("hw,P,depth,qp", [((66, 130), 3, 8, 16),
                                           ((96, 128), 1, 12, 31)])
def test_torch_ffv2_encode_front_q_matches_jax(hw, P, depth, qp):
    """The fused front (upload at the source depth, K18's plain version,
    the packed copy down) against JAX encode_front_q."""
    x = _padded(hw, P, depth, qp)
    bands = dsp.band_starts(64)
    got = dv.encode_front_q(x, depth, qp, bands, device="cpu")
    ref = jtpu.encode_front_q(x, depth, qp, bands)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["frame", "hostile"])
def test_torch_ffv2_quantize_streams_matches_jax(kind):
    """K18's plain version through quantize_streams: on a frame's streams,
    and on hostile int32 streams (INT_MIN magnitudes, wrapped sums)."""
    if kind == "frame":
        streams = jtpu.encode_front(_padded((66, 130), 3, 8, 1), 8)
    else:
        streams = _hostile((6, 4096), seed=5)
        streams[0, 1:40] = I32_MIN
        streams[1, 1:] = 0
    bands = dsp.band_starts(64)
    got = dv.quantize_streams(streams, 8, bands, 64, device="cpu")
    ref = jtpu.quantize_streams(streams, 8, bands, 64)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def _band_cases(L, seed):
    rng = np.random.RandomState(seed)
    rows = [np.full(L, 7), np.zeros(L, np.int64),
            rng.randint(0, 3, L),                        # many ties
            rng.randint(0, 1 << 18, L),                  # prescaled
            np.r_[np.full(L // 2, 200), rng.randint(0, 200, L - L // 2)]]
    two = np.zeros(L, np.int64)
    two[[0, L - 1]] = 99                                 # two equal maxima
    rows.append(two)
    return np.stack(rows).astype(np.int32)


# every band length of n = 4..64 (dsp.band_starts: 16 at n = 4, then 15,
# 8, 8, 32, 32, 32, 128, 128, 128, 512, 512, 512 and the last band with
# its phantom position: 33, 129, 513, 2049)
BAND_LENGTHS = [8, 15, 16, 32, 33, 128, 129, 512, 513, 2049]


@pytest.mark.parametrize("L", BAND_LENGTHS)
@pytest.mark.parametrize("qp", [1, 2, 8, 16, 31, 127])
def test_torch_ffv2_pvq_plain_matches_jax(L, qp):
    """K18's plain pulse search against ``_pvq_band_device``: ties (equal
    magnitudes), zero bands, two equal maxima, an 18-bit band."""
    band = _band_cases(L, L + qp)
    ref = np.asarray(jtpu._pvq_band_device(jtpu.jnp.asarray(band), qp))
    got = dv._pvq_band_plain(torch.from_numpy(band).to(torch.int64), qp)
    assert np.array_equal(got.numpy(), ref)


def _jax_beats(a, b, a2, b2):
    """JAX's pair order (tpu.py:270-274) on int32 scores: 1 where (a, b)
    beats (a2, b2) on q = a // b, then the int32 cross products r * b2
    against r2 * b; -1 where it loses; 0 on a tie (the index decides)."""
    q, q2 = a // b, a2 // b2
    r, r2 = a - q * b, a2 - q2 * b2
    c = (r * b2).astype(np.int32).astype(np.int64)       # int32 wrap
    c2 = (r2 * b).astype(np.int32).astype(np.int64)
    return np.where(q != q2, np.sign(q - q2), np.sign(c - c2))


def _reachable(rng, size):
    """Score pairs of one pulse step s < 128 under the prescale: a = (xy +
    ax)^2 with xy <= 255 s, ax < 256; b in [1, (s + 1)^2].  Half of them
    at the edges (s = 127, xy = 255 s, ax = 255, b = (s + 1)^2)."""
    s = rng.randint(0, 128, size)
    s[: size // 2] = 127
    out = []
    for _ in range(2):
        xy = (rng.random_sample(size) * (255 * s + 1)).astype(np.int64)
        ax = rng.randint(0, 256, size)
        b = 1 + (rng.random_sample(size) * (s + 1) ** 2).astype(np.int64)
        edge = rng.random_sample(size) < 0.25
        xy = np.where(edge, 255 * s, xy)
        ax = np.where(edge, 255, ax)
        b = np.where(rng.random_sample(size) < 0.25, (s + 1) ** 2, b)
        out += [(xy + ax) ** 2, b]
    return out


def test_torch_ffv2_pvq_order_without_division():
    """K18 compares a / b against a2 / b2 as a * b2 against a2 * b in 64
    bits, with no division: on the range the prescale and qp <= 128 allow
    that is JAX's (q, r * b_other) order exactly, and no int32 product in
    JAX's order wraps (4M seeded pairs, half at the edges)."""
    rng = np.random.RandomState(17)
    a, b, a2, b2 = _reachable(rng, 1 << 22)
    assert a.max() < 1 << 31 and b.max() <= 1 << 14
    assert ((a % b) * b2).max() < 1 << 31
    assert np.array_equal(_jax_beats(a, b, a2, b2), np.sign(a * b2 - a2 * b))
    # equal fractions with other terms: a tie in both orders
    k = rng.randint(1, 100, 1 << 16)
    b = rng.randint(1, 163, 1 << 16)
    a = rng.randint(0, 200000, 1 << 16) * b // b
    assert not _jax_beats(a * k, b * k, a, b).any()


def _pvq_fraction_order(band_abs, qp):
    """The greedy search of K18's kernel as numpy: JAX's prescale, then each
    step's winner the largest a / b (compared exactly by cross products
    in int64), the lowest index among equals; stop with no candidate."""
    out = []
    for row in band_abs.astype(np.int64):
        m = np.float32(max(int(row.max()), 1)).view(np.int32)
        ax = row >> max((int(m) >> 23) - 126 - 8, 0)
        y = np.zeros_like(ax)
        xy = yy = 0
        for _ in range(qp):
            cand = y < qp - 1
            a = np.where(cand, (xy + ax) ** 2, -1)
            b = np.where(cand, yy + 2 * y + 1, 1)
            w = int(np.argmax(a / b))
            while True:
                key = a * b[w] - a[w] * b
                if not (key > 0).any():
                    break
                w = int(np.flatnonzero(key > 0)[np.argmax(
                    (a / b)[key > 0])])
            w = int(np.flatnonzero(key == 0)[0])
            if a[w] < 0:
                break
            y[w] += 1
            xy += int(ax[w])
            yy = int(b[w])
        out.append(y)
    return np.stack(out)


def _pvq_zero_and_list(band_abs, qp):
    """K18's fast steps as numpy: each step the best position with no pulse
    is the largest prescaled magnitude (then the lowest index), key ax <<
    12 | 4095 - p, the positions with pulses a list scored in full, and
    the winner the better of the two by exact cross products."""
    out = []
    for row in band_abs.astype(np.int64):
        m = np.float32(max(int(row.max()), 1)).view(np.int32)
        ax = row >> max((int(m) >> 23) - 126 - 8, 0)
        L = len(ax)
        y = np.zeros_like(ax)
        xy = yy = 0
        for _ in range(qp):
            best = None                              # (a, b, index)
            zero = (y == 0) & (qp >= 2)
            if zero.any():
                key = np.where(zero, ax << 12 | (4095 - np.arange(L)), -1)
                p = 4095 - int(key.max() & 4095)
                best = ((xy + int(ax[p])) ** 2, yy + 1, p)
            for p in np.flatnonzero((y > 0) & (y < qp - 1)):
                c = ((xy + int(ax[p])) ** 2, yy + 2 * int(y[p]) + 1, int(p))
                if best is None or (c[0] * best[1], -c[2]) > (
                        best[0] * c[1], -best[2]):
                    best = c
            if best is None:
                break
            y[best[2]] += 1
            xy += int(ax[best[2]])
            yy = best[1]
        out.append(y)
    return np.stack(out)


@pytest.mark.parametrize("L", [15, 129, 2049])
@pytest.mark.parametrize("qp", [127, 128])
def test_torch_ffv2_pvq_fraction_order_matches_jax(L, qp):
    """The search in K18's order (no division) == ``_pvq_band_device`` at
    the largest qp that order takes: ties, 8-bit maxima everywhere (the
    largest scores), an 18-bit band (prescaled), zeros; and so does the
    kernel's way of finding each step's winner in that order (the
    positions with no pulse by their largest magnitude, the others in
    full)."""
    rng = np.random.RandomState(L + qp)
    band = np.stack([np.full(L, 255), rng.randint(0, 256, L),
                     rng.randint(0, 1 << 18, L), np.zeros(L, np.int64),
                     np.r_[255, np.zeros(L - 1, np.int64)]]).astype(np.int32)
    ref = np.asarray(jtpu._pvq_band_device(jtpu.jnp.asarray(band), qp))
    assert np.array_equal(_pvq_fraction_order(band, qp), ref)
    assert np.array_equal(_pvq_zero_and_list(band, qp), ref)


def test_torch_ffv2_upload_widens_16_bit_words():
    x = np.array([[[0, 1, 255, 4095], [32767, 32768, 40000, 65535]]])
    got = dv.upload(x, 16, torch.device("cpu"))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), x)
    assert np.array_equal(dv.upload(x % 256, 8, "cpu").numpy(), x % 256)


def test_torch_ffv2_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the K18 and K19 wrappers run their plain versions
    (counted) and launch nothing; device="cuda" without a card raises."""
    _build.reset_counts()
    x = _padded((66, 130), 1, 8, 0)
    dv.decode_back(dv.encode_front(x, 8, device="cpu"), 8, 1, 2, 3,
                   device="cpu")
    dv.quantize_streams(np.zeros((2, 4096), np.int32), 4,
                        dsp.band_starts(64), 64, device="cpu")
    ks = _build.KERNELS
    assert [ks[k].plain_calls for k in ("lap_pre", "lap_post", "pvq")] == \
        [1, 1, 1]
    assert not any(ks[k].launches for k in ("lap_pre", "lap_post", "pvq"))
    with pytest.raises(ValueError):
        dv.lap_frame(torch.zeros((1, 64, 64), dtype=torch.int32), 16, True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dv.fwd_tx_batch(np.zeros((1, 4, 4), np.int32))
