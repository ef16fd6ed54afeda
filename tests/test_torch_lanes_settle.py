"""K7's decomposition (csrc/rac_lanes.cu) in plain PyTorch, on the CPU: each
step's four factors from (sv, bit, mode), the coder warp's range chain
writing each step's low increment and renormalisation flag, and the
settler warp's windows of 32 steps, which take every step's low from
prefix sums of the increments since the last renormalisation and the
pending byte and its count from the last reset before it.  The model
equals ``rac.rac_scan_lanes`` (K7's plain version) and the JAX
``tpu_coder.rac_scan_lanes`` exactly, on the lane matrices of the port's
native planner, on long pending runs and on ragged lanes.
"""

import numpy as np
import pytest
import torch

from ffmpeg_ffv2_tpu.ffv1 import tpu_coder as jtc
from ffmpeg_ffv2_tpu_torch.ffv1 import rac
from ffmpeg_ffv2_tpu_torch.ffv1 import tpu_coder as tc
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
from test_torch_formats import torch_one_thread  # noqa: F401

I32 = torch.int32
WARP = 32
BIT31 = -(1 << 31)


def factors(sv, bit, mode):
    """(f, c, g, h) of each step: range' = (range * f + c) >> 8, low' = low
    + ((range * g + h) >> 8); a NOP (any mode but an op or a flush) has f
    = 256."""
    op = mode == tc.MODE_OP
    one = bit != 0
    flush = (mode == tc.MODE_FLUSH1) | (mode == tc.MODE_FLUSH2)
    f = torch.where(op, torch.where(one, sv, 256 - sv),
                    torch.where(flush, 0, 256))
    c = torch.where(op, torch.where(one, 0, 255),
                    torch.where(flush, 0xFF00, 0))
    g = torch.where(op & one, 256 - sv, 0)
    h = torch.where(op, torch.where(one, 255, 0),
                    torch.where(mode == tc.MODE_FLUSH1, 0xFF00, 0))
    return [x.to(I32) for x in (f, c, g, h)]


def coder(f, c, g, h):
    """The coder warp: the range chain of every lane; returns each step's
    event word, its low increment with the renormalisation mask's sign in
    bit 31."""
    steps, lanes = f.shape
    rng = torch.full((lanes,), 0xFF00, dtype=I32)
    ev = torch.empty((steps, lanes), dtype=I32)
    for i in range(steps):
        t = rng * f[i] + c[i]
        inc = (rng * g[i] + h[i]) >> 8
        m = (t - 0x10000) >> 31
        rng = (m & (t & ~0xFF)) | (~m & (t >> 8))
        ev[i] = (m & BIT31) | inc
    return ev


def last_before(flags):
    """(32, lanes) bool -> per step the last earlier step of the window
    with the flag, -1 if none (the kernel's 31 - clz(ballot & below))."""
    idx = torch.arange(WARP, dtype=I32)[:, None].expand_as(flags)
    upto = torch.cummax(torch.where(flags, idx, -1), dim=0).values
    return torch.cat([torch.full_like(upto[:1], -1), upto[:-1]])


def at(x, j):
    """x[j[t, l], l] (the kernel's shuffle from thread j), 0 where j < 0."""
    return torch.where(j >= 0, torch.gather(x, 0, j.clamp(min=0).long()), 0)


def settle(ev, steps):
    """The settler warp over windows of 32 steps: staged (first, fcount,
    fval) of the first ``steps`` steps."""
    lanes = ev.shape[1]
    n = -(-steps // WARP) * WARP
    ev = torch.cat([ev, torch.zeros((n - ev.shape[0], lanes), dtype=I32)])
    low = torch.zeros(lanes, dtype=I32)
    pending = torch.full((lanes,), -1, dtype=I32)
    pcount = torch.zeros(lanes, dtype=I32)
    out = torch.empty((3, n, lanes), dtype=I32)
    for i0 in range(0, n, WARP):
        w = ev[i0:i0 + WARP]
        r = w < 0
        total = torch.cumsum(w & 0x7FFFFFFF, 0, dtype=I32)
        rp = last_before(r)
        s = torch.where(rp >= 0, total - at(total, rp), low + total)
        after = (s & 0xFF) << 8
        lo = s + at(after, rp)
        cc = lo <= 0xFF00
        cd = lo >= 0x10000
        cb = r & (rp < 0) & (pending < 0)
        reset = r & (cb | cc | cd)
        band = (r & ~reset).to(I32)
        hi = lo >> 8
        set_ = torch.where(cb, hi, hi & 0xFF)
        R = last_before(reset)
        bands = torch.cumsum(band, 0, dtype=I32)      # up to t, inclusive
        pend = torch.where(R >= 0, at(set_, R), pending)
        pc = torch.where(R >= 0, bands - band - at(bands, R),
                         bands - band + pcount)
        emit = reset & ~cb
        out[0, i0:i0 + WARP] = torch.where(
            emit, torch.where(cc, pend, pend + 1) & 0xFF, -1)
        out[1, i0:i0 + WARP] = torch.where(emit, pc, 0)
        out[2, i0:i0 + WARP] = torch.where(cc, 0xFF, 0)
        low = torch.where(r[-1], after[-1], lo[-1])
        Z = torch.cummax(torch.where(
            reset, torch.arange(WARP, dtype=I32)[:, None], -1), 0).values[-1]
        pending = torch.where(Z >= 0, at(set_, Z[None])[0], pending)
        pcount = torch.where(Z >= 0, bands[-1] - at(bands, Z[None])[0],
                             pcount + bands[-1])
    return out[:, :steps]


def model(sv, bit, mode):
    steps = sv.shape[0]
    return settle(coder(*factors(sv, bit, mode)), steps)


def check(sv, bit, mode):
    """The model against the JAX scan and the port's plain version, every
    staged array whole."""
    args = [torch.as_tensor(np.ascontiguousarray(a, np.int32))
            for a in (sv, bit, mode)]
    got = model(*args)
    refs = ([np.asarray(a) for a in jtc.rac_scan_lanes(
        *(a.numpy() for a in args))],
            [a.numpy() for a in rac.rac_scan_lanes(*args)])
    for ref in refs:
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), r)
    return got


def _frame(pix, w, h, seed):
    """A gradient with grain in every plane (yuv420p: 8 bits with 30% of
    the samples noise; rgb48: 16 bits, 4-bit grain)."""
    rng = np.random.RandomState(seed)
    shapes = ([(h, w)] * 3 if pix == "rgb48"
              else [(h, w), (h // 2, w // 2), (h // 2, w // 2)])
    planes = []
    for c, (hh, ww) in enumerate(shapes):
        yy, xx = np.mgrid[0:hh, 0:ww]
        if pix == "rgb48":
            x = (xx * 997 + yy * 389 + 5000 * c + rng.randint(0, 16, (hh, ww)))
            planes.append((x & 0xFFFF).astype(np.int32))
        else:
            x = (xx // 8 * 8 + yy + 40 * c) % 256
            noise = rng.rand(hh, ww) < 0.3
            planes.append(np.where(noise, rng.randint(0, 256, (hh, ww)),
                                   x).astype(np.int32))
    return planes


@pytest.mark.parametrize("pix", ["yuv420p", "rgb48"])
def test_torch_lanes_model_native_lanes(pix):
    """The lane matrices the native planner gives for a seeded 64x48
    keyframe (4 slices: 4 lanes of unequal length, each ended by the two
    flushes and NOPs)."""
    cfg = FFV1Config(level=3, coder=1, slices=4)
    enc = tc.TPUCoderFFV1Encoder(64, 48, pix, cfg, device="cpu")
    svs, bits, lens, _ = enc._plan(_frame(pix, 64, 48, 5), True)
    sv, bit, mode = enc.lane_matrices(svs, bits, lens)
    assert sv.shape == (max(lens) + 2, 4) and len(set(lens)) > 1
    first, fcount, _ = check(sv, bit, mode)
    assert int((first >= 0).sum()) > 1000 and int(fcount.max()) > 0


def _carry_run(steps, lanes, start, length, seed):
    """Random ops; lane 0 holds NOPs (the coder's initial state) up to
    step ``start``, then the pair (bit 1, sv 255), (bit 0, sv 255) for
    ``length`` steps, which renormalises with low in (0xFF00, 0x10000)
    each time, so the pending run only grows; every lane ends in the two
    flushes."""
    rng = np.random.RandomState(seed)
    sv = rng.randint(1, 256, (steps, lanes))
    bit = rng.randint(0, 2, (steps, lanes))
    sv[start:start + length, 0] = 255
    bit[start:start + length, 0] = (np.arange(length) % 2) == 0
    mode = np.full((steps, lanes), tc.MODE_OP)
    mode[:start, 0] = tc.MODE_NOP
    mode[-2], mode[-1] = tc.MODE_FLUSH1, tc.MODE_FLUSH2
    return sv, bit, mode


@pytest.mark.parametrize("start", [0, 37])
def test_torch_lanes_model_long_pending_run(start):
    """Lane 0's first renormalisation is case b (no pending byte yet), then
    a fill count above 1023 builds over many windows, from step 0 or from
    inside a window (step 37)."""
    sv, bit, mode = _carry_run(2600, 3, start, 2300, start)
    _, fcount, _ = check(sv, bit, mode)
    assert int(fcount[:, 0].max()) > 1023


@pytest.mark.parametrize("steps,lanes,seed", [(700, 5, 0), (1000, 7, 1),
                                              (33, 2, 2)])
def test_torch_lanes_model_ragged(steps, lanes, seed):
    """Lanes of unequal length, each ended by FLUSH1, FLUSH2 and NOP
    padding, with steps not a multiple of the window."""
    rng = np.random.RandomState(seed)
    sv = rng.randint(1, 256, (steps, lanes))
    bit = rng.randint(0, 2, (steps, lanes))
    mode = np.full((steps, lanes), tc.MODE_OP)
    for l, L in enumerate(rng.randint(0, steps - 1, lanes)):
        mode[L:, l] = tc.MODE_NOP
        mode[L, l] = tc.MODE_FLUSH1
        mode[L + 1, l] = tc.MODE_FLUSH2
    check(sv, bit, mode)


def test_torch_lanes_factors_reproduce_the_scan_step():
    """For every sv 1..255, both bits, every mode (5 stands for any other,
    a NOP) and ranges over 0x100..0xFFFF: the factors give the scan's new
    range, its low increment, and renormalise exactly where it does."""
    rng_v = np.arange(0x100, 0x10000, 29, dtype=np.int64)[:, None, None]
    sv = np.arange(1, 256, dtype=np.int64)[None, :, None]
    bit = np.array([0, 1], dtype=np.int64)[None, None, :]
    for m in (tc.MODE_OP, tc.MODE_FLUSH1, tc.MODE_FLUSH2, tc.MODE_NOP, 5):
        mode = np.full(np.broadcast(rng_v, sv, bit).shape, m)
        f, c, g, h = (x.numpy().astype(np.int64) for x in factors(
            *(torch.as_tensor(np.broadcast_to(a, mode.shape).copy())
              for a in (sv, bit, mode))))
        t = rng_v * f + c
        inc = (rng_v * g + h) >> 8
        r1 = (rng_v * sv) >> 8
        op = m == tc.MODE_OP
        flush = m in (tc.MODE_FLUSH1, tc.MODE_FLUSH2)
        rng1 = (np.where(bit == 1, r1, rng_v - r1) if op
                else np.full_like(t, 0xFF) if flush else rng_v + 0 * t)
        low_inc = (np.where(bit == 1, rng_v - r1, 0) if op
                   else np.full_like(t, 0xFF if m == tc.MODE_FLUSH1 else 0))
        assert np.array_equal(t >> 8, np.broadcast_to(rng1, t.shape))
        assert np.array_equal(inc, np.broadcast_to(low_inc, t.shape))
        renorm = (rng1 < 0x100) & (op or flush)
        assert np.array_equal(t < 0x10000, np.broadcast_to(renorm, t.shape))
