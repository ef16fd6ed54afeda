"""K5's decomposition (csrc/vlc.cu) in plain PyTorch, on the CPU: a loader
warp turns each row into the chain's inputs (the count carried as the count
it would reach without halving), the chain warp runs bias and drift a row
at a time with no division (the halving at count == 128 a shift by a flag,
the drift tests selects) and hands each row's folded value, code sign and
live flag to the store warps, which run error_sum over a batch and take
each row's k from two leading-zero counts and one compare.  The
division-free k equals the reference's sum over k for every error_sum and
count, and the model equals
``vlc.vlc_adapt_plain`` (K5's plain version) and the JAX
``device_rice.vlc_adapt_reference`` exactly on split groups of seeded
frames at pb = 12 and 16, across a tile of cap 0, on a lane past 128 live
cells and on one with none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu.ffv1 import device_rice as jdr
from ffmpeg_ffv2_tpu_torch.ffv1 import host
from ffmpeg_ffv2_tpu_torch.ffv1 import rice
from ffmpeg_ffv2_tpu_torch.ffv1.adapt import successors
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu_torch.ffv1.vlc import vlc_adapt_plain
from ffmpeg_ffv2_tpu_torch.ops.place import place
from test_torch_formats import torch_one_thread  # noqa: F401
from test_torch_rice16 import cells16  # noqa: F401

I32 = torch.int32
BATCH = 16
POW2 = torch.tensor([1 << b for b in range(31)], dtype=torch.int64)


def clz(x):
    """Leading zeros of non-negative int32 values (the kernel's __clz)."""
    return 32 - torch.searchsorted(POW2, x.long(), right=True).to(I32)


def k_of(es, count):
    """The store warp's k: the smallest k with count << k >= es, from k0 =
    clz(count) - clz(es); 16 (es > 0) or 0 for a zero count."""
    k0 = torch.clamp(clz(count) - clz(es), min=0)
    kc = k0 + ((count << k0) < es).to(I32)
    return torch.where(count > 0, kc, torch.where(es > 0, 16, 0))


def count_at(n, big):
    """The VlcState count of a lane whose count, never halved, would be n:
    n up to 128, then 65..128 over and over; n where the state started
    above 128 (big)."""
    return torch.where(big | (n <= 128), n, 65 + ((n - 129) & 63))


def prep_row(x, pb, bits, cnt):
    """The loader warp's row: cnt = [n, big] in place; returns the chain's
    inputs (v0, the count after the row, the halving flag, the value mask
    where the row is live)."""
    n, big = cnt
    live = ((x >> (pb + 1)) & ~(x >> pb)) & 1
    count = count_at(n, big)
    cnt[0] = n = n + live
    return ((x & ((1 << pb) - 1)) - (1 << (pb - 1)), count_at(n, big),
            live & (count == 128).to(I32), ((1 << bits) - 1) & -live)


def chain_row(p, bits, count, st):
    """The chain warp's row on the loader's p, the count before the row:
    st = [drift, bias] in place; returns the word v << 2 | sign << 1 |
    live."""
    drift, bias = st
    v0, c1, h, wmask = p
    live = wmask != 0
    hm = wmask & (1 << (bits - 1))
    sgn = (2 * drift + count) >> 31
    u = ((v0 - bias) & wmask) ^ hm
    d1 = (drift + u - hm) >> h
    neg = live & (d1 <= -c1)
    pos = live & (d1 > 0)
    dn = torch.maximum(d1 + c1, 1 - c1)
    dp = torch.clamp(d1 - c1, max=0)
    bm, bp = torch.clamp(bias - 1, min=-128), torch.clamp(bias + 1, max=127)
    st[0] = torch.where(neg, dn, torch.where(pos, dp, d1))
    st[1] = torch.where(neg, bm, torch.where(pos, bp, bias))
    return ((u - hm) << 2) | (sgn & 2) | live.to(I32)


def next_es(es, w, h):
    """error_sum after a row from the chain's word and the halving flag."""
    return ((es + (w >> 2).abs()) & torch.where((w & 1) > 0, 0xFFFF, -1)) >> h


def code_word(w, bits, es, count):
    """A row's code word from the pre-row es and count, 0 where the row is
    not live."""
    sgn = -((w >> 1) & 1)
    v = w >> 2
    k = k_of(es, count)
    code = v ^ sgn
    vv = (code << 1) ^ (code >> 31)
    e = vv >> k
    esc = e >= 12
    length = torch.where(esc, 12 + bits, e + k + 1)
    val = torch.where(esc, vv - 11, (1 << k) | (vv & ((1 << k) - 1)))
    return torch.where((w & 1) > 0, (length << 18) | val, 0)


def model(ch1, caps, bases, pred, s0, bits):
    """K5 as the kernel splits it: per root tile its successor chain, per
    tile batches of 16 rows (zero past the tile), the loader warp's pass
    over a batch (the chain's inputs), the chain warp's, then the store
    warps': error_sum over every row, keeping the pre-row values, then the
    code words (the kernel's two store warps each take every other row);
    each warp writes its own states to ``ends``."""
    pb = rice.rice_pb(bits)
    code = torch.zeros_like(ch1)
    ends = torch.zeros((caps.shape[0], 4, 128), dtype=I32)
    succ = successors(pred).tolist()
    cellrows = ch1.shape[0]
    zero = torch.zeros(128, dtype=I32)
    for root, p in enumerate(pred.tolist()):
        if p >= 0:
            continue
        drift = es = bias = count = zero
        cnt = [zero, torch.zeros(128, dtype=torch.bool)]
        tile = root
        while tile >= 0:
            base, cap = int(bases[tile]), int(caps[tile])
            if base < 0 or cap > cellrows - base:
                cap = 0
            if cap <= 0:
                drift = es = bias = count = zero
                cnt = [zero, torch.zeros(128, dtype=torch.bool)]
                tile = succ[tile]
                continue
            blk = s0[tile]
            if tile == root:
                load = torch.ones(128, dtype=torch.bool)
            else:
                load = blk[4] <= 0
            drift, es, bias, count = (torch.where(load, blk[i], x) for i, x
                                      in enumerate((drift, es, bias, count)))
            cnt = [torch.where(load, blk[3], cnt[0]),
                   torch.where(load, blk[3] > 128, cnt[1])]
            st = [drift, bias]
            for r0 in range(0, cap, BATCH):
                rows = ch1[base + r0:base + min(r0 + BATCH, cap)]
                rows = torch.cat([rows, torch.zeros(
                    (BATCH - rows.shape[0], 128), dtype=I32)])
                preps = [prep_row(x, pb, bits, cnt) for x in rows]
                words, pre = [], []
                for p in preps:
                    words.append(chain_row(p, bits, count, st))
                    pre.append((es, count))
                    es = next_es(es, words[-1], p[2])
                    count = p[1]
                for i, (w, (e, c)) in enumerate(zip(words, pre)):
                    if r0 + i < cap:
                        code[base + r0 + i] = code_word(w, bits, e, c)
            drift, bias = st
            ends[tile] = torch.stack([drift, es, bias, count])
            tile = succ[tile]
    return code, ends


def check(args, bits, rows=None):
    """The model against vlc_adapt_plain (whole) and the JAX reference
    (code rows of the walked tiles, ``rows``, and the end states)."""
    code, ends = model(*args, bits)
    plain = vlc_adapt_plain(*args, bits)
    assert torch.equal(code, plain[0]) and torch.equal(ends, plain[1])
    ch1, caps, bases, pred, s0 = (jnp.asarray(a.numpy()) for a in args)
    ref = jdr.vlc_adapt_reference(ch1, caps, bases, pred, s0,
                                  int(args[1].shape[0]), bits)
    rows = slice(None) if rows is None else rows
    assert np.array_equal(code.numpy()[rows], np.asarray(ref[0])[rows])
    assert np.array_equal(ends.numpy(), np.asarray(ref[1]))
    return code, ends


def test_torch_vlc_k_without_division():
    """k from two leading-zero counts and one compare equals JAX
    vlc_code_word's sum((count << ks) < es) over ks < 16 (read off a zero
    value's length, k + 1) and the port's, for every es in 0..0xFFFF and
    count in 0..128 (count 0: the zero carry)."""
    es = torch.arange(1 << 16, dtype=I32)
    zero = torch.zeros_like(es)
    for count in range(129):
        c = torch.full_like(es, count)
        got = k_of(es, c)
        ref = np.asarray(jdr.vlc_code_word(
            jnp.asarray(zero.numpy()), jnp.asarray(zero.numpy()),
            jnp.asarray(es.numpy()), jnp.asarray(zero.numpy()),
            jnp.asarray(c.numpy()), 8)[0]) - 1
        port = rice.vlc_code_word(zero, zero, es, zero, c, 8)[0] - 1
        assert np.array_equal(got.numpy(), ref), count
        assert torch.equal(got, port), count


W48, H48 = 48, 32
CFG = FFV1Config(level=3, coder=0, slices=4)


def _vcanon(rows, seed):
    """A random canonical vlc table: drift -128..0, error_sum 0..0xFFFF,
    bias -128..127, count 1..128."""
    rng = np.random.RandomState(seed)
    return torch.as_tensor(np.stack([-rng.randint(0, 129, rows),
                                     rng.randint(0, 1 << 16, rows),
                                     rng.randint(-128, 128, rows),
                                     rng.randint(1, 129, rows)],
                                    1).astype(np.int32))


def _tile_rows(caps, bases):
    return torch.cat([torch.arange(b, b + c) for b, c in
                      zip(bases.tolist(), caps.tolist()) if c > 0])


@pytest.mark.parametrize("gcap", [64, 16])
def test_torch_vlc_chain_model_split_groups(monkeypatch, gcap):
    """The cells of a seeded 48x32 yuv420p keyframe (a gradient, 30%
    noise) at GCAP 64 and 16, whose large groups split into tile chains."""
    monkeypatch.setattr(host, "GCAP", gcap)
    monkeypatch.setattr(jdc, "GCAP", gcap)
    rng = np.random.RandomState(12)
    planes = []
    for hh, ww in ((H48, W48), (H48 // 2, W48 // 2), (H48 // 2, W48 // 2)):
        yy, xx = np.mgrid[0:hh, 0:ww]
        noise = rng.rand(hh, ww) < 0.3
        planes.append(torch.as_tensor(np.where(
            noise, rng.randint(0, 256, (hh, ww)),
            (xx // 8 * 8 + yy) % 256).astype(np.int32)))
    enc = DeviceFFV1Encoder(W48, H48, "yuv420p", CFG, device="cpu").banks[0]
    ctx, streams = enc.phase_a_rice(planes)
    tiles_cap, cellrows_cap = 256, 4096
    plan = enc.layout(ctx, streams["payload"], tiles_cap, cellrows_cap,
                      rice.PAYLOAD_BITS + 1)
    pred = plan["tile_pred"]
    assert (pred >= 0).any()
    ch1c, _ = place(plan, cellrows_cap)
    s0 = rice.build_vlc_s0(plan, _vcanon(enc.vcanon.shape[0], 4), tiles_cap)
    args = (ch1c, plan["tile_caps"], plan["tile_bases"], pred, s0)
    code, _ = check(args, 8)
    assert int((code >> 18).max()) > 0


def test_torch_vlc_chain_model_pb16(cells16):
    """pb = 16: the yuv420p16 cells of test_torch_rice16.py (JAX encoder
    stages, a flat lower half: silent cells)."""
    code, _ = check(cells16["args"], 16)
    assert int((code >> 18).max()) > 12 + 8


def _synthetic(bits, seed):
    """A chain of 5 tiles (0 -> 1 -> 2 -> 3 -> 4) whose tile 2 has cap 0,
    and two lone tiles; caps not multiples of 32.  Tile 6 holds 300 rows:
    lane 5 is live in every row (count passes 128 twice), lane 7 in none
    (invalid or silent).  One cell in 8 is invalid, one in 8 silent;
    random start states (counts 0, 1, 128 and 200 among them) and
    continuation flags."""
    rng = np.random.RandomState(seed)
    pb = rice.rice_pb(bits)
    caps = np.array([70, 33, 0, 95, 64, 31, 300], np.int32)
    pred = np.array([-1, 0, 1, 2, 3, -1, -1], np.int32)
    bases = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int32)
    cellrows = int(caps.sum()) + 16
    half = 1 << (bits - 1)
    diff = rng.randint(-half, half, (cellrows, 128))
    diff = np.where(rng.rand(cellrows, 128) < 0.5, diff // 64, diff)
    valid = rng.rand(cellrows, 128) >= 0.125
    silent = rng.rand(cellrows, 128) < 0.125
    t6 = slice(int(bases[6]), int(bases[6]) + 300)
    valid[t6, 5], silent[t6, 5] = True, False
    valid[t6, 7] = False
    silent[t6, 7] = True
    valid[int(caps.sum()):] = False
    ch1 = (((diff + (1 << (pb - 1))) & ((1 << pb) - 1))
           | (silent.astype(np.int64) << pb)
           | (valid.astype(np.int64) << (pb + 1)))
    s0 = np.stack([-rng.randint(0, 129, (7, 128)),
                   rng.randint(0, 1 << 16, (7, 128)),
                   rng.randint(-128, 128, (7, 128)),
                   rng.choice([0, 1, 128, 5, 77, 200], (7, 128)),
                   rng.randint(-1, 2, (7, 128))], 1)
    live = valid & ~silent
    return ([torch.as_tensor(np.ascontiguousarray(a, np.int32))
             for a in (ch1, caps, bases, pred, s0)], live, t6)


@pytest.mark.parametrize("bits", [8, 16])
def test_torch_vlc_chain_model_halving_and_empty(bits):
    """The synthetic chain at coding depth 8 (pb 12) and 16 (pb 16): a cap-0
    tile inside the chain (its successor loads a zero carry), a lane with
    300 live cells and one with none."""
    args, live, t6 = _synthetic(bits, bits)
    assert live[t6, 5].sum() == 300 and not live[t6, 7].any()
    code, ends = check(args, bits, _tile_rows(args[1], args[2]).numpy())
    assert (code[t6, 5] != 0).all() and not code[t6, 7].any()
    assert int(ends[6, 3, 5]) <= 128
    assert torch.equal(ends[6, :, 7], args[4][6, :4, 7])
