"""The PyTorch port's deep-format and RGB stages against the JAX package, on
the CPU: the repeat sub-steps of the adapt walk (K2's plain version) at
coding depths 16 and 17, the repack to emission order above depth 10, the
emission-order walk (K6's plain version), the wide cell payload of the
layout and the unsort, RGB phase A (fixed and per-slice RCT), the v4 RCT
cost search and its slice-header prefixes, and the port's copy of rct.py.
Inputs are made from seeded numpy; every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu.ffv1 import rct as jrct
from ffmpeg_ffv2_tpu.ffv1.adapt_pallas import adapt_pallas
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu_torch.ffv1 import adapt as tad
from ffmpeg_ffv2_tpu_torch.ffv1 import device_coder as tdc
from ffmpeg_ffv2_tpu_torch.ffv1 import host
from ffmpeg_ffv2_tpu_torch.ffv1 import phase_a as tpa
from ffmpeg_ffv2_tpu_torch.ffv1 import rct as trct
from ffmpeg_ffv2_tpu_torch.ffv1 import symbols
from test_torch_formats import torch_one_thread  # noqa: F401

CFG = FFV1Config(level=3, coder=1, slices=4)
CFG4 = FFV1Config(level=4, coder=1, slices=4, slicecrc=1)


def np_(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def t_(x):
    return torch.as_tensor(np.array(x))


def _shapes(p, w, h):
    if p.colorspace == 1:
        return [(h, w)] * (3 + p.transparency)
    return [(h, w)] + ([(-(-h >> p.chroma_v_shift), -(-w >> p.chroma_h_shift))]
                       * 2 if p.chroma_planes else [])


def ramp_band(p, w, h, seed):
    """A smooth ramp per plane (large context groups) with a band of
    full-range noise rows (exponents up to the coding depth)."""
    rng = np.random.RandomState(seed)
    mx = 1 << p.bits
    planes = []
    for c, (hh, ww) in enumerate(_shapes(p, w, h)):
        yy, xx = np.mgrid[0:hh, 0:ww]
        band = (yy >= hh // 4) & (yy < hh // 2)
        planes.append(np.where(band, rng.randint(0, mx, (hh, ww)),
                               (xx * 37 + yy * 5 + 1000 * c) % mx)
                      .astype(np.int32))
    return planes


def _stages(pix, w, h, gcap, seed):
    """The JAX stages of one frame up to the adapt walk, laid out at the
    encoder's starting caps, or at the worst-case caps where the frame
    outgrows them (no retry), from random start states."""
    jenc = jdc.DeviceFFV1Encoder(w, h, pix, CFG, use_pallas=False)
    cb = jenc.code_bits
    planes = ramp_band(jenc.p, w, h, seed)
    ctx, diff = jenc._phase_a([jnp.asarray(x) for x in planes])
    tiles_cap = jenc.tiles_max
    row_local = jnp.asarray(jenc.class_off_stream)[None, :] + ctx
    wide = jdc.payload_field(cb)[2] if cb > 10 else 0
    plan = jdc.layout_plan(row_local, diff, jenc.rows_per_slice,
                           tiles_cap * 128, tiles_cap, wide=wide)
    cellrows = (jenc.cellrows_cap
                if int(plan["n_rows"]) + 512 <= jenc.cellrows_cap
                else jenc.cellrows_max)
    assert int(plan["n_rows"]) + 512 <= cellrows
    ch1c, ch2c = jdc.scatter_cells(plan, cellrows)
    rng = np.random.RandomState(seed + 1)
    canon = jnp.asarray(rng.randint(1, 256, (jenc.n_chain_rows + 1, 32))
                        .astype(np.uint8))
    s0 = jdc.build_s0_blocks(plan, canon, tiles_cap)
    table = jnp.asarray(jenc.table)
    sv, ends = jdc.adapt_reference(ch1c, plan["tile_caps"],
                                   plan["tile_bases"], plan["tile_pred"], s0,
                                   table, tiles_cap, code_bits=cb)
    mask, bias, _ = jdc.payload_field(cb)
    return dict(jenc=jenc, cb=cb, wide=wide, tiles_cap=tiles_cap,
                cellrows=cellrows, ctx=ctx, diff=diff, row_local=row_local,
                plan=plan, ch1c=ch1c, ch2c=ch2c, s0=s0, table=table, sv=sv,
                ends=ends, diff_c=(ch1c & mask) - bias)


@pytest.fixture(scope="module", params=[("yuv444p16", 4096),
                                        ("rgb48", 4096), ("rgb48", 64)],
                ids=["yuv444p16", "rgb48", "rgb48-gcap64"])
def deep(request):
    pix, gcap = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdc, "GCAP", gcap)
        mp.setattr(host, "GCAP", gcap)
        w, h = (48, 32) if gcap == 64 else (24, 16)
        yield _stages(pix, w, h, gcap, 3)


def _k2(st):
    pl = st["plan"]
    return (t_(st["ch1c"]), t_(pl["tile_caps"]), t_(pl["tile_bases"]),
            t_(pl["tile_pred"]), t_(st["s0"]), t_(st["table"]), st["cb"])


def test_torch_deep_layout_wide_payload(deep):
    """The wide cell payload (16-bit field, valid flag at bit 16; 17-bit at
    depth 17) equals JAX layout_plan's."""
    tc = deep["tiles_cap"]
    got = tdc.layout_plan(t_(deep["row_local"]), t_(deep["diff"]),
                          deep["jenc"].rows_per_slice, tc * 128, tc,
                          wide=deep["wide"])
    for k, v in deep["plan"].items():
        assert np.array_equal(np_(got[k]), np_(v)), k
    if host.GCAP == 64:
        assert (np_(deep["plan"]["tile_pred"]) >= 0).any()


def test_torch_deep_adapt_repeat_substeps(deep):
    """K2's plain version with R = code_bits - 10 repeat sub-steps ==
    adapt_reference, on cells that reach e >= 10."""
    assert int((np.abs(np_(deep["diff_c"])) >= 1 << 10).sum()) > 0
    sv, ends = tad.adapt(*_k2(deep))
    assert sv.shape[1] == host.n_sv_words(deep["cb"])
    assert np.array_equal(np_(sv), np_(deep["sv"]))
    assert np.array_equal(np_(ends), np_(deep["ends"]))


@pytest.mark.parametrize("n_words", [None, 3])
def test_torch_deep_repack(deep, n_words):
    got = tdc.repack_emission_order(t_(deep["sv"]), t_(deep["diff_c"]),
                                    deep["cb"], n_words)
    ref = jdc.repack_emission_order(deep["sv"], deep["diff_c"], deep["cb"],
                                    n_words)
    assert np.array_equal(np_(got), np_(ref))


def _below_count(words, diff):
    """The emission-order words with the bytes at or past each cell's op
    count zeroed (numpy)."""
    e = np.floor(np.log2(np.maximum(np.abs(diff), 1))).astype(np.int64)
    count = np.where(diff == 0, 1, 2 * e + 3)
    out = words.astype(np.int64) & 0xFFFFFFFF
    for m in range(words.shape[-2]):
        keep = np.clip(count - 4 * m, 0, 4)
        out[..., m, :] &= (1 << (8 * keep)) - 1
    return out.astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("ev_words", ["full", 3])
def test_torch_deep_emission_plain(deep, ev_words):
    """K6's plain version == JAX repack_emission_order(adapt_reference)
    with the bytes past each cell's op count zeroed: the JAX emission
    kernel leaves them 0, the JAX repack repeats the sign byte there, and
    no op reads them."""
    nw = host.n_ev_words(deep["cb"]) if ev_words == "full" else ev_words
    ev, ends = tad.adapt_emission(*_k2(deep), nw)
    ref = jdc.repack_emission_order(deep["sv"], deep["diff_c"], deep["cb"],
                                    nw)
    assert np.array_equal(np_(ev), _below_count(np_(ref),
                                                np_(deep["diff_c"])))
    assert np.array_equal(np_(ends), np_(deep["ends"]))


def test_torch_deep_emission_plain_vs_pallas_interpret(monkeypatch):
    """K6's plain version == the JAX emission kernel itself
    (adapt_pallas(emission_order=True), interpret mode), every byte of
    every walked row, at a tiny yuv444p16 size."""
    monkeypatch.setattr(jdc, "GCAP", 4096)
    monkeypatch.setattr(host, "GCAP", 4096)
    st = _stages("yuv444p16", 16, 16, 4096, 5)
    pl = st["plan"]
    nw = host.n_ev_words(16)
    ev, ends = tad.adapt_emission(*_k2(st), nw)
    jev, jends = adapt_pallas(st["ch1c"], pl["tile_caps"], pl["tile_bases"],
                              pl["tile_pred"], st["s0"], st["table"],
                              st["tiles_cap"], st["cellrows"], code_bits=16,
                              ev_words=nw, interpret=True,
                              emission_order=True)
    rows = int(pl["n_rows"])
    tiles = int(pl["n_tiles"])
    assert np.array_equal(np_(ev)[:rows], np_(jev)[:rows])
    assert np.array_equal(np_(ends)[:tiles], np_(jends)[:tiles])


def test_torch_deep_unsort_wide(deep):
    """The unsort reads the op count through the wide payload field."""
    jenc = deep["jenc"]
    ev = jdc.repack_emission_order(deep["sv"], deep["diff_c"], deep["cb"])
    words, maxc = tdc.unsort_cells(t_(ev), t_(deep["ch1c"]), t_(deep["ch2c"]),
                                   jenc.S, jenc.npix, deep["cb"])
    ref, rmaxc = jenc._s_unsort_impl(ev, deep["ch1c"], deep["ch2c"], jenc.S,
                                     deep["cellrows"])
    assert int(maxc) == int(rmaxc) and int(maxc) > 20
    for a, b in zip(words, ref):
        assert np.array_equal(np_(a), np_(b))


@pytest.mark.parametrize("bits", [8, 12, 16, 17])
def test_torch_emission_slots_and_source(bits):
    rng = np.random.RandomState(bits)
    half = 1 << (bits - 1)
    diff = np.concatenate([np.arange(-40, 41), rng.randint(-half, half, 300),
                           [half - 1, -half]]).astype(np.int32)
    k_max = host.k_max_for_bits(bits)
    for fn, jfn in ((symbols.emission_slots, jdc.emission_slots),
                    (symbols.emission_source, jdc.emission_source)):
        for a, b in zip(fn(t_(diff), k_max), jfn(jnp.asarray(diff), k_max)):
            assert np.array_equal(np_(a), np_(b)), fn.__name__


@pytest.mark.parametrize("bits", [12, 16, 17])
@pytest.mark.parametrize("n_words", [None, 2])
def test_torch_repack_random_words(bits, n_words):
    """The repack on random slot-packed words (repeat-pair words
    included) and a diff mix reaching the depth's largest exponent."""
    rng = np.random.RandomState(bits + 7)
    half = 1 << (bits - 1)
    diff = rng.randint(-half, half, (3, 128)).astype(np.int32)
    diff[0, :40] = rng.randint(-8, 9, 40)
    W = host.n_sv_words(bits)
    sv = rng.randint(-2 ** 31, 2 ** 31 - 1, (3, W, 128),
                     dtype=np.int64).astype(np.int32)
    got = tdc.repack_emission_order(t_(sv), t_(diff), bits, n_words)
    ref = jdc.repack_emission_order(jnp.asarray(sv), jnp.asarray(diff), bits,
                                    n_words)
    assert np.array_equal(np_(got), np_(ref))


# ---------------------------------------------------------------------------
# RGB phase A and the v4 RCT search

def rgb_quadrants(bits, w, h, seed):
    """RGB whose 2x2 quadrants pick different RCT pairs: a noisy g beside
    a smooth b and r, b following g, r following g, and a smooth g beside
    a noisy b (the sample values wrap at 2^bits)."""
    rng = np.random.RandomState(seed)
    mx = 1 << bits
    yy, xx = np.mgrid[0:h, 0:w]
    ramp = xx * 3 + yy * 2 + 11 * seed
    g = ramp + rng.randint(0, 40, (h, w))
    left, top = xx < w // 2, yy < h // 2
    b = np.where(top & ~left, g + 7, ramp * 2)
    r = np.where(~top & left, g + 5, ramp * 2 + xx)
    q3 = ~top & ~left
    g = np.where(q3, ramp, g)
    b = np.where(q3, ramp + rng.randint(0, 40, (h, w)), b)
    return [(x % mx).astype(np.int32) for x in (g, b, r)]


@pytest.mark.parametrize("pix", ["bgr0", "gbrp10", "rgb48"])
def test_torch_rgb_phase_a(pix):
    """RGB phase A == JAX _phase_a (fixed 1,1 RCT) and _phase_a_rct
    (per-slice coefficients), streams interleaved per line; gbrp10 takes
    the swapped plane order, rgb48 the int32 samples."""
    w, h = 32, 24
    jenc = jdc.DeviceFFV1Encoder(w, h, pix, CFG4, use_pallas=False)
    enc = tdc.DeviceFFV1Encoder(w, h, pix, CFG4, device="cpu").banks[0]
    rng = np.random.RandomState(4)
    planes = [rng.randint(0, 1 << jenc.p.bits, (h, w)).astype(np.int32)
              for _ in range(3)]
    jpl = [jnp.asarray(x) for x in planes]
    tpl = [t_(x) for x in planes]
    for a, b in zip(enc.phase_a(tpl), jenc._phase_a(jpl)):
        assert np.array_equal(np_(a), np_(b))
    pairs = [jrct.RCT_Y_COEFF[i] for i in rng.randint(0, 15, enc.S)]
    by = np.array([p[1] for p in pairs], np.int32)
    ry = np.array([p[0] for p in pairs], np.int32)
    got = enc.phase_a(tpl, t_(by), t_(ry))
    ref = jenc._phase_a_rct(jpl, jnp.asarray(by), jnp.asarray(ry))
    for a, b in zip(got, ref):
        assert np.array_equal(np_(a), np_(b))


@pytest.mark.parametrize("pix,seed", [("bgr0", 1), ("bgr0", 2),
                                      ("rgb48", 3)])
def test_torch_rct_costs_and_pick(pix, seed):
    """The per-slice candidate totals == the JAX _rct_cost_parts row sums
    (bignum), the picks == JAX _pick_rct and the scalar oracle
    rct.choose_rct_params on each slice."""
    w, h = 48, 32
    jenc = jdc.DeviceFFV1Encoder(w, h, pix, CFG4, use_pallas=False)
    enc = tdc.DeviceFFV1Encoder(w, h, pix, CFG4, device="cpu").banks[0]
    planes = rgb_quadrants(jenc.p.bits, w, h, seed)
    tpl = [t_(x) for x in planes]
    jpl = [jnp.asarray(x) for x in planes]
    costs = tpa.rct_costs(tpl, enc.crop_plan[0])
    assert costs.dtype == torch.int64
    ref = np.asarray(jenc._rct_cost_parts(jpl)).astype(object).sum(axis=2)
    assert costs.tolist() == ref.tolist()
    picks = enc.pick_rct(tpl)
    assert picks == jenc._pick_rct(jpl)
    oracle = [jrct.choose_rct_params([x[y:y + hh, x0:x0 + ww]
                                      for x in planes], jenc.p.bits)
              for (x0, y, ww, hh) in enc.crop_plan[0]]
    assert picks == oracle
    if pix == "bgr0":
        assert len(set(picks)) > 1


@pytest.mark.parametrize("keyframe", [True, False])
def test_torch_prefix_for_rct(keyframe):
    w, h = 48, 32
    jenc = jdc.DeviceFFV1Encoder(w, h, "bgr0", CFG4, use_pallas=False)
    enc = tdc.DeviceFFV1Encoder(w, h, "bgr0", CFG4, device="cpu").banks[0]
    rct_list = [(1, 1), (0, 2), (3, 1), (0, 0)]
    got = enc.prefix_for_rct(keyframe, rct_list)
    ref = jenc._prefix_for_rct(keyframe, rct_list)
    assert got[0].shape[1] % 16 == 0
    for a, b in zip(got, ref):
        assert np.array_equal(np_(a), np_(b))
    assert enc.prefix_for_rct(keyframe, rct_list) is got       # cached


def test_torch_rct_copy():
    """rct.py equals its original: the candidate table and the scalar
    search on random and correlated slices."""
    assert trct.RCT_Y_COEFF == jrct.RCT_Y_COEFF
    rng = np.random.RandomState(9)
    for bits, (h, w) in ((8, (12, 20)), (16, (9, 7)), (8, (1, 5))):
        for planes in ([rng.randint(0, 1 << bits, (h, w)) for _ in range(3)],
                       rgb_quadrants(bits, w, h, bits)):
            assert (trct.choose_rct_params(planes, bits)
                    == jrct.choose_rct_params(planes, bits))
