"""The PyTorch port's Golomb-Rice device encoder against the JAX package, on
the CPU (every kernel wrapper runs its plain PyTorch version on CPU
tensors).  Inputs are made from seeded numpy; every comparison is exact
(np.array_equal / equal packet bytes)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu.ffv1 import device_rice as jdr
from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.ffv1 import host
from ffmpeg_ffv2_tpu_torch.ffv1 import rice
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.vlc import vlc_adapt, vlc_adapt_plain
from test_torch_formats import torch_one_thread  # noqa: F401
from ffmpeg_ffv2_tpu_torch.ops.place import place


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _t(a):
    return torch.as_tensor(np.array(a))


def synth_plane(rng, S, h, w, zero_frac=0.6, ctx0_frac=0.3):
    """tests/test_device_rice.py's synthetic (ctx, diff) planes."""
    diff = rng.integers(-20, 20, size=(S, h, w)).astype(np.int32)
    diff[rng.random((S, h, w)) < zero_frac] = 0
    ctx = rng.integers(0, 5, size=(S, h, w)).astype(np.int32)
    ctx[rng.random((S, h, w)) > ctx0_frac] += 1
    return ctx, diff


def test_torch_plan_runs_plane():
    rng = np.random.default_rng(7)
    ctx, diff = synth_plane(rng, 3, 6, 37)
    got = rice.plan_runs_plane(_t(ctx), _t(diff))
    ref = jdr.plan_runs_plane(jnp.asarray(ctx), jnp.asarray(diff))
    assert set(got) == set(ref)
    for k in ref:
        assert _eq(got[k], ref[k]), k


def test_torch_build_rice_streams():
    rng = np.random.default_rng(8)
    planes = [synth_plane(rng, 3, 6, 37), synth_plane(rng, 3, 3, 19),
              synth_plane(rng, 3, 3, 19)]
    got = rice.build_rice_streams([_t(c) for c, _ in planes],
                                  [_t(d) for _, d in planes])
    ref = jdr.build_rice_streams([jnp.asarray(c) for c, _ in planes],
                                 [jnp.asarray(d) for _, d in planes])
    assert set(got) == set(ref)
    for k in ref:
        assert _eq(got[k], ref[k]), k


def test_torch_ladder_step():
    i0 = np.repeat(np.arange(0, 41, 5, dtype=np.int32), 8)
    c = np.tile(np.array([0, 1, 2, 3, 7, 15, 100, 4000], np.int32), 9)
    got = rice.ladder_step(_t(i0), _t(c))
    ref = jdr.ladder_step(jnp.asarray(i0), jnp.asarray(c))
    for a, b in zip(got, ref):
        assert _eq(a, b)


def test_torch_run_index_scan():
    rng = np.random.default_rng(3)
    L, E = 4, 50
    cnt = rng.integers(0, 200, size=(L, E)).astype(np.int32)
    fl = rng.random((L, E)) < 0.2
    va = np.ones((L, E), bool)
    va[:, 40:] = False
    rs = (rng.random((L, E)) < 0.1) & va
    got = rice.run_index_scan(_t(cnt), _t(fl), _t(va), _t(rs),
                              _t(np.full(L, E, np.int32)))
    ref = jdr.run_index_scan(jnp.asarray(cnt), jnp.asarray(fl),
                             jnp.asarray(va), jnp.asarray(rs))
    assert _eq(got, ref)


def test_torch_run_index_scan_event_counts():
    """With per-lane event counts the walk stops at each lane's count:
    valid flags past it are ignored, and the entries before it equal the
    JAX scan with those flags cleared."""
    rng = np.random.default_rng(9)
    L, E = 5, 60
    cnt = rng.integers(0, 500, size=(L, E)).astype(np.int32)
    fl = rng.random((L, E)) < 0.2
    va = rng.random((L, E)) < 0.9
    rs = (rng.random((L, E)) < 0.1) & va
    n_ev = np.array([0, 1, 17, 59, 60], np.int32)
    live = np.arange(E)[None, :] < n_ev[:, None]
    got = rice.run_index_scan(_t(cnt), _t(fl), _t(va), _t(rs), _t(n_ev))
    ref = jdr.run_index_scan(jnp.asarray(cnt), jnp.asarray(fl),
                             jnp.asarray(va & live), jnp.asarray(rs & live))
    assert _eq(got.numpy()[live], np.asarray(ref)[live])


def test_torch_vlc_code_word_and_update():
    """Random states, including count 128 halvings, es wrapping through
    0xFFFF, k = 16 and escapes; and the zero carry (all states 0)."""
    rng = np.random.default_rng(11)
    n = 4000
    v0 = rng.integers(-128, 128, n).astype(np.int32)
    count = rng.integers(1, 129, n).astype(np.int32)
    count[:500] = 128
    drift = -rng.integers(0, 129, n).astype(np.int32)
    es = rng.integers(0, 1 << 16, n).astype(np.int32)
    es[500:600] = 0
    es[600:700] = 0xFFFF
    count[600:700] = 1
    bias = rng.integers(-128, 128, n).astype(np.int32)
    st = [drift, es, bias, count]
    st = [np.concatenate([a, np.zeros(16, np.int32)]) for a in st]
    v0 = np.concatenate([v0, rng.integers(-128, 128, 16).astype(np.int32)])
    got = rice.vlc_code_word(_t(v0), *[_t(a) for a in st], 8)
    ref = jdr.vlc_code_word(jnp.asarray(v0), *[jnp.asarray(a) for a in st],
                            8)
    for a, b in zip(got, ref):
        assert _eq(a, b)
    assert int(got[0].max()) == 20                  # escape: 12 + bits
    got_u = rice.vlc_update(*[_t(a) for a in st], got[2])
    ref_u = jdr.vlc_update(*[jnp.asarray(a) for a in st], ref[2])
    for a, b in zip(got_u, ref_u):
        assert _eq(a, b)


def test_torch_rice_elements_and_assemble_bits():
    """A real frame's streams and ladder fields, random vlc codes."""
    rng = np.random.default_rng(5)
    planes = [synth_plane(rng, 2, 8, 41), synth_plane(rng, 2, 4, 21),
              synth_plane(rng, 2, 4, 21)]
    ct = [_t(c) for c, _ in planes], [_t(d) for _, d in planes]
    cj = ([jnp.asarray(c) for c, _ in planes],
          [jnp.asarray(d) for _, d in planes])
    st_t = rice.build_rice_streams(*ct)
    st_j = jdr.build_rice_streams(*cj)
    npix = st_t["lad"].shape[1]
    for ev_cap in (npix, 40):                        # 40: events dropped
        got = rice.ladder_fields(st_t, ev_cap)
        ref = jdr.ladder_fields(st_j, ev_cap)
        for a, b in zip(got, ref):
            assert _eq(a, b)
    ones, term_j, rem, _ = rice.ladder_fields(st_t, npix)
    codes = rng.integers(0, 1 << 17, (2, npix)) | (
        rng.integers(1, 29, (2, npix)) << 18)
    codes = np.where(st_t["payload"].numpy() >> 12 & 1, 0, codes)
    codes = codes.astype(np.int32)
    lens, vals = rice.rice_elements(st_t, _t(codes), ones, term_j, rem)
    rj = jdr.rice_elements(st_j, jnp.asarray(codes), jnp.asarray(ones),
                           jnp.asarray(term_j), jnp.asarray(rem))
    assert _eq(lens, rj[0]) and _eq(vals, rj[1])
    nbits = int(lens.sum(1).max())
    for nwords in (nbits // 32 + 2, nbits // 64):   # fits; spills over
        got = rice.assemble_bits(lens, vals, nwords)
        ref = jdr.assemble_bits(rj[0], rj[1], nwords)
        assert _eq(got[0], ref[0]) and _eq(got[1], ref[1])


# ---------------------------------------------------------------------------
# the stages on a real 48x32 yuv420p plan (test_device_rice.py:224)

W48, H48 = 48, 32
CFG = FFV1Config(level=3, coder=0, slices=4)


@pytest.fixture(scope="module")
def real48():
    rng = np.random.default_rng(23)
    planes = [rng.integers(0, 256, (H48, W48)).astype(np.int32),
              rng.integers(0, 256, (H48 // 2, W48 // 2)).astype(np.int32),
              rng.integers(0, 256, (H48 // 2, W48 // 2)).astype(np.int32)]
    dev = jdc.DeviceFFV1Encoder(W48, H48, "yuv420p", CFG, use_pallas=False)
    ctx, streams = dev._phase_a_rice([jnp.asarray(p) for p in planes])
    plan = dev._s_rice_layout(ctx, streams["payload"], dev.tiles_cap,
                              dev.cellrows_cap)
    ch1c, ch2c = dev._s_scatter(plan, dev.cellrows_cap)
    vrng = np.random.RandomState(4)
    rows = dev.vcanon.shape[0]
    vcanon = np.stack([-vrng.randint(0, 129, rows),
                       vrng.randint(0, 1 << 16, rows),
                       vrng.randint(-128, 128, rows),
                       vrng.randint(1, 129, rows)], 1).astype(np.int32)
    s0 = jdr.build_vlc_s0(plan, jnp.asarray(vcanon), dev.tiles_cap)
    args = (ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
            s0)
    ref = jdr.vlc_adapt_reference(*args, dev.tiles_cap, 8)
    pal = jdr.vlc_adapt_pallas(*args, dev.tiles_cap, int(ch1c.shape[0]), 8,
                               interpret=True)
    j = dict(planes=planes, ctx=ctx, streams=streams, plan=plan, ch1c=ch1c,
             ch2c=ch2c, vcanon=vcanon, s0=s0, ref=ref, pal=pal,
             wb=jdr.writeback_vlc(plan, jnp.asarray(vcanon), ref[1],
                                  dev.tiles_cap),
             tiles_cap=dev.tiles_cap, cellrows_cap=dev.cellrows_cap)
    return {k: (jax_tree_np(v)) for k, v in j.items()}


def jax_tree_np(v):
    if isinstance(v, dict):
        return {k: np.asarray(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return type(v)(np.asarray(x) for x in v)
    return v if isinstance(v, int) else np.asarray(v)


@pytest.fixture(scope="module")
def port48(real48):
    enc = DeviceFFV1Encoder(W48, H48, "yuv420p", CFG, device="cpu").banks[0]
    enc.caps.tiles_cap, enc.caps.cellrows_cap = (real48["tiles_cap"],
                                                 real48["cellrows_cap"])
    ctx, streams = enc.phase_a_rice([_t(p) for p in real48["planes"]])
    plan = enc.layout(ctx, streams["payload"], enc.caps.tiles_cap,
                      enc.caps.cellrows_cap, rice.PAYLOAD_BITS + 1)
    ch1c, ch2c = place(plan, enc.caps.cellrows_cap)
    return dict(enc=enc, ctx=ctx, streams=streams, plan=plan, ch1c=ch1c,
                ch2c=ch2c)


def test_torch_rice_phase_a_layout_place(real48, port48):
    assert _eq(port48["ctx"], real48["ctx"])
    for k, v in real48["streams"].items():
        assert _eq(port48["streams"][k], v), k
    for k, v in real48["plan"].items():
        assert _eq(port48["plan"][k], v), k
    assert _eq(port48["ch1c"], real48["ch1c"])
    assert _eq(port48["ch2c"], real48["ch2c"])


def test_torch_vlc_s0_and_writeback(real48, port48):
    tc = real48["tiles_cap"]
    s0 = rice.build_vlc_s0(port48["plan"], _t(real48["vcanon"]), tc)
    assert _eq(s0, real48["s0"])
    wb = rice.writeback_vlc(port48["plan"], _t(real48["vcanon"]),
                            _t(real48["ref"][1]), tc)
    assert _eq(wb, real48["wb"])


def test_torch_vlc_adapt_plain(real48, port48):
    """vlc_adapt_plain == vlc_adapt_reference == the Pallas kernel
    (interpret mode), code cells and live tiles' end states."""
    p = port48["plan"]
    s0 = _t(real48["s0"])
    _build.reset_counts()
    code, ends = vlc_adapt(port48["ch1c"], p["tile_caps"], p["tile_bases"],
                           p["tile_pred"], s0, 8)
    k = _build.KERNELS["vlc"]
    assert k.plain_calls == 1 and k.launches == 0
    nrows = int(p["n_rows"])
    nt = int(p["n_tiles"])
    for ref_code, ref_ends in (real48["ref"], real48["pal"]):
        assert _eq(code[:nrows], ref_code[:nrows])
        assert _eq(ends[:nt], ref_ends[:nt])
    assert not code[nrows:].any()
    assert _eq(ends, real48["ref"][1])


def test_torch_vlc_adapt_plain_zero_carry(monkeypatch, real48, port48):
    """A successor tile whose predecessor has cap 0 loads a zero carry (not
    VLC_INIT), as the Pallas kernel's untouched carry slot (interpret
    mode); GCAP 16 splits the 48x32 frame's groups.  The emptied tile's
    rows belong to no tile, so only the other tiles' rows compare."""
    monkeypatch.setattr(host, "GCAP", 16)
    monkeypatch.setattr(jdc, "GCAP", 16)
    enc = DeviceFFV1Encoder(W48, H48, "yuv420p", CFG, device="cpu").banks[0]
    s = port48["streams"]
    tiles_cap, cellrows_cap = 256, 4096
    plan = enc.layout(port48["ctx"], s["payload"], tiles_cap, cellrows_cap,
                      rice.PAYLOAD_BITS + 1)
    jplan = jdc.layout_plan(
        jnp.asarray(enc.class_off_stream.numpy())[None, :]
        + jnp.asarray(port48["ctx"].numpy()),
        jnp.asarray(s["payload"].numpy()), enc.rows_per_slice,
        tiles_cap * 128, tiles_cap, payload_bits=rice.PAYLOAD_BITS + 1)
    pred = plan["tile_pred"]
    assert (pred >= 0).any()
    caps = plan["tile_caps"].clone()
    caps[int(pred[pred >= 0][0])] = 0
    ch1c, _ = place(plan, cellrows_cap)
    s0 = rice.build_vlc_s0(plan, _t(real48["vcanon"]), tiles_cap)
    got = vlc_adapt_plain(ch1c, caps, plan["tile_bases"], pred, s0, 8)
    jch1 = jnp.zeros(cellrows_cap * 128, jnp.int32).at[jplan["dest"]].set(
        jplan["ch1"], mode="drop").reshape(cellrows_cap, 128)
    ref = jdr.vlc_adapt_pallas(jch1, jnp.asarray(caps.numpy()),
                               jplan["tile_bases"], jplan["tile_pred"],
                               jnp.asarray(s0.numpy()), tiles_cap,
                               cellrows_cap, 8, interpret=True)
    rows = torch.cat([torch.arange(b, b + c) for b, c in
                      zip(plan["tile_bases"].tolist(), caps.tolist())
                      if c > 0])
    assert _eq(got[0][rows], np.asarray(ref[0])[rows.numpy()])
    assert _eq(got[1], ref[1])


# ---------------------------------------------------------------------------
# the whole encoder (test_device_rice.py:182-221 frames)

def _shapes(p, w, h):
    shapes = [(h, w)]
    if p.chroma_planes:
        shapes += [(h >> p.chroma_v_shift, w >> p.chroma_h_shift)] * 2
    return shapes


def _frames(p, w, h):
    rng = np.random.default_rng(13)
    mx = (1 << p.bits) - 1
    out = []
    for t in range(4):
        if t == 1:
            planes = [np.full(s, 42, np.int64) for s in _shapes(p, w, h)]
        elif t == 2:
            planes = []
            for s in _shapes(p, w, h):
                pl_ = np.full(s, 17, np.int64)
                pl_[:: max(1, s[0] // 3)] = 99
                planes.append(pl_)
        else:
            planes = [rng.integers(0, mx + 1, s).astype(np.int64)
                      for s in _shapes(p, w, h)]
        out.append(planes)
    return out


@pytest.fixture(scope="module", params=[("yuv420p", (64, 48)),
                                        ("gray", (48, 32))],
                ids=["yuv420p", "gray"])
def jax_rice(request):
    """The JAX encoder (its XLA reference path) over the 4 frames, with its
    vcanon after frame 0."""
    pix, (w, h) = request.param
    p = params_from_config(CFG, pix, w, h)
    frames = _frames(p, w, h)
    jenc = jdc.DeviceFFV1Encoder(w, h, pix, CFG, use_pallas=False)
    pkts, vcanon = [], None
    for t, planes in enumerate(frames):
        pkts.append(jenc.encode(planes, force_keyframe=(t == 0)))
        if t == 0:
            vcanon = np.asarray(jenc.vcanon).copy()
            picture_number = jenc.picture_number
    return dict(pix=pix, w=w, h=h, p=p, frames=frames, pkts=pkts,
                vcanon=vcanon, picture_number=picture_number,
                vcanon_end=np.asarray(jenc.vcanon))


def test_torch_rice_encoder_matches_native_and_jax(jax_rice):
    w, h, pix = jax_rice["w"], jax_rice["h"], jax_rice["pix"]
    enc = DeviceFFV1Encoder(w, h, pix, CFG, device="cpu")
    nat = NativeFFV1Codec(jax_rice["p"])
    for t, planes in enumerate(jax_rice["frames"]):
        a = enc.encode(planes, force_keyframe=(t == 0))
        assert a == nat.encode(planes, t == 0), f"frame {t} vs native"
        assert a == jax_rice["pkts"][t], f"frame {t} vs JAX"
        if t == 0:
            assert _eq(enc.state(), jax_rice["vcanon"])
    assert _eq(enc.state(), jax_rice["vcanon_end"])


def test_torch_rice_state_handoff(jax_rice):
    """JAX codes the keyframe; its vcanon continues in the port."""
    w, h, pix = jax_rice["w"], jax_rice["h"], jax_rice["pix"]
    enc = DeviceFFV1Encoder(w, h, pix, CFG, device="cpu")
    enc.load_state(jax_rice["vcanon"], jax_rice["picture_number"])
    assert enc.picture_number == 1
    assert enc.encode(jax_rice["frames"][1]) == jax_rice["pkts"][1]
    with pytest.raises(ValueError):
        enc.load_state(jax_rice["vcanon"].astype(np.uint8), 1)


@pytest.mark.parametrize("level,slices,gcap", [(3, 4, 64), (3, 4, 16),
                                               (1, 1, 4096), (4, 4, 4096)])
def test_torch_rice_encoder_split_groups_and_versions(monkeypatch, level,
                                                      slices, gcap):
    """Small GCAPs split the large context groups into sub-lanes whose
    VlcStates carry from tile to tile (the vlc walk's successor chain);
    levels 1 and 4 take the v0/v1 keyframe header and the v4 slice header
    into the rice slice's range-coded prefix."""
    monkeypatch.setattr(host, "GCAP", gcap)
    w, h = 64, 48
    cfg = FFV1Config(level=level, coder=0, slices=slices)
    p = params_from_config(cfg, "yuv420p", w, h)
    enc = DeviceFFV1Encoder(w, h, "yuv420p", cfg, device="cpu")
    nat = NativeFFV1Codec(p)
    rng = np.random.RandomState(3)
    _build.reset_counts()
    for t in range(4):
        planes = []
        for (hh, ww) in _shapes(p, w, h):
            yy, xx = np.mgrid[0:hh, 0:ww]
            pl_ = ((xx // 8 * 8 + t * 5) % 256).astype(np.int32)
            if t != 2:
                mask = rng.rand(hh, ww) < 0.05
                pl_ = np.where(mask, rng.randint(0, 256, (hh, ww)), pl_)
            planes.append(pl_.astype(np.int32))
        key = t % 3 == 0
        assert enc.encode(planes, force_keyframe=key) == nat.encode(planes,
                                                                    key)
    for name in enc.kernels:
        k = _build.KERNELS[name]
        assert k.launches == 0 and k.plain_calls > 0, name
