"""Each stage of the PyTorch port's device coder equals its JAX original.

The inputs come from a 64x48 yuv420p, 4-slice frame run through the JAX
package's own stages (its XLA reference path, as
tests/test_device_coder.py runs it on the CPU); every stage of the port
gets the same inputs and must give equal integers.  On CPU tensors each
kernel wrapper runs its plain PyTorch version.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu.ffv1.expand_pallas import expand_ops_reference
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu.ffv1.tpu_coder import rac_scan_lanes as jax_rac_scan
from ffmpeg_ffv2_tpu_torch.ffv1 import device_coder as tdc
from ffmpeg_ffv2_tpu_torch.ffv1 import host
from test_torch_formats import torch_one_thread  # noqa: F401
from test_torch_place_tables import lane_walk
from ffmpeg_ffv2_tpu_torch.ffv1.adapt import adapt
from ffmpeg_ffv2_tpu_torch.ffv1.expand import expand
from ffmpeg_ffv2_tpu_torch.ffv1.rac import (rac_render, rac_scan_lanes,
                                            render_bytes)
from ffmpeg_ffv2_tpu_torch.ops.place import TABLE_KEYS, place, scatter_cells

W, H = 64, 48
CFG = FFV1Config(level=3, coder=1, slices=4)


def np_(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def t_(x):
    return torch.as_tensor(np.array(x))


def _frame(seed):
    """Gradient + sparse noise: a few large context groups (which split
    at a small GCAP) next to many small ones."""
    rng = np.random.RandomState(seed)
    planes = []
    for (hh, ww) in ((H, W), (H // 2, W // 2), (H // 2, W // 2)):
        yy, xx = np.mgrid[0:hh, 0:ww]
        pl = (xx // 8 * 8 + yy).astype(np.int32) % 256
        mask = rng.rand(hh, ww) < 0.3
        planes.append(np.where(mask, rng.randint(0, 256, (hh, ww)),
                               pl).astype(np.int32))
    return planes


@pytest.fixture(scope="module", params=[4096, 64], ids=["gcap4096",
                                                        "gcap64"])
def stages(request):
    """The JAX stages' inputs and outputs for one keyframe; GCAP 64
    splits the large groups, so tiles carry states to successors."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdc, "GCAP", request.param)
        mp.setattr(host, "GCAP", request.param)
        yield _run_jax_stages()


def _run_jax_stages():
    jenc = jdc.DeviceFFV1Encoder(W, H, "yuv420p", CFG, use_pallas=False)
    planes = [jnp.asarray(pl) for pl in _frame(9)]
    ctx, diff = jenc._phase_a(planes)
    tiles_cap, cellrows_cap = jenc.tiles_cap, jenc.cellrows_cap
    row_local = jnp.asarray(jenc.class_off_stream)[None, :] + ctx
    raw_plan = jdc.layout_plan(row_local, diff, jenc.rows_per_slice,
                               tiles_cap * 128, tiles_cap)
    if int(raw_plan["n_rows"]) + 1024 > cellrows_cap:
        # the encoder would redo this frame with larger caps
        tiles_cap, cellrows_cap = jenc.tiles_max, jenc.cellrows_max
        raw_plan = jdc.layout_plan(row_local, diff, jenc.rows_per_slice,
                                   tiles_cap * 128, tiles_cap)
    assert int(raw_plan["n_tiles"]) <= tiles_cap
    plan = jenc._s_layout_impl(ctx, diff, tiles_cap, cellrows_cap)
    ch1c, ch2c = jdc.scatter_cells(plan, cellrows_cap)
    rng = np.random.RandomState(1)
    canon = jnp.asarray(rng.randint(1, 256, (jenc.n_chain_rows + 1, 32))
                        .astype(np.uint8))
    s0 = jdc.build_s0_blocks(plan, canon, tiles_cap)
    table = jnp.asarray(jenc.table)
    sv, ends = jdc.adapt_reference(ch1c, plan["tile_caps"],
                                   plan["tile_bases"], plan["tile_pred"], s0,
                                   table, tiles_cap, code_bits=8)
    diff_c = (ch1c & 0xFFF) - 2048
    ev = jdc.repack_emission_order(sv, diff_c, 8, 3)
    canon2 = jdc.writeback_canonical(plan, canon, ends, tiles_cap)
    words, maxc = jenc._s_unsort_impl(ev, ch1c, ch2c, jenc.S, cellrows_cap)
    svp, btp, hlen = jenc.prefix[True]
    opw, n_ops = expand_ops_reference(words, diff, svp, btp, hlen,
                                      jenc.op_cap_max, 8)
    return dict(jenc=jenc, tiles_cap=tiles_cap, cellrows_cap=cellrows_cap,
                ctx=ctx, diff=diff, row_local=row_local,
                raw_plan=raw_plan, plan=plan, ch1c=ch1c, ch2c=ch2c,
                canon=canon, s0=s0, table=table, sv=sv, ends=ends,
                diff_c=diff_c, ev=ev, canon2=canon2, words=words, maxc=maxc,
                svp=svp, btp=btp, hlen=hlen, opw=opw, n_ops=n_ops)


def _tplan(st):
    return {k: t_(v) for k, v in st["plan"].items()}


def test_torch_layout_plan(stages):
    tiles_cap = stages["tiles_cap"]
    got = tdc.layout_plan(t_(stages["row_local"]), t_(stages["diff"]),
                          stages["jenc"].rows_per_slice, tiles_cap * 128,
                          tiles_cap)
    ref = stages["raw_plan"]
    assert set(got) == set(ref) | set(TABLE_KEYS)
    for k in ref:
        assert got[k].dtype == torch.int32, k
        assert np.array_equal(np_(got[k]), np_(ref[k])), k
    if host.GCAP == 64:
        assert (np_(ref["tile_pred"]) >= 0).any()


def test_torch_scatter_cells(stages):
    """scatter_cells on JAX's plan, and place (its CPU path) and the lane
    walk from K1's slot tables on the port's plan, equal JAX's cells."""
    plan = _tplan(stages)
    cellrows_cap, tiles_cap = stages["cellrows_cap"], stages["tiles_cap"]
    port = tdc.layout_plan(t_(stages["row_local"]), t_(stages["diff"]),
                           stages["jenc"].rows_per_slice, tiles_cap * 128,
                           tiles_cap)
    for ch1c, ch2c in (scatter_cells(plan["dest"], plan["ch1"],
                                     plan["orig"], cellrows_cap),
                       place(port, cellrows_cap),
                       lane_walk(port, cellrows_cap)):
        assert np.array_equal(np_(ch1c), np_(stages["ch1c"]))
        assert np.array_equal(np_(ch2c), np_(stages["ch2c"]))


def test_torch_build_s0_blocks(stages):
    got = tdc.build_s0_blocks(_tplan(stages), t_(stages["canon"]),
                              stages["tiles_cap"], t_(host.SLOT_AT_ROW).long())
    assert np.array_equal(np_(got), np_(stages["s0"]))


def test_torch_adapt_row_scan(stages):
    plan = _tplan(stages)
    sv, ends = adapt(t_(stages["ch1c"]), plan["tile_caps"],
                     plan["tile_bases"], plan["tile_pred"], t_(stages["s0"]),
                     t_(stages["table"]), 8)
    assert np.array_equal(np_(sv), np_(stages["sv"]))
    assert np.array_equal(np_(ends), np_(stages["ends"]))


@pytest.mark.parametrize("n_words", [None, 2, 3])
def test_torch_repack_emission_order(stages, n_words):
    got = tdc.repack_emission_order(t_(stages["sv"]), t_(stages["diff_c"]),
                                    8, n_words)
    ref = jdc.repack_emission_order(stages["sv"], stages["diff_c"], 8,
                                    n_words)
    assert np.array_equal(np_(got), np_(ref))


def test_torch_writeback_canonical(stages):
    got = tdc.writeback_canonical(_tplan(stages), t_(stages["canon"]),
                                  t_(stages["ends"]),
                                  stages["tiles_cap"],
                                  t_(host.ROW_OF_SLOT).long())
    assert got.dtype == torch.uint8
    assert np.array_equal(np_(got), np_(stages["canon2"]))


def test_torch_unsort(stages):
    jenc = stages["jenc"]
    words, maxc = tdc.unsort_cells(t_(stages["ev"]), t_(stages["ch1c"]),
                                   t_(stages["ch2c"]), jenc.S, jenc.npix)
    assert len(stages["words"]) == words.shape[0]
    for a, b in zip(words, stages["words"]):
        assert np.array_equal(np_(a), np_(b))
    assert int(maxc) == int(stages["maxc"])


def test_torch_expand_frame(stages):
    words = torch.stack([t_(w) for w in stages["words"]])
    opw, n_ops = expand(words, t_(stages["diff"]), t_(stages["svp"]),
                        t_(stages["btp"]), t_(stages["hlen"]),
                        stages["jenc"].op_cap_max)
    assert np.array_equal(np_(opw), np_(stages["opw"]))
    assert np.array_equal(np_(n_ops), np_(stages["n_ops"]))


def _cut_ops(stages, n=1024):
    """The frame's first n op steps per slice, ending in the tail ops so
    the terminator and both flushes run too."""
    opw = np_(stages["opw"])[:, :n].copy()
    opw[:, -3:] = [(1 << 9) | 129, 2 << 9, 3 << 9]
    return opw


def test_torch_rac_scan_lanes(stages):
    """The plain coder == tpu_coder.rac_scan_lanes."""
    opT = _cut_ops(stages).T
    args = (opT & 0xFF, (opT >> 8) & 1, (opT >> 9) & 3)
    got = rac_scan_lanes(*(t_(a) for a in args))
    ref = jax_rac_scan(*(jnp.asarray(a) for a in args))
    for a, b in zip(got, ref):
        assert np.array_equal(np_(a), np_(b))


def test_torch_rac_render_plain(stages):
    """K4's plain version (coder + render) == the JAX coder followed by
    render_bytes_fast."""
    opw = _cut_ops(stages)
    by, ln = rac_render(t_(opw), opw.shape[1], 4096)
    opT = jnp.asarray(opw.T)
    f, c, v = jax_rac_scan(opT & 0xFF, (opT >> 8) & 1, (opT >> 9) & 3)
    rby, rln, _ = jdc.render_bytes_fast(f.T, c.T, v.T, 4096)
    assert int(rln.max()) <= 4096
    assert np.array_equal(np_(ln), np_(rln))
    assert np.array_equal(np_(by), np_(rby))


def _staged(seed, S, steps, p_emit, long_run=None):
    rng = np.random.RandomState(seed)
    emit = rng.rand(S, steps) < p_emit
    emit[:, steps - 1] = True
    first = np.where(emit, rng.randint(0, 256, (S, steps)), -1)
    fcount = np.where(emit, rng.randint(0, 5, (S, steps)), 0)
    if long_run is not None:
        fcount[0, np.nonzero(emit[0])[0][0]] = long_run
    fval = np.where(rng.rand(S, steps) < 0.5, 0xFF, 0)
    return [a.astype(np.int32) for a in (first, fcount, fval)]


@pytest.mark.parametrize("p_emit,long_run", [(0.3, 900), (0.9, None),
                                             (0.05, 1023)])
def test_torch_render_matches_render_fast(p_emit, long_run):
    args = _staged(17, 3, 2048, p_emit, long_run)
    buf_cap = 4096
    by, ln = render_bytes(*(t_(a) for a in args), buf_cap)
    rby, rln, _ = jdc.render_bytes_fast(*(jnp.asarray(a) for a in args),
                                        buf_cap)
    assert np.array_equal(np_(ln), np_(rln))
    for s in range(3):
        if int(rln[s]) <= buf_cap:
            assert np.array_equal(np_(by)[s], np_(rby)[s]), s


def test_torch_render_long_fill_run():
    """A fill run past the 1023 cap of render_bytes_fast's field ==
    render_bytes, which has no cap."""
    args = _staged(4, 3, 700, 0.25, long_run=3000)
    buf_cap = 8192
    by, ln = render_bytes(*(t_(a) for a in args), buf_cap)
    rby, rln = jdc.render_bytes(*(jnp.asarray(a) for a in args), buf_cap)
    assert int(rln[0]) > 3000 and int(rln.max()) <= buf_cap
    assert np.array_equal(np_(ln), np_(rln))
    assert np.array_equal(np_(by), np_(rby))


@pytest.mark.parametrize("op_cap", [None, 6000])
def test_torch_expand_prefix_mix(op_cap):
    """Random sv words and a diff mix with a header-length mix, against
    expand_ops_reference (as tests/test_device_coder.py:365-378 does for
    the TPU kernel); op_cap 6000 cuts the slices' op streams."""
    rng = np.random.RandomState(3)
    S, npix, half = 3, 1500, 128
    Wn = host.n_ev_words(8)
    diff = rng.randint(-half, half, (S, npix))
    diff[:, :300] = 0
    diff[1, 400:800] = rng.randint(-3, 4, 400)
    diff = diff.astype(np.int32)
    words = rng.randint(-2 ** 31, 2 ** 31 - 1, (Wn, S, npix),
                        dtype=np.int64).astype(np.int32)
    hpad = 40
    svp = rng.randint(0, 256, (S, hpad)).astype(np.int32)
    btp = rng.randint(0, 2, (S, hpad)).astype(np.int32)
    hlen = np.array([40, 17, 33], np.int32)
    k_max = host.k_max_for_bits(8)
    if op_cap is None:
        op_cap = -(-(npix * k_max + hpad + 8) // 4096) * 4096
    ref, rn = expand_ops_reference([jnp.asarray(w) for w in words],
                                   jnp.asarray(diff), jnp.asarray(svp),
                                   jnp.asarray(btp), jnp.asarray(hlen),
                                   op_cap, 8)
    got, n = expand(t_(words), t_(diff), t_(svp), t_(btp), t_(hlen), op_cap)
    assert np.array_equal(np_(n), np_(rn))
    assert np.array_equal(np_(got), np_(ref))
