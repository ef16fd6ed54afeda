"""The PyTorch port's CUDA kernels on the card: each kernel equals its plain
PyTorch version (phase A's kernel on every format, shape banks and crop
edges, once a frame, a bank or a batch frame, ``-k phase_a``), and the
encoder's packets equal NativeFFV1Codec's (the
port's own copy), for the range and the Golomb-Rice coder, deep and RGB
formats, shape banks, the emission_pack kernel and the emission-order walk
(K6), and for encode_batch; a two-bank frame synchronizes only in its
upload and its four reads; the row sort (K8, K9) and the tool kernels
(K10-K17) equal their plain versions, the device conversions equal
their numpy models, FFV2's K18 and K19 equal their plain versions and
a 1080p FFV2 packet and its decode equal the host path's, and the
multi-device encoder on a 2-rank gloo world sharing the card equals the
single-device port (``-k parallel``); the CLI on the card (``-k cli``):
FFV1's backends, FFV2's packets and decode against the host path, and
``--mesh 2x2`` (4 gloo ranks sharing the card) and ``--mesh 1x1`` (one
NCCL rank) against the single-device CLI's file.

Needs an NVIDIA GPU and nvcc; skips itself elsewhere.  The machine with
the card has no jax, so run this file without the repository's
conftest.py (which imports jax):

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import dataclasses
import os
import sys
import warnings

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ffmpeg_ffv2_tpu_torch import _build  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1 import adapt as ad  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1 import device_coder as dc  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1 import expand as ex  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1 import host  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1 import phase_a as pa  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1 import rac  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1 import rice  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1 import tpu_coder as tc  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1 import tpu_encoder as te  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1 import vlc  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1.rct import RCT_Y_COEFF  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ffv1.params import (  # noqa: E402
    CODER_GOLOMB, FFV1Config, params_from_config)
from ffmpeg_ffv2_tpu_torch.ops import place as pl  # noqa: E402
from ffmpeg_ffv2_tpu_torch.ops import sort  # noqa: E402
from ffmpeg_ffv2_tpu_torch.tools import microbench_prims as mp  # noqa: E402
from ffmpeg_ffv2_tpu_torch.tools import probes  # noqa: E402
from ffmpeg_ffv2_tpu_torch.utils.metrics import StageTrace  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")


def _shapes(p, w, h):
    if p.colorspace == 1:
        return [(h, w)] * (3 + p.transparency)
    return [(h, w)] + ([(-(-h >> p.chroma_v_shift), -(-w >> p.chroma_h_shift))]
                       * 2 if p.chroma_planes else [])


def _frame(p, w, h, t, rng, sparse):
    planes = []
    shapes = _shapes(p, w, h)
    for (hh, ww) in shapes:
        if sparse:
            yy, xx = np.mgrid[0:hh, 0:ww]
            pl_ = ((xx // 8 * 8 + t * 5) % 256).astype(np.int32)
            mask = rng.rand(hh, ww) < 0.05
            planes.append(np.where(mask, rng.randint(0, 256, (hh, ww)),
                                   pl_).astype(np.int32))
        else:
            planes.append(rng.randint(0, (1 << p.bits), (hh, ww))
                          .astype(np.int32))
    return planes


@pytest.mark.parametrize("pix,coder,gcap,sparse", [
    ("yuv420p", 1, 4096, False), ("yuv420p", -2, 4096, False),
    ("gray", 1, 4096, False), ("yuv420p", 1, 64, True),
    ("yuv420p", 1, 4096, True), ("yuv420p", 0, 4096, False),
    ("gray", 0, 4096, False), ("yuv420p", 0, 64, True),
    ("yuv420p", 0, 4096, True)])
def test_torch_gpu_encoder_matches_native(monkeypatch, pix, coder, gcap,
                                          sparse):
    monkeypatch.setattr(host, "GCAP", gcap)
    w, h = 128, 96
    cfg = FFV1Config(level=3, coder=coder, slices=4)
    p = params_from_config(cfg, pix, w, h)
    enc = dc.DeviceFFV1Encoder(w, h, pix, cfg, device="cuda")
    nat = NativeFFV1Codec(p)
    rng = np.random.RandomState(7)
    _build.reset_counts()
    for t in range(4):
        planes = _frame(p, w, h, t, rng, sparse)
        key = t % 3 == 0
        assert enc.encode(planes, force_keyframe=key) == nat.encode(planes,
                                                                    key)
    for name in enc.kernels:
        k = _build.KERNELS[name]
        assert k.launches > 0 and k.plain_calls == 0, name


def test_torch_gpu_kernels_match_plain(monkeypatch):
    """K1-K4 against their plain versions, on the card, on every input of
    a small split-group frame."""
    monkeypatch.setattr(host, "GCAP", 64)
    w, h = 128, 96
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "yuv420p", w, h)
    enc = dc.DeviceFFV1Encoder(w, h, "yuv420p", cfg, device="cuda")
    bank = enc.banks[0]
    planes = _frame(p, w, h, 0, np.random.RandomState(5), True)
    enc.encode(planes, force_keyframe=True)             # settles the caps
    dev = [torch.as_tensor(x, device="cuda") for x in planes]
    ctx, diff = bank.phase_a(dev)
    plan = bank.layout(ctx, diff, bank.caps.tiles_cap, bank.caps.cellrows_cap)
    assert (plan["tile_pred"] >= 0).any()

    ch1c, ch2c = pl.place(plan, bank.caps.cellrows_cap)
    for a, b in zip((ch1c, ch2c), pl.scatter_cells(
            plan["dest"], plan["ch1"], plan["orig"], bank.caps.cellrows_cap)):
        assert torch.equal(a, b)

    rng = np.random.RandomState(2)
    canon = torch.as_tensor(rng.randint(1, 256, bank.canonical.shape)
                            .astype(np.uint8), device="cuda")
    s0 = dc.build_s0_blocks(plan, canon, bank.caps.tiles_cap, bank.slot_at_row)
    k2 = (ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
          s0, bank.table)
    for a, b in zip(ad.adapt(*k2, 8), ad.adapt_plain(*k2)):
        assert torch.equal(a, b)

    sv, _ = ad.adapt(*k2, 8)
    ev = dc.repack_emission_order(sv, (ch1c & 0xFFF) - 2048, 8, 5)
    words, _ = dc.unsort_cells(ev, ch1c, ch2c, bank.S, bank.npix)
    svp, btp, hlen = bank.prefix[True]
    for op_cap in (bank.caps.op_cap_max, 4096):
        k3 = (words, diff, svp, btp, hlen, op_cap)
        for a, b in zip(ex.expand(*k3), ex.expand_plain(*k3)):
            assert torch.equal(a, b)

    opw, n_ops = ex.expand(words, diff, svp, btp, hlen, bank.caps.op_cap_max)
    steps = int(n_ops.max())
    for buf_cap in (1 << 16, 512):                       # 512 cuts rows
        a_by, a_ln = rac.rac_render(opw, steps, buf_cap)
        b_by, b_ln = rac.rac_render_plain(opw, steps, buf_cap)
        assert torch.equal(a_ln, b_ln)
        for s in range(bank.S):
            n = min(int(a_ln[s]), buf_cap)
            assert torch.equal(a_by[s, :n], b_by[s, :n])
            assert not a_by[s, n:].any()


def _poison(n):
    """Free two blocks of n int32 words holding -7 into the caching
    allocator, so that the outputs the next call allocates at that size
    show any word its kernel leaves unwritten."""
    blocks = [torch.full((n,), -7, dtype=torch.int32, device="cuda")
              for _ in range(2)]
    del blocks


def _expand_inputs(W, npix, seed):
    """K3 inputs of 4 slices: coding-depth-17 diffs (|d| up to 2^17 - 1,
    so up to 35 ops a pixel) with zeros, an all-zero slice (1 op a
    pixel), small diffs; random sv words; hlen 0, hpad, 5 and 1."""
    rng = np.random.RandomState(seed)
    S, hpad = 4, 16
    e = rng.randint(0, 17, (S, npix))
    mag = (1 << e) | (rng.randint(0, 1 << 30, e.shape) & ((1 << e) - 1))
    diff = np.where(rng.rand(S, npix) < 0.5, -mag, mag)
    diff = np.where(rng.rand(S, npix) < 0.2, 0, diff)
    diff[0, :3] = (1 << 17) - 1, -((1 << 17) - 1), 0
    diff[1] = 0
    diff[3] = rng.randint(-3, 4, npix)
    words = rng.randint(-2 ** 31, 2 ** 31, (W, S, npix), dtype=np.int64)
    svp = rng.randint(0, 256, (S, hpad))
    btp = rng.randint(0, 2, (S, hpad))
    hlen = np.array([0, hpad, 5, 1])
    return [torch.as_tensor(x.astype(np.int32), device="cuda")
            for x in (words, diff, svp, btp, hlen)]


@pytest.mark.parametrize("W,npix", [(1, 2500), (2, 700), (9, 2500),
                                    (9, 2048)])
def test_torch_gpu_expand_matches_plain(W, npix):
    """K3 against expand_plain, element for element: W = 1, 2 and 9 sv
    words, npix below, past and at a multiple of the kernel's 1024-pixel
    chunk; op_cap with room for every op, inside a pixel's ops, at the
    first op of slice 0's second chunk, and not a multiple of 4."""
    words, diff, svp, btp, hlen = _expand_inputs(W, npix, W * npix)
    base, total = ex.op_bases(diff, svp.shape[1])
    counts = ex.event_count(diff)
    big = -(-(int(total.max()) + 3) // host.OP_GRAN) * host.OP_GRAN
    px = int(torch.nonzero(counts[0] >= 20)[0, 0])
    caps = [big, int(base[0, px]) + 7, big + 3]
    if npix > ex.CHUNK:
        caps.append(int(base[0, ex.CHUNK]))
    assert int(counts.max()) == 35
    k = _build.KERNELS["expand"]
    for op_cap in caps:
        _poison(diff.shape[0] * op_cap)
        before = k.launches
        got = ex.expand(words, diff, svp, btp, hlen, op_cap)
        assert k.launches == before + 1
        for a, b in zip(got, ex.expand_plain(words, diff, svp, btp, hlen,
                                             op_cap)):
            assert torch.equal(a, b), op_cap


@pytest.mark.parametrize("gcap,coder,pix", [
    (64, 1, "yuv420p"), (16, 1, "yuv420p"), (64, 0, "yuv420p"),
    (16, 0, "yuv420p16")])
def test_torch_gpu_place_layouts(monkeypatch, gcap, coder, pix):
    """K1 against scatter_cells on the encoder's own layouts: split groups
    (GCAP 64 and 16), range cells and the rice payload at pb = 12 and
    16, with the cell rows the layout needs, and half of them (layout()
    clamps the walk's tiles and the cells past the cap are dropped)."""
    monkeypatch.setattr(host, "GCAP", gcap)
    w, h = (128, 96) if gcap == 64 else (64, 48)
    cfg = FFV1Config(level=3, coder=coder, slices=4)
    p = params_from_config(cfg, pix, w, h)
    if coder == 0:
        p = dataclasses.replace(p, ac=CODER_GOLOMB)
    enc = dc.DeviceFFV1Encoder(w, h, pix, cfg, device="cuda", params=p)
    bank = enc.banks[0]
    planes = _frame(p, w, h, 0, np.random.RandomState(5), True)
    if p.bits > 8:
        planes = [x << (p.bits - 8) | x for x in planes]
    dev = [torch.as_tensor(x, device="cuda") for x in planes]
    if bank.golomb:
        assert bank.rice_pb == (16 if p.bits > 8 else 12)
        ctx, streams = bank.phase_a_rice(dev)
        field, bits = streams["payload"], bank.rice_pb + 1
    else:
        (ctx, field), bits = bank.phase_a(dev), 0
    rows = int(bank.layout(ctx, field, bank.caps.tiles_max,
                           bank.caps.cellrows_max, bits)["n_rows"])
    k = _build.KERNELS["place"]
    for cellrows_cap in (bank.caps.cellrows_max, rows, rows // 2):
        plan = bank.layout(ctx, field, bank.caps.tiles_max, cellrows_cap, bits)
        assert (plan["tile_rank0"] > 0).any()
        _poison(cellrows_cap * 128)
        before = k.launches
        got = pl.place(plan, cellrows_cap)
        assert k.launches == before + 1
        for a, b in zip(got, pl.scatter_cells(plan["dest"], plan["ch1"],
                                              plan["orig"], cellrows_cap)):
            assert torch.equal(a, b), cellrows_cap
    assert not torch.equal(plan["tile_bases"], plan["cell_bases"])
    assert ((plan["dest"] >= cellrows_cap * 128)
            & (plan["dest"] != pl.INT32_MAX)).any()


def test_torch_gpu_rac_render_long_fill_run():
    """A carry chain longer than the TPU render's 1023-byte fill field:
    the op pair (bit 1, sv 255), (bit 0, sv 255) renormalises with low in
    (0xFF00, 0x10000) every time, so the pending 0xFF run only grows."""
    steps = 4096
    ops = torch.zeros((2, steps), dtype=torch.int32)
    ops[:, 0:steps - 3:2] = (1 << 9) | (1 << 8) | 255
    ops[:, 1:steps - 3:2] = (1 << 9) | 255
    ops[1, :101] = (1 << 9) | (1 << 8) | 200
    ops[:, steps - 3:] = torch.tensor([(1 << 9) | 129, 2 << 9, 3 << 9])
    opT = ops.T
    _, fcount, _ = rac.rac_scan_lanes(opT & 0xFF, (opT >> 8) & 1,
                                      (opT >> 9) & 3)
    assert int(fcount.max()) > 2000
    for buf_cap in (1 << 14, 1000):
        a = rac.rac_render(ops.cuda(), steps, buf_cap)
        b = rac.rac_render_plain(ops, steps, buf_cap)
        assert torch.equal(a[1].cpu(), b[1])
        assert torch.equal(a[0].cpu(), b[0])


def _op_streams(lengths, op_cap, seed, tail=0):
    """Random rac op words (S, op_cap): slice s codes lengths[s] - 2 ops
    (bit and sv 1..255 at random) and its two flush ops, then NOPs; the
    last ``tail`` columns hold random op words that no step may read."""
    rng = np.random.RandomState(seed)
    ops = np.zeros((len(lengths), op_cap), np.int32)
    for s_, n in enumerate(lengths):
        ops[s_, :n - 2] = ((1 << 9) | (rng.randint(0, 2, n - 2) << 8)
                           | rng.randint(1, 256, n - 2))
        ops[s_, n - 2:n] = (2 << 9, 3 << 9)
    if tail:
        ops[:, op_cap - tail:] = ((1 << 9) | rng.randint(0, 512, (
            len(lengths), tail)))
    return torch.as_tensor(ops)


def _render_equal(ops, steps, buf_cap):
    a_by, a_ln = rac.rac_render(ops.cuda(), steps, buf_cap)
    b_by, b_ln = rac.rac_render_plain(ops, steps, buf_cap)
    assert torch.equal(a_ln.cpu(), b_ln)
    assert torch.equal(a_by.cpu(), b_by)
    return b_ln


@pytest.mark.parametrize("lengths,op_cap,tail,steps", [
    # slices 10x and more apart; steps 6 stages (of 512 ops) + 5
    ((3077, 300, 40, 2900, 1500), 3077, 0, 3077),
    # one op; and one slice of two flush ops
    ((3, 2), 8, 0, 1),
    ((3, 2), 8, 0, 3),
    # op_stride past steps, random ops beyond them; a row stride that
    # is not a multiple of 4 ops
    ((2000, 900, 17), 2600, 500, 2100),
    ((1100, 4099, 230), 4103, 0, 4099)])
def test_torch_gpu_rac_render_ragged(lengths, op_cap, tail, steps):
    """K4 against rac_render_plain on random op streams of ragged slices,
    with a buf_cap that holds every row and one that cuts the longer
    rows (their lengths still counted past it)."""
    ops = _op_streams(lengths, op_cap, sum(lengths), tail)
    full = _render_equal(ops, steps, 1 << 13)
    assert int(full.max()) < 1 << 13
    cut = max(int(full.max()) // 3, 1)
    ln = _render_equal(ops, steps, cut)
    assert int(ln.max()) > cut or int(full.max()) <= 1


def test_torch_gpu_rac_render_fill_across_stages():
    """A pending fill run that starts in one stage of the op ring (512
    ops) and ends in the next: NOPs, then from step 1000 the carry pattern
    (bit 1, sv 255), (bit 0, sv 255) for 300 steps from the coder's
    initial state, then random ops."""
    steps = 2600
    ops = _op_streams((steps, steps - 700), steps, 3)
    ops[0, :1000] = 0
    ops[0, 1000:1300:2] = (1 << 9) | (1 << 8) | 255
    ops[0, 1001:1300:2] = (1 << 9) | 255
    opT = ops[:1].T
    _, fcount, _ = rac.rac_scan_lanes(opT & 0xFF, (opT >> 8) & 1,
                                      (opT >> 9) & 3)
    at = int(fcount[:, 0].argmax())
    assert int(fcount.max()) > 100 and at > 1024
    for buf_cap in (1 << 13, 200):
        _render_equal(ops, steps, buf_cap)


def _walk_inputs(code_bits, seed):
    """Synthetic K2/K6 inputs: a split chain of 7 tiles (0 -> 1 -> ... ->
    6) whose tile 3 has cap 0, and two lone root tiles; caps mostly not
    multiples of 32; cell diffs with exponents 0..code_bits - 1 and some
    zeros, one cell in 8 not valid; random start states, continuation
    flags, and transition table."""
    rng = np.random.RandomState(seed)
    caps = np.array([70, 33, 95, 0, 64, 1, 45, 31, 100], np.int32)
    pred = np.array([-1, 0, 1, 2, 3, 4, 5, -1, -1], np.int32)
    bases = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int32)
    cellrows = int(caps.sum()) + 16
    mask, bias, vbit = host.payload_field(code_bits)
    e = rng.randint(0, code_bits, (cellrows, 128))
    mag = (1 << e) | (rng.randint(0, 1 << 30, e.shape) & ((1 << e) - 1))
    v = np.where(rng.rand(*e.shape) < 0.5, -mag, mag)
    v = np.where(rng.rand(*e.shape) < 0.1, 0, v)
    v = np.clip(v, -bias, mask - bias)
    ok = rng.rand(*e.shape) < 0.875
    ch1 = ((v + bias) & mask) | (ok.astype(np.int64) << vbit)
    s0 = rng.randint(0, 256, (len(caps), 33, 128))
    s0[:, 32] = rng.randint(-1, 2, (len(caps), 128))
    table = rng.randint(0, 256, 512).astype(np.uint8).view(np.int32)
    as_t = (lambda x: torch.as_tensor(np.ascontiguousarray(x, np.int32),
                                      device="cuda"))
    return (as_t(ch1), as_t(caps), as_t(bases), as_t(pred), as_t(s0),
            as_t(table), code_bits)


@pytest.mark.parametrize("code_bits", range(10, 18))
def test_torch_gpu_adapt_split_chain(code_bits):
    """K2 and K6 (ev_words full and 3) against their plain versions at R =
    code_bits - 10 = 0..7 on a split chain of 7 tiles with a cap-0 tile
    inside it and caps that are not multiples of 32."""
    k2 = _walk_inputs(code_bits, code_bits)
    for a, b in zip(ad.adapt(*k2), ad.adapt_plain(*k2)):
        assert torch.equal(a, b)
    for ev_words in (host.n_ev_words(code_bits), 3):
        for a, b in zip(ad.adapt_emission(*k2, ev_words),
                        ad.adapt_emission_plain(*k2, ev_words)):
            assert torch.equal(a, b), ev_words


@pytest.mark.parametrize("code_bits", range(8, 18))
def test_torch_gpu_emission_pack_matches_plain(code_bits):
    """emission_pack against both plain versions at every depth, Wk full
    and capped: on K2's slot words of the split chain (the rows past the
    tiles 0, as the repack gives them), every row equal to
    repack_emission_order (sign fill) and emission_pack (zero fill); on
    random slot words, equal to its CPU path, which zeroes the rows past
    the walked extent (16 rows here)."""
    k2 = _walk_inputs(code_bits, code_bits + 40)
    ch1c, caps, bases = k2[0], k2[1], k2[2]
    sv, _ = ad.adapt(*k2)
    diff = ad.cell_diff(ch1c, code_bits)
    rng = np.random.RandomState(code_bits)
    noise = torch.as_tensor(rng.randint(-2 ** 31, 2 ** 31 - 1, sv.shape,
                                        dtype=np.int64).astype(np.int32),
                            device="cuda")
    n = ad.walked_rows(caps, bases)
    assert n == ch1c.shape[0] - 16
    for nw in sorted({host.n_ev_words(code_bits), 3, 2}):
        for fill, plain in (("sign", ad.repack_emission_order),
                            ("zero", ad.emission_pack)):
            _build.reset_counts()
            got = ad.pack_emission(sv, ch1c, caps, bases, code_bits, nw,
                                   fill)
            assert _build.KERNELS["emission_pack"].launches == 1
            assert torch.equal(got, plain(sv, diff, code_bits, nw)), (nw,
                                                                      fill)
            got = ad.pack_emission(noise, ch1c, caps, bases, code_bits, nw,
                                   fill)
            ref = ad.pack_emission(*(t.cpu() for t in (noise, ch1c, caps,
                                                       bases)),
                                   code_bits, nw, fill)
            assert torch.equal(got.cpu(), ref), (nw, fill)
            assert (got[n:] == 0).all()


def test_torch_gpu_range_frame_runs_emission_pack(monkeypatch):
    """A CUDA DeviceFFV1Encoder range frame packs K2's words with the
    emission_pack kernel, once a walk, and never runs the plain repack
    (its counter stays 0, and the plain functions would raise); the
    packets equal the native codec's."""
    def refuse(*a, **kw):
        raise AssertionError("the plain repack ran on the card")

    monkeypatch.setattr(ad, "repack_emission_order", refuse)
    monkeypatch.setattr(ad, "emission_pack", refuse)
    w, h = 128, 96
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "yuv420p", w, h)
    enc = dc.DeviceFFV1Encoder(w, h, "yuv420p", cfg, device="cuda")
    assert "emission_pack" in enc.kernels
    nat = NativeFFV1Codec(p)
    rng = np.random.RandomState(3)
    _build.reset_counts()
    for t in range(2):
        planes = _frame(p, w, h, t, rng, True)
        assert enc.encode(planes, force_keyframe=t == 0) == nat.encode(
            planes, t == 0)
    k = _build.KERNELS["emission_pack"]
    assert k.launches == _build.KERNELS["adapt"].launches >= 2
    assert k.plain_calls == 0


def _vlc_against_plain(monkeypatch, pix, params=None):
    """K5 against its plain row scan on a small split-group frame of
    ``pix`` (Golomb-Rice, ``params`` forcing it past 8 bits), from random
    start states (zero carries included: the continuation flag of a
    successor whose predecessor tile is emptied)."""
    monkeypatch.setattr(host, "GCAP", 64)
    w, h = 128, 96
    cfg = FFV1Config(level=3, coder=0, slices=4)
    p = params or params_from_config(cfg, pix, w, h)
    enc = dc.DeviceFFV1Encoder(w, h, pix, cfg, device="cuda", params=p)
    bank = enc.banks[0]
    planes = _frame(p, w, h, 0, np.random.RandomState(5), True)
    if p.bits > 8:             # the 8-bit frame scaled to the full range
        planes = [x << (p.bits - 8) | x for x in planes]
    enc.encode(planes, force_keyframe=True)             # settles the caps
    dev = [torch.as_tensor(x, device="cuda") for x in planes]
    ctx, streams = bank.phase_a_rice(dev)
    plan = bank.layout(ctx, streams["payload"], bank.caps.tiles_cap,
                      bank.caps.cellrows_cap, bank.rice_pb + 1)
    assert (plan["tile_pred"] >= 0).any()
    ch1c, _ = pl.place(plan, bank.caps.cellrows_cap)
    rng = np.random.RandomState(2)
    vcanon = np.stack([rng.randint(-128, 1, bank.vcanon.shape[0]),
                       rng.randint(0, 1 << 16, bank.vcanon.shape[0]),
                       rng.randint(-128, 128, bank.vcanon.shape[0]),
                       rng.randint(1, 129, bank.vcanon.shape[0])], axis=1)
    s0 = rice.build_vlc_s0(plan, torch.as_tensor(vcanon.astype(np.int32),
                                                 device="cuda"),
                           bank.caps.tiles_cap)
    caps = plan["tile_caps"]
    for cut in (False, True):
        if cut:      # empty the predecessor of the first split tile
            caps = caps.clone()
            caps[plan["tile_pred"][plan["tile_pred"] >= 0][0]] = 0
        k5 = (ch1c, caps, plan["tile_bases"], plan["tile_pred"], s0)
        _build.reset_counts()
        got = vlc.vlc_adapt(*k5, p.bits)
        assert _build.KERNELS["vlc"].launches == 1
        for a, b in zip(got, vlc.vlc_adapt_plain(*k5, p.bits)):
            assert torch.equal(a, b)


def _vlc_chain_inputs(bits, seed):
    """A chain of 5 tiles (0 -> 1 -> 2 -> 3 -> 4) whose tile 2 has cap 0
    (its successor loads a zero carry), two lone tiles, caps not multiples
    of 32; tile 6's lane 5 is live in all of its 300 rows (count passes
    128 twice), its lane 7 in none; random start states (counts 0, 1, 128
    and 200 among them) and continuation flags."""
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
    ch1 = (((diff + (1 << (pb - 1))) & ((1 << pb) - 1))
           | (silent.astype(np.int64) << pb)
           | (valid.astype(np.int64) << (pb + 1)))
    s0 = np.stack([-rng.randint(0, 129, (7, 128)),
                   rng.randint(0, 1 << 16, (7, 128)),
                   rng.randint(-128, 128, (7, 128)),
                   rng.choice([0, 1, 128, 5, 77, 200], (7, 128)),
                   rng.randint(-1, 2, (7, 128))], 1)
    return [torch.as_tensor(np.ascontiguousarray(a, np.int32))
            for a in (ch1, caps, bases, pred, s0)]


@pytest.mark.parametrize("case", ["frame", "chain-pb12", "chain-pb16"])
def test_torch_gpu_vlc_matches_plain(monkeypatch, case):
    """K5 against its plain row scan: a frame's split groups (with zero
    carries), and the synthetic chain at coding depths 8 (pb 12) and 16
    (pb 16)."""
    if case == "frame":
        _vlc_against_plain(monkeypatch, "yuv420p")
        return
    bits = 8 if case == "chain-pb12" else 16
    args = _vlc_chain_inputs(bits, bits)
    _build.reset_counts()
    got = vlc.vlc_adapt(*(a.cuda() for a in args), bits)
    assert _build.KERNELS["vlc"].launches == 1
    ref = vlc.vlc_adapt_plain(*args, bits)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    t6 = slice(int(args[2][6]), int(args[2][6]) + 300)
    assert (ref[0][t6, 5] != 0).all() and not ref[0][t6, 7].any()


def test_torch_gpu_vlc_pb16_matches_plain(monkeypatch):
    """K5 with the 16-bit cell payload (pb = 16): yuv420p16 on
    Golomb-Rice; then the encoder's packets equal the native codec's."""
    w, h = 128, 96
    cfg = FFV1Config(level=3, coder=0, slices=4)
    p = dataclasses.replace(params_from_config(cfg, "yuv420p16", w, h),
                            ac=CODER_GOLOMB)
    _vlc_against_plain(monkeypatch, "yuv420p16", p)
    enc = dc.DeviceFFV1Encoder(w, h, "yuv420p16", cfg, device="cuda",
                               params=p)
    bank = enc.banks[0]
    assert bank.rice_pb == 16
    nat = NativeFFV1Codec(p)
    rng = np.random.RandomState(8)
    for t in range(3):
        planes = _frame(p, w, h, t, rng, t == 1)
        assert enc.encode(planes, force_keyframe=t == 0) == nat.encode(
            planes, t == 0), t


def test_torch_gpu_ladder_matches_plain():
    """The ladder kernel against its plain loop: random counts, flushes,
    resets and an invalid tail, longer than one BATCH of events."""
    rng = np.random.RandomState(4)
    L, E = 7, 1000
    cnt = torch.as_tensor(rng.randint(0, 3000, (L, E)).astype(np.int32))
    fl = torch.as_tensor(rng.rand(L, E) < 0.2)
    va = torch.as_tensor(np.arange(E)[None, :] < rng.randint(0, E, (L, 1)))
    rs = torch.as_tensor(rng.rand(L, E) < 0.01) & va
    args = [t.cuda() for t in (cnt, fl, va, rs)]
    full = torch.full((L,), E, dtype=torch.int32)
    got = rice.run_index_scan(*args, full.cuda())
    assert torch.equal(got.cpu(),
                       rice.run_index_scan_plain(cnt, fl, va, rs, full))
    # per-lane event counts: each lane stops at its own
    n_ev = torch.as_tensor(rng.randint(0, E + 1, L).astype(np.int32))
    n_ev[0], n_ev[1] = 0, E
    live = torch.arange(E)[None, :] < n_ev[:, None]
    got = rice.run_index_scan(*args, n_ev.cuda()).cpu()
    ref = rice.run_index_scan_plain(cnt, fl, va, rs, n_ev)
    assert torch.equal(got[live], ref[live])


def test_torch_gpu_ladder_chunked_lanes():
    """The ladder's three kernels (chunk maps, carries, replay) against the
    per-event loop and the chunked plain version: a 60000-event lane
    (469 chunks, past one 256-map tile of the carries), a lane of 0
    events, lanes ending mid-chunk and on a chunk's edge; counts across
    the climb table's edge and past P[40]; one launch counted."""
    rng = np.random.RandomState(6)
    L, E = 6, 60000
    cnt = rng.randint(0, 700, (L, E))
    cnt[:, ::97] = rng.randint(530, 560, cnt[:, ::97].shape)
    cnt[:, ::1009] = 1 << 25
    cnt = torch.as_tensor(cnt.astype(np.int32))
    fl = torch.as_tensor(rng.rand(L, E) < 0.2)
    va = torch.as_tensor(rng.rand(L, E) < 0.95)
    rs = torch.as_tensor(rng.rand(L, E) < 0.002) & va
    n_ev = torch.as_tensor(np.array([E, 0, 129, 256, 1, 12345], np.int32))
    live = torch.arange(E)[None, :] < n_ev[:, None]
    args = [t.cuda() for t in (cnt, fl, va, rs, n_ev)]
    _build.reset_counts()
    got = rice.run_index_scan(*args)
    torch.cuda.synchronize()
    k = _build.KERNELS["ladder"]
    assert k.launches == 1 and k.plain_calls == 0
    assert _build.device_launches(lambda: rice.run_index_scan(*args)) == 3
    got = got.cpu()
    ref = rice.run_index_scan_plain(cnt, fl, va, rs, n_ev)
    assert torch.equal(got[live], ref[live])
    chunked = rice.run_index_scan_chunked_plain(cnt, fl, va, rs, n_ev)
    assert torch.equal(got[live], chunked[live])


@pytest.mark.parametrize("pix,wh,level,coder,emission", [
    ("yuv444p16", (96, 64), 3, 1, False), ("gray16", (96, 64), 3, 1, True),
    ("rgb48", (96, 64), 3, 1, False), ("rgb48", (96, 64), 4, 1, True),
    ("bgr0", (96, 64), 4, 1, True), ("bgr0", (96, 64), 3, 0, False),
    ("yuv420p", (35, 33), 3, 1, False), ("yuv420p", (35, 33), 3, 0, False),
    ("bgr0", (35, 33), 3, 1, True)])
def test_torch_gpu_deep_rgb_banks_match_native(pix, wh, level, coder,
                                               emission):
    """Deep YUV, RGB (fixed RCT, the v4 search, rgb48, Golomb-Rice) and
    the shape banks of a non-uniform geometry on the card == native, on
    the kernels of the path and no plain version."""
    w, h = wh
    cfg = FFV1Config(level=level, coder=coder, slices=4, slicecrc=1)
    p = params_from_config(cfg, pix, w, h)
    enc = dc.DeviceFFV1Encoder(w, h, pix, cfg, device="cuda",
                               emission_order=emission)
    nat, dec = NativeFFV1Codec(p), NativeFFV1Codec(p)
    rng = np.random.RandomState(8)
    _build.reset_counts()
    for t in range(3):
        planes = [rng.randint(0, 1 << p.bits, s).astype(np.int32)
                  for s in _shapes(p, w, h)]
        a = enc.encode(planes, force_keyframe=t == 0)
        assert a == nat.encode(planes, t == 0), f"frame {t}"
        if len(enc.banks) == 1:
            # (a non-uniform geometry may leave the last ceil-rounded
            # chroma column uncoded, in the native codec too)
            for x, y in zip(dec.decode(a), planes):
                assert np.array_equal(x, y), f"frame {t}: decode"
    kernels = (enc.banks[0] if enc.banks else enc).kernels
    for name in kernels:
        k = _build.KERNELS[name]
        assert k.launches > 0 and k.plain_calls == 0, name


class _SyncProbe(StageTrace):
    """A stage recorder that also keeps, at each boundary, the warnings of
    the synchronizing calls that ``seen`` gained in the stage it ends
    (``torch.cuda.set_sync_debug_mode("warn")``), from its making on."""

    def __init__(self, seen):
        super().__init__()
        self.seen, self.syncs, self._n = seen, [], len(seen)

    def __call__(self, stage, inputs=None):
        new, self._n = self.seen[self._n:], len(self.seen)
        self.syncs.append([w for w in new
                           if "synchronizing" in str(w.message)])
        super().__call__(stage, inputs)


def test_torch_gpu_banks_sync_only_at_their_reads():
    """96x50 yuv422p10 at 24 slices (two shape banks), gop 3: a settled
    frame under the sync debug mode synchronizes in the upload (a copy a
    plane) and in the four reads alone: each bank's sizes, the lengths and
    the bytes; none in ``s0`` or ``writeback``, none between bank 0's K4
    launch and bank 1's sizes.  Every packet equals the CPU session's."""
    w, h = 96, 50
    rng = np.random.RandomState(12)
    y = np.indices((h, w)).sum(0) * 7
    frames = [[((y + 13 * t + rng.randint(0, 48, (h, w))) % 1024)
               .astype(np.int32)]
              + [rng.randint(0, 1024, (h, w // 2)).astype(np.int32)
                 for _ in range(2)] for t in range(3)]
    cfg = FFV1Config(level=3, coder=1, context=1, slices=24, slicecrc=1,
                     gop_size=3)
    enc, cpu = (dc.DeviceFFV1Encoder(w, h, "yuv422p10", cfg, device=d)
                for d in ("cuda", "cpu"))
    assert len(enc.banks) == 2
    got = [enc.encode(f) for f in frames[:2]]     # the caps settle
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        probe = _SyncProbe(seen)    # (the mode's first setting may sync)
        try:
            got.append(enc.encode(frames[2], mark=probe))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert got == [cpu.encode(f) for f in frames]
    (call,) = probe.calls()
    st = call.stages
    assert {s.attempt for s in st} == {0}                 # no retry
    where = [(s.name, s.bank) for s, w in zip(st, probe.syncs) if w]
    lines = [[(os.path.basename(x.filename), x.lineno) for x in w]
             for w in probe.syncs]
    assert where == [("upload", 0), ("sizes to host", 0),
                     ("sizes to host", 1), ("lengths to host", 0),
                     ("bytes to host", 0)], lines
    # the upload's copies, a plane each, from one line of ``upload``
    assert len(lines[0]) == 3 and len(set(lines[0])) == 1, lines
    names = [s.name for s in st]
    read = names.index("lengths to host")
    assert [s.bank for s in st[:read] if s.name == "K4 rac_render"] == [0, 1]


def _ragged_lanes(steps, lanes, seed, start=0):
    """Random ops; lane l ends (its two flush steps, then NOPs) at its own
    length; lane 0 carries a long run of pending bytes over steps // 2
    steps from ``start`` (NOPs before it, and the lane runs to the end)."""
    rng = np.random.RandomState(seed)
    sv = rng.randint(1, 256, (steps, lanes)).astype(np.int32)
    bit = rng.randint(0, 2, (steps, lanes)).astype(np.int32)
    run = slice(start, start + steps // 2)
    sv[run, 0] = 255
    bit[run, 0] = np.arange(run.stop - run.start) % 2 == 0
    mode = np.full((steps, lanes), tc.MODE_OP, np.int32)
    ends = rng.randint(steps // 2, steps - 2, lanes)
    ends[-1] = steps - 2
    if start:
        ends[0] = steps - 2
        mode[:start, 0] = tc.MODE_NOP
    for l, L in enumerate(ends):
        mode[L:, l] = tc.MODE_NOP
        mode[L, l] = tc.MODE_FLUSH1
        mode[L + 1, l] = tc.MODE_FLUSH2
    return [torch.as_tensor(a) for a in (sv, bit, mode)]


@pytest.mark.parametrize("steps,lanes,start", [
    (700, 5, 0), (4096, 30, 0), (300, 1, 0),
    # below one stage of the kernel's ring (512 steps), not a multiple of
    # one, across many; 33 and 64 lanes (a 4-byte column 132 and 256
    # bytes apart)
    (200, 7, 0), (1300, 33, 0), (5000, 64, 0),
    # a fill run from inside a stage across three stage boundaries
    (4600, 30, 700)])
def test_torch_gpu_rac_lanes_matches_plain(steps, lanes, start):
    """K7 against its plain version, every staged array whole."""
    args = _ragged_lanes(steps, lanes, 3, start)
    _build.reset_counts()
    got = rac.rac_lanes(*(a.cuda() for a in args))
    assert _build.KERNELS["rac_lanes"].launches == 1
    ref = rac.rac_scan_lanes(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    if start:
        assert int(ref[1][:, 0].max()) > 1023


@pytest.mark.parametrize("pix,coder,level", [
    ("yuv420p", 1, 3), ("yuv420p", 0, 3), ("bgr0", 1, 4),
    ("yuv420p", 2, 1)])
def test_torch_gpu_tpu_coder_matches_native(pix, coder, level):
    """TPUCoderFFV1Encoder at 96x64 on the card == native, through K7 and
    no plain version; TPUFFV1Encoder (phase A on the card) likewise."""
    w, h = 96, 64
    cfg = FFV1Config(level=level, coder=coder, slices=4 if level > 2 else 0)
    enc = tc.TPUCoderFFV1Encoder(w, h, pix, cfg)
    p = enc.p
    nat, dec = NativeFFV1Codec(p), NativeFFV1Codec(p)
    rng = np.random.RandomState(9)
    _build.reset_counts()
    frames = [[rng.randint(0, 256, s).astype(np.int32) // (t + 1)
               for s in _shapes(p, w, h)] for t in range(3)]
    for t, planes in enumerate(frames):
        a = enc.encode(planes, force_keyframe=t == 0)
        assert a == nat.encode(planes, t == 0), f"frame {t}"
        for x, y in zip(dec.decode(a), planes):
            assert np.array_equal(x, y), f"frame {t}: decode"
    k = _build.KERNELS["rac_lanes"]
    assert k.launches == 3 and k.plain_calls == 0
    if level < 4:
        hyb = te.TPUFFV1Encoder(w, h, pix, cfg)
        nat = NativeFFV1Codec(p)
        for t, planes in enumerate(frames):
            assert hyb.encode(planes, force_keyframe=t == 0) == nat.encode(
                planes, t == 0), f"frame {t}: TPUFFV1Encoder"


@pytest.mark.parametrize("pix,code_bits", [
    ("yuv444p", 8), ("gbrp10", 11), ("yuv444p12", 12), ("gbrp12", 13),
    ("yuv444p14", 14), ("gbrp14", 15), ("yuv444p16", 16), ("rgb48", 17)])
def test_torch_gpu_adapt_repeat_substeps(monkeypatch, pix, code_bits):
    """K2 with R = code_bits - 10 repeat sub-steps (R = 0..7) and K6
    against their plain versions on a small split-group frame of three
    full planes (a smooth ramp, whose large context groups split at GCAP
    64, with a band of full-range noise: e up to code_bits - 1), from
    random start states; K6 with ev_words full and capped."""
    monkeypatch.setattr(host, "GCAP", 64)
    w, h = 96, 64
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, pix, w, h)
    enc = dc.DeviceFFV1Encoder(w, h, pix, cfg, device="cuda")
    bank = enc.banks[0]
    assert bank.code_bits == code_bits
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:h, 0:w]
    band = (yy >= 8) & (yy < 24)
    planes = [np.where(band, rng.randint(0, 1 << p.bits, (h, w)),
                       (xx * 37 + 1000 * c) % (1 << p.bits)).astype(np.int32)
              for c in range(3)]
    enc.encode(planes, force_keyframe=True)             # settles the caps
    dev = [torch.as_tensor(x, device="cuda") for x in planes]
    ctx, diff = bank.phase_a(dev)
    plan = bank.layout(ctx, diff, bank.caps.tiles_cap, bank.caps.cellrows_cap)
    assert (plan["tile_pred"] >= 0).any()
    ch1c, _ = pl.place(plan, bank.caps.cellrows_cap)
    if code_bits > 10:
        assert int((ad.cell_diff(ch1c, code_bits).abs()
                    >= 1 << 10).sum()) > 0
    canon = torch.as_tensor(rng.randint(1, 256, bank.canonical.shape)
                            .astype(np.uint8), device="cuda")
    s0 = dc.build_s0_blocks(plan, canon, bank.caps.tiles_cap, bank.slot_at_row)
    k2 = (ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
          s0, bank.table, code_bits)
    sv, ends = ad.adapt(*k2)
    assert sv.shape[1] == host.n_sv_words(code_bits)
    for a, b in zip((sv, ends), ad.adapt_plain(*k2)):
        assert torch.equal(a, b)
    for ev_words in (host.n_ev_words(code_bits), 3):
        for a, b in zip(ad.adapt_emission(*k2, ev_words),
                        ad.adapt_emission_plain(*k2, ev_words)):
            assert torch.equal(a, b), ev_words


@pytest.mark.parametrize("B,M,n,num_keys,kernel", [
    (3, 2048, 3, 1, "rowsort"), (2, 4096, 4, 2, "rowsort"),
    (3, 1 << 16, 2, 1, "rowsort"), (2, 1 << 16, 5, 2, "rowsort"),
    (1, 1 << 16, 10, 1, "rowsort"), (1, 1 << 20, 3, 1, "sort"),
    (1, 1 << 20, 3, 2, "sort"), (1, 1 << 19, 7, 1, "sort"),
    # index mode, one key (K8) and two keys (K9)
    (1, 1 << 20, 10, 1, "sort"), (2, 1 << 16, 5, 2, "rowsort"),
    # direct mode: n = 2, and n = 3 with two keys
    (1, 1 << 21, 2, 1, "sort"), (2, 1 << 17, 3, 2, "rowsort"),
    # Lc == L in index mode: one block a row (enough rows for the SMs);
    # and few rows, where the chunk shrinks to fill the SMs
    (160, 1 << 14, 6, 1, "rowsort"), (136, 1 << 14, 4, 2, "rowsort"),
    (3, 1 << 14, 4, 2, "rowsort"),
    # one operand: chunks of 2^14 (the largest) and of 2^13
    (200, 1 << 15, 1, 1, "rowsort"), (1, 1 << 20, 1, 1, "rowsort"),
    # 17 operands: the pointer table has no fixed cap
    (1, 1 << 18, 17, 2, "sort"), (3, 4096, 17, 1, "rowsort")])
def test_torch_gpu_sort_matches_plain(B, M, n, num_keys, kernel):
    """K8/K9 against the plain network on duplicate keys (negative values
    and INT32_MAX sentinels among them), in both modes (index: the keys
    and the column ride; direct: the operands), whole rows in shared
    memory and hierarchical with merged cross passes; and against
    torch.sort + gather on unique keys.  One launcher call a sort."""
    rng = np.random.RandomState(M + n)
    keys = rng.randint(-500, 500, (num_keys, B, M)).astype(np.int32)
    keys[0][rng.rand(B, M) < 0.1] = 2 ** 31 - 1
    pay = rng.randint(-2 ** 31, 2 ** 31 - 1, (n - num_keys, B, M),
                      dtype=np.int64).astype(np.int32)
    ops = [torch.as_tensor(a, device="cuda") for a in (*keys, *pay)]
    geo = sort.geometry(n, num_keys, B, M, sort.card_limits("cuda"))
    assert geo["mode"] == ("index" if n > num_keys + 1 else "direct")
    if B >= 136 and M == 1 << 14:
        assert geo["Lc"] == 14 and geo["kernels"] == 1 + (n > num_keys + 1)
    _build.reset_counts()
    got = sort.sort_rows(ops, num_keys)
    assert {k: _build.KERNELS[k].launches for k in ("sort", "rowsort")} == {
        k: int(k == kernel) for k in ("sort", "rowsort")}
    for a, b in zip(got, sort.bitonic_plain(ops, num_keys)):
        assert torch.equal(a, b)
    perm = torch.stack([torch.randperm(M, device="cuda") for _ in range(B)])
    ops[0] = (perm - M // 2).to(torch.int32)
    got = sort.sort_rows(ops, 1)
    key, idx = torch.sort(ops[0], dim=1, stable=True)
    assert torch.equal(got[0], key)
    for a, p in zip(got[1:], ops[1:]):
        assert torch.equal(a, torch.gather(p, 1, idx))


@pytest.mark.parametrize("prim,R,reps", [
    ("roll", 512, 64), ("roll", 2050, 9), ("rowcx", 2048, 64),
    ("rowcx", 128, 4), ("rowcx", 256, 8), ("rowcx", 512, 64),
    ("rowcx", 2048, 9), ("rowcx", 1024, 1), ("transpose", 512, 32),
    ("transpose", 64, 3)])
def test_torch_gpu_prims_match_plain(prim, R, reps):
    wrapper, plain, K = mp.PRIMS[prim][:3]
    rng = np.random.RandomState(R + reps)
    x = torch.as_tensor(rng.randint(-2 ** 31, 2 ** 31 - 1, (R, 128),
                                    dtype=np.int64).astype(np.int32),
                        device="cuda")
    _build.reset_counts()
    got = wrapper(x, reps)
    assert K.launches == 1 and K.plain_calls == 0
    assert torch.equal(got, plain(x, reps))


def test_torch_gpu_probes_match_plain():
    """K13-K17 on the JAX tool's inputs (their expected results), on
    random ones with negative values and on ``probes.edge_inputs``."""
    for name, K, fn, plain, args, result, expected in probes.inputs("cuda"):
        got = fn(*args)
        assert result(got) == expected, name
        assert torch.equal(got, plain(*args)), name
    rng = np.random.RandomState(6)
    v = torch.as_tensor(rng.randint(-2 ** 31, 2 ** 31 - 1, (24, 128),
                                    dtype=np.int64).astype(np.int32),
                        device="cuda")
    idx = torch.as_tensor(rng.randint(0, 128, (1, 128)).astype(np.int32),
                          device="cuda")
    tab = v.reshape(-1)[:1000].contiguous()
    for fn, plain, args in (
            (probes.scalar_extract, probes.scalar_extract_plain, (v,)),
            (probes.scalar_in_ds, probes.scalar_in_ds_plain, (v,)),
            (probes.big_prefetch, probes.big_prefetch_plain, (tab, v[:60])),
            (probes.roll_dynamic, probes.roll_dynamic_plain, (v,)),
            (probes.roll_dynamic, probes.roll_dynamic_plain, (-v.abs(),)),
            (probes.taa_rows, probes.taa_rows_plain, (v, idx))):
        args = tuple(a.contiguous() for a in args)
        assert torch.equal(fn(*args), plain(*args)), fn.__name__
    # K13 and K16 past the tool's rows, K17 at 1, 9, 10 and 4096 rows with
    # five idx patterns
    for label, K, fn, plain, args in probes.edge_inputs("cuda"):
        assert torch.equal(fn(*args), plain(*args)), f"{K.name} {label}"


def _int32(rng, shape):
    return rng.randint(-2 ** 31, 2 ** 31, shape,
                       dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("R", [1, 31, 512, 2050])
@pytest.mark.parametrize("reps", [0, 1, 7, 9, 64])
def test_torch_gpu_roll_register_network(R, reps):
    """K10 (a warp a row in registers, the rolls by shuffles and register
    renames) equals roll_plain on every element: a row count that fills
    no block, rounds of 7 rolls, their tail and no rep at all; a row near
    INT_MAX makes the + 1 wrap."""
    rng = np.random.RandomState(R * 100 + reps)
    x = _int32(rng, (R, 128))
    x[R // 2] = 2 ** 31 - 1 - np.arange(128)
    x = torch.as_tensor(x, device="cuda")
    k = _build.KERNELS["roll"]
    _build.reset_counts()
    got = mp.roll(x, reps)
    assert k.launches == 1 and k.plain_calls == 0
    assert torch.equal(got, mp.roll_plain(x, reps))


@pytest.mark.parametrize("shape", [(32, 32), (64, 96), (512, 128)])
@pytest.mark.parametrize("reps", [0, 1, 3, 32])
def test_torch_gpu_transpose_skewed_registers(shape, reps):
    """K12 (a 32 x 32 tile in skewed registers, split over four warps by
    the register pairs a transpose swaps; 31 shuffles a transpose) equals
    transpose_plain on every element: one tile, a non-square grid of
    tiles and the tool's shape, no rep at all; a row near INT_MAX makes
    the + 1 wrap."""
    rng = np.random.RandomState(shape[1] * 100 + reps)
    x = _int32(rng, shape)
    x[shape[0] // 2] = 2 ** 31 - 1 - np.arange(shape[1]) % 3
    x = torch.as_tensor(x, device="cuda")
    k = _build.KERNELS["transpose"]
    _build.reset_counts()
    got = mp.transpose(x, reps)
    assert k.launches == 1 and k.plain_calls == 0
    assert torch.equal(got, mp.transpose_plain(x, reps))


@pytest.mark.parametrize("R", [4, 8, 300, 4096])
def test_torch_gpu_scalar_in_ds_one_warp(R):
    """K14 (one warp, no staging) equals scalar_in_ds_plain where row 0's
    max is negative (jnp's floor modulo picks the row), INT_MIN or
    INT_MAX, up to R = 4096, past the old 256-row cap."""
    rng = np.random.RandomState(R)
    k = _build.KERNELS["probe_scalar_in_ds"]
    _build.reset_counts()
    tops = (-1, -2, -3, -4, -2 ** 31, 2 ** 31 - 1)
    for top in tops:
        v = rng.randint(-2 ** 31, 2 ** 31, (R, 128), dtype=np.int64)
        v[0] = top - rng.randint(0, top + 2 ** 31 + 1, 128, dtype=np.int64)
        v[0, rng.randint(128)] = top
        v = torch.as_tensor(v.astype(np.int32), device="cuda")
        got = probes.scalar_in_ds(v)
        assert torch.equal(got, probes.scalar_in_ds_plain(v)), top
        assert torch.equal(got[0], v[top % 4]), top
    assert k.launches == len(tops) and k.plain_calls == 0


@pytest.mark.parametrize("R", [1, 7, 8, 9, 24, 4096])
def test_torch_gpu_scalar_extract_warp_and_block(R):
    """K13 (one warp holding the array in registers up to 8 rows; one
    block of 1024 threads past 8 rows) equals scalar_extract_plain where
    the max is INT_MAX in the last row (the add wraps), where every word is
    INT_MIN, where every word is negative, and on random words."""
    rng = np.random.RandomState(R)
    k = _build.KERNELS["probe_scalar_extract"]
    _build.reset_counts()
    cases = []
    for hi in (2 ** 31 - 1, -1, 2 ** 20):
        v = rng.randint(-2 ** 31, hi, (R, 128), dtype=np.int64)
        v[R - 1, rng.randint(128)] = hi
        cases.append(v.astype(np.int32))
    cases.append(np.full((R, 128), -2 ** 31, np.int32))
    for v in cases:
        x = torch.as_tensor(v, device="cuda")
        got = probes.scalar_extract(x)
        assert torch.equal(got, probes.scalar_extract_plain(x)), int(x.max())
    assert k.launches == len(cases) and k.plain_calls == 0


@pytest.mark.parametrize("R", [1, 7, 8, 9, 300, 4096])
def test_torch_gpu_roll_dynamic_warps(R):
    """K16 (warps of two rows, each reducing row 0 itself) equals
    roll_dynamic_plain where row 0's max is negative (-1..-4, -128, -129),
    INT_MIN or INT_MAX; an odd R leaves a warp's second row past v."""
    rng = np.random.RandomState(R)
    k = _build.KERNELS["probe_roll_dynamic"]
    _build.reset_counts()
    tops = (-1, -2, -3, -4, -128, -129, -2 ** 31, 2 ** 31 - 1)
    for top in tops:
        v = _int32(rng, (R, 128)).astype(np.int64)
        v[0] = top - rng.randint(0, top + 2 ** 31 + 1, 128, dtype=np.int64)
        v[0, rng.randint(128)] = top
        v = torch.as_tensor(v.astype(np.int32), device="cuda")
        got = probes.roll_dynamic(v)
        assert torch.equal(got, probes.roll_dynamic_plain(v)), top
        assert torch.equal(got, torch.roll(v, (128 - top % 128) % 128, 1))
    assert k.launches == len(tops) and k.plain_calls == 0


@pytest.mark.parametrize("G", [1, 4, 33, 100])
def test_torch_gpu_big_prefetch_wraps(G):
    """K15 in one block (G <= 32) and in blocks of 32 rows, on a table
    whose row sums wrap past INT32_MAX, with x 16-byte aligned and 4 bytes
    off: equal to big_prefetch_plain."""
    rng = np.random.RandomState(G)
    tab_h = rng.randint(2 ** 29, 2 ** 31, 16 * G + 3).astype(np.int32)
    sums = tab_h[:16 * G].astype(np.int64).reshape(G, 16).sum(1)
    assert sums.max() > 2 ** 31 - 1
    tab = torch.as_tensor(tab_h, device="cuda")
    x = torch.as_tensor(_int32(rng, (G, 128)), device="cuda")
    buf = torch.empty(G * 128 + 1, dtype=torch.int32, device="cuda")
    buf[1:] = x.reshape(-1)
    off = buf[1:].view(G, 128)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    k = _build.KERNELS["probe_big_prefetch"]
    _build.reset_counts()
    for xs in (x, off):
        got = probes.big_prefetch(tab, xs)
        assert torch.equal(got, probes.big_prefetch_plain(tab, xs))
        assert got[:, 0].cpu().numpy().tolist() == sums.astype(
            np.uint32).view(np.int32).tolist()
    assert k.launches == 2 and k.plain_calls == 0


def test_torch_gpu_launch_path():
    """Once the library is loaded every kernel's launcher is bound onto
    its Kernel; a launch the launcher refuses (rowcx's cudaErrorInvalidValue
    for rows that do not split into its blocks, reached past the wrapper's
    own check) raises and counts nothing, and leaves the card usable; each
    wrapper call of K10-K17 counts one launch of its kernel."""
    _build.load()
    for k in _build.KERNELS.values():
        assert k._fn is not None and k._fn.argtypes == k.argtypes, k.name
    k = _build.KERNELS["rowcx"]
    x = torch.zeros((100, 128), dtype=torch.int32, device="cuda")
    out = torch.empty_like(x)
    before = k.launches
    with pytest.raises(RuntimeError, match="rowcx kernel: CUDA error 1:"):
        k.launch(x.data_ptr(), 100, 64, out.data_ptr(),
                 _build.stream_handle(x))
    assert k.launches == before
    torch.cuda.synchronize()
    calls = [(mp.PRIMS[p][2], lambda p=p: mp.PRIMS[p][0](
        torch.zeros((256, 128), dtype=torch.int32, device="cuda"), 8))
        for p in mp.PRIMS]
    calls += [(K, lambda fn=fn, args=args: fn(*args))
              for _, K, fn, _, args, _, _ in probes.inputs("cuda")]
    for K, call in calls:
        for _ in range(3):
            before = K.launches
            call()
            assert K.launches == before + 1, K.name
    torch.cuda.synchronize()


def test_torch_gpu_encode_batch_matches_native():
    """encode_batch at B = 2 on the card (K1, K2, emission_pack, K3 and K4
    on 2 x 4 slices, no plain version) == the native codec frame by frame;
    the session's next inter frame still equals a native session's."""
    w, h = 128, 96
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "yuv420p", w, h)
    enc = dc.DeviceFFV1Encoder(w, h, "yuv420p", cfg, device="cuda")
    sess, nat = NativeFFV1Codec(p), NativeFFV1Codec(p)
    rng = np.random.RandomState(8)
    frames = [_frame(p, w, h, t, rng, t == 1) for t in range(4)]
    assert enc.encode(frames[0], force_keyframe=True) == sess.encode(
        frames[0], True)
    state = enc.state()
    _build.reset_counts()
    pkts = enc.encode_batch(frames[1:3])
    for name in enc.kernels:
        k = _build.KERNELS[name]
        assert k.launches > 0 and k.plain_calls == 0, name
    assert pkts == [nat.encode(f, True) for f in frames[1:3]]
    assert np.array_equal(enc.state(), state) and enc.picture_number == 1
    assert enc.encode(frames[3], force_keyframe=False) == sess.encode(
        frames[3], False)


def _pa_planes(p, w, h, kind, seed):
    """A frame's planes for phase A: random over the whole depth or flat
    near its top (16 bits wrap), alpha included."""
    shapes = _shapes(p, w, h) + ([(h, w)] if p.transparency
                                 and p.colorspace != 1 else [])
    rng = np.random.RandomState(seed)
    if kind == "flat":
        return [np.full(s, (1 << p.bits) - 3, np.int32) for s in shapes]
    return [rng.randint(0, 1 << p.bits, s).astype(np.int32) for s in shapes]


@pytest.mark.parametrize("pix,level,wh,slices", [
    ("yuv420p", 3, (1920, 1080), 24), ("yuv420p10", 3, (200, 120), 4),
    ("yuv420p16", 3, (200, 120), 4), ("gray", 3, (200, 120), 4),
    ("yuva420p", 3, (70, 50), 9), ("bgr0", 3, (200, 120), 4),
    ("bgr0", 4, (200, 120), 4), ("rgb48", 3, (200, 120), 4),
    ("yuv422p10", 3, (720, 486), 24)])
@pytest.mark.parametrize("kind", ["random", "flat"])
def test_torch_gpu_phase_a_matches_plain(pix, level, wh, slices, kind):
    """The phase_a kernel equals its plain version on the card, one launch
    a session (a bank) and call: 8-, 10- and 16-bit YUV (16 bits wrap),
    gray, yuva and SD shape banks, bgr0 with the fixed and v4's per-slice
    RCT, rgb48 (32-bit samples, no wrap), context models 0 and 1, flat and
    random planes."""
    k = _build.KERNELS["phase_a"]
    w, h = wh
    for context in (0, 1):
        cfg = FFV1Config(level=level, coder=1, slices=slices,
                         context=context)
        enc = dc.DeviceFFV1Encoder(w, h, pix, cfg, device="cuda")
        planes = [torch.as_tensor(x, device="cuda") for x in
                  _pa_planes(enc.p, w, h, kind, slices + context)]
        for unit in enc.banks or [enc]:
            by = ry = None
            if unit.v4rgb:
                rng = np.random.RandomState(unit.S)
                ry, by = torch.tensor(
                    [RCT_Y_COEFF[i] for i in rng.randint(
                        0, len(RCT_Y_COEFF), unit.S)],
                    dtype=torch.int32, device="cuda").T.contiguous()
            before = k.launches
            got = unit.phase_a(planes, by, ry)
            assert k.launches == before + 1 and k.plain_calls == 0
            coded = planes
            if unit.p.colorspace == 1:
                coded = [c.reshape(-1, c.shape[-1]) for c in pa.rct_planes(
                    planes, unit.crop_plan[0], unit.p, by, ry)]
            want = unit.pa_plan.plain(coded)
            for a, b in zip(got, want):
                assert a.dtype == torch.int32 and torch.equal(a, b), (
                    context, unit.S)


@pytest.mark.parametrize("shape", [(3, 1, 1), (2, 1, 5), (4, 5, 1),
                                   (2, 2, 2), (1, 1, 40), (2, 70, 2),
                                   (3, 66, 33), (4, 540, 960)])
def test_torch_gpu_phase_a_stack_edges(shape):
    """plane_context_diff on a CUDA stack launches the kernel once, its
    grids as crops, equal to the plain version on crops of width 1-2,
    height 1 and past a tile each way (the graft step's (4, 540, 960)),
    flat and random, both context models."""
    k = _build.KERNELS["phase_a"]
    rng = np.random.RandomState(sum(shape))
    for s in (rng.randint(-32768, 32768, shape), np.full(shape, 200)):
        s = torch.as_tensor(s.astype(np.int32), device="cuda")
        for context in (0, 1):
            p = params_from_config(FFV1Config(level=3, coder=1, slices=4,
                                              context=context), "yuv420p16",
                                   64, 48)
            qt = pa.lut_for(p, p.context_model)
            before = k.launches
            got = pa.plane_context_diff(s, qt, 16, context == 1)
            assert k.launches == before + 1
            want = pa.plane_context_diff_plain(s, qt, 16, context == 1)
            for a, b in zip(got, want):
                assert a.shape == s.shape and torch.equal(a, b)


@pytest.mark.parametrize("B", [1, 8])
def test_torch_gpu_phase_a_launch_counts(B):
    """encode() launches phase_a once a frame (once a bank a frame under
    shape banks), encode_batch once a frame of its pass: B a pass, each
    writing its rows of one pair; the packets equal the native codec's."""
    k = _build.KERNELS["phase_a"]
    w, h = 256, 144
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "yuv420p", w, h)
    enc = dc.DeviceFFV1Encoder(w, h, "yuv420p", cfg, device="cuda")
    nat = NativeFFV1Codec(p)
    rng = np.random.RandomState(B)
    frames = [_frame(p, w, h, t, rng, t % 2 == 1) for t in range(B)]
    _build.reset_counts()
    assert enc.encode_batch(frames) == [nat.encode(f, True) for f in frames]
    assert k.launches == B and k.plain_calls == 0
    sess = NativeFFV1Codec(p)
    _build.reset_counts()
    for t, f in enumerate(frames[:2]):
        assert enc.encode(f, force_keyframe=t == 0) == sess.encode(f, t == 0)
    assert k.launches == min(B, 2)
    sd = dc.DeviceFFV1Encoder(720, 486, "yuv422p10",
                              FFV1Config(level=3, coder=1, slices=24),
                              device="cuda")
    _build.reset_counts()
    sd.encode(_pa_planes(sd.p, 720, 486, "random", B), force_keyframe=True)
    assert len(sd.banks) == 2 and k.launches == 2


def test_torch_gpu_conversions_match_numpy_models():
    """The five conversions and fused_bgr0_phase_a on the card == the
    port's numpy models (and the staged conversion + plane_context_diff),
    exactly; the yuv420p input makes the rgb48 sums wrap int32."""
    from ffmpeg_ffv2_tpu_torch.convert import device as conv
    from ffmpeg_ffv2_tpu_torch.convert import yuv_rgb
    h, w = 96, 128
    rng = np.random.RandomState(9)
    y = rng.randint(0, 256, (h, w)).astype(np.uint8)
    u, v = (rng.randint(0, 256, (h // 2, w // 2)).astype(np.uint8)
            for _ in range(2))
    y[:8], u[:4], v[:4] = 255, 255, 255
    img = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    img48 = rng.randint(0, 65536, (h, w, 3)).astype(np.uint16)
    g, b, r = (rng.randint(0, 65536, (h, w)).astype(np.uint16)
               for _ in range(3))
    out = conv.yuv420p_to_bgr0(y, u, v)
    assert out.is_cuda
    assert np.array_equal(out.cpu().numpy(), yuv_rgb.yuv420p_to_bgr0(y, u, v))
    out = conv.yuv420p_to_rgb48(y, u, v)
    assert np.array_equal(out.cpu().numpy(), yuv_rgb.yuv420p_to_rgb48(y, u, v))
    for got, ref in ((conv.bgr0_to_yuv420p(img),
                      yuv_rgb.bgr0_to_yuv420p(img)),
                     (conv.rgb48_to_yuv420p(img48),
                      yuv_rgb.rgb48_to_yuv420p(img48)),
                     (conv.gbrp16_to_yuv420p(g, b, r),
                      yuv_rgb.gbrp16_to_yuv420p(g, b, r))):
        for a, o in zip(got, ref):
            assert a.is_cuda and np.array_equal(a.cpu().numpy(), o)
    qt = pa.lut_for(params_from_config(FFV1Config(level=3), "yuv420p", w,
                                       h), 0)
    for (fc, fd), pl in zip(conv.fused_bgr0_phase_a(img, qt, 8, False),
                            yuv_rgb.bgr0_to_yuv420p(img)):
        sc, sd = pa.plane_context_diff(pa._wrap16(torch.as_tensor(
            pl.astype(np.int32), device="cuda")), qt, 8, False)
        assert torch.equal(fc, sc) and torch.equal(fd, sd)


def _ffv2_frame(w, h, planes, depth, seed):
    """Moving ramps plus seeded noise, as chip_smoke.py's FFV2 phase."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    mx = (1 << depth) - 1
    return [np.clip((xx * (p + 2) + yy * 3) * (mx + 1) // (4 * w + 3 * h)
                    + rng.randint(-30, 30, (h, w)), 0, mx).astype(np.int32)
            for p in range(planes)]


def _lap_inputs(rng, shapes):
    """Q12 content, then hostile int32, each with INT_MIN / INT_MAX rows."""
    (p0, h0, w0), (p1, h1, w1) = shapes
    for c in (rng.randint(-2600, 2600, (p0, h0, w0)),
              rng.randint(-2 ** 31, 2 ** 31, (p1, h1, w1), dtype=np.int64)):
        c = c.astype(np.int32)
        c[0, :4] = -2 ** 31
        c[-1, -4:] = 2 ** 31 - 1
        yield c


@pytest.mark.parametrize("sb", [64, 32])
@pytest.mark.parametrize("forward", [True, False])
def test_torch_gpu_ffv2_lap_matches_plain(forward, sb):
    """K19 on whole planes (pre: horizontal then vertical; post: the
    reverse; one launch over the tile table a call) == its plain version,
    on Q12 content and on hostile int32 with INT_MIN / INT_MAX."""
    from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
    rng = np.random.RandomState(forward)
    for c in _lap_inputs(rng, ((3, 192, 320), (2, 128, 256))):
        dev = torch.as_tensor(c, device="cuda")
        _build.reset_counts()
        dv.lap_frame(dev, sb, forward)
        torch.cuda.synchronize()
        k = _build.KERNELS["lap_pre" if forward else "lap_post"]
        assert k.launches == 1 and k.plain_calls == 0
        plain = dv.lap_frame(torch.as_tensor(c), sb, forward)
        assert torch.equal(dev.cpu(), plain)


@pytest.mark.parametrize("sb,shapes", [
    (64, ((3, 192, 320), (2, 128, 216))),
    (32, ((3, 96, 160), (1, 64, 96))),
    (16, ((6, 32, 320), (2, 32, 96))),        # the halo slabs
])
@pytest.mark.parametrize("vertical", [False, True])
@pytest.mark.parametrize("forward", [True, False])
def test_torch_gpu_ffv2_lap_dir_matches_plain(forward, vertical, sb, shapes):
    """K19 one direction at a time (``lap_dir``, as the sharded front runs
    it: one launch over the "hor" or "ver" tiles) == ``lap_dir_plain``, at
    sb 64, 32 and the 32-row halo slabs' sb 16."""
    from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
    if sb == 16 and not vertical:
        shapes = tuple((p, w, h) for p, h, w in shapes)   # one boundary
    rng = np.random.RandomState(sb + 2 * vertical + forward)
    for c in _lap_inputs(rng, shapes):
        dev = torch.as_tensor(c, device="cuda")
        _build.reset_counts()
        dv.lap_dir(dev, sb, forward, vertical)
        torch.cuda.synchronize()
        k = _build.KERNELS["lap_pre" if forward else "lap_post"]
        assert k.launches == 1 and k.plain_calls == 0
        plain = torch.tensor(c)
        dv.lap_dir_plain(plain, sb, forward, vertical)
        assert torch.equal(dev.cpu(), plain)
        assert not torch.equal(plain, torch.as_tensor(c))


@pytest.mark.parametrize("n,qp", [(n, qp) for n in (8, 16, 32, 64)
                                  for qp in (1, 2, 8, 16, 31, 127, 200)])
def test_torch_gpu_ffv2_pvq_matches_plain(n, qp):
    """K18 (dc, pulses, split sums) == its plain version on a frame's
    streams and on bands with ties and zeros, over every band class of
    n = 8..64 (one kernel launch a class), at qp up to 127 (the order
    without division) and 200 (JAX's division order), and on a band
    holding INT_MIN (the division order at any qp)."""
    from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
    from ffmpeg_ffv2_tpu_torch.ffv2 import dsp
    from ffmpeg_ffv2_tpu_torch.tools.kernel_times import pvq_classes
    x = np.stack(_ffv2_frame(128, 128, 3, 8, n))
    streams = dv.encode_front(x, 8, n=n, device="cpu")
    streams[0, 1:] = 7                          # every position tied
    streams[1, 1:] = 0                          # zero bands
    streams[2, 1::2] = -3
    streams[3, 1:n * n // 2] = -2 ** 31         # magnitudes that stay < 0
    streams[4, 1:] = 255                        # the largest fast scores
    bands = dsp.band_starts(n)
    t = torch.as_tensor(streams, device="cuda")
    got = dv.quantize_t(t, qp, bands, n)
    ref = dv.quantize_plain(torch.as_tensor(streams), qp, bands, n)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    classes = {items for items, _, _ in pvq_classes(bands)}
    assert (_build.device_launches(lambda: dv.quantize_t(t, qp, bands, n))
            == len(classes))


def test_torch_gpu_ffv2_pvq_refuses_long_band():
    """K18's classes end at 2080 positions (n = 64's longest band holds
    2049): a longer band is refused, not launched."""
    from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
    t = torch.zeros((3, 48 * 48), dtype=torch.int32, device="cuda")
    dv.quantize_t(t, 16, [0, 2080], 48)
    with pytest.raises(RuntimeError, match="pvq kernel"):
        dv.quantize_t(t, 16, [0, 2081], 48)


def test_torch_gpu_ffv2_1080p_packet_matches_host():
    """A 1080p yuv444p qp-16 frame through the card (K19, float64
    transforms, K18) == encode_host's packet; the card decode ==
    decode_host."""
    from ffmpeg_ffv2_tpu_torch.ffv2 import FFV2Config
    from ffmpeg_ffv2_tpu_torch.ffv2.native import (NativeFFV2Decoder,
                                                   NativeFFV2Encoder)
    w, h = 1920, 1080
    frame = _ffv2_frame(w, h, 3, 8, 1)
    enc = NativeFFV2Encoder(w, h, "yuv444p", FFV2Config(qp=16))
    _build.reset_counts()
    pkt = enc.encode(frame)
    assert [_build.KERNELS[k].launches for k in ("pvq", "lap_pre")] == [1, 1]
    assert pkt == enc.encode_host(frame)
    dec = NativeFFV2Decoder(w, h)
    for a, b in zip(dec.decode(pkt), dec.decode_host(pkt)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("coder", [1, 0])
def test_torch_gpu_parallel_matches_single_device(coder):
    """A 2-rank gloo world on cuda:0 (``parallel.world.spawn_world``):
    ParallelFFV1Encoder on a (1, 2) mesh, 320x192 yuv420p, 12 slices, key
    then two inter frames: every packet equals the single-device port's
    and the native codec's, and each rank launched its path's kernels with
    no plain call."""
    from ffmpeg_ffv2_tpu_torch.parallel.world import run_cases, spawn_world
    w, h = 320, 192
    cfg = FFV1Config(level=3, coder=coder, slices=12, slicecrc=1)
    p = params_from_config(cfg, "yuv420p", w, h)
    rng = np.random.RandomState(11)
    frames = [_frame(p, w, h, t, rng, True) for t in range(3)]
    keys = [True, False, False]
    case = dict(kind="ffv1", name="gpu", mesh=(1, 2), width=w, height=h,
                pix_fmt="yuv420p", cfg=cfg, lanes=[frames], keyframes=keys)
    res = [r[0] for r in spawn_world(run_cases, 2, "gloo", 300, [case],
                                     "cuda")]
    enc = dc.DeviceFFV1Encoder(w, h, "yuv420p", cfg, device="cuda")
    nat = NativeFFV1Codec(p)
    for t, key in enumerate(keys):
        want = enc.encode(frames[t], force_keyframe=key)
        assert want == nat.encode(frames[t], key)
        assert res[0]["packets"][t][0] == want, t
    for r in res:
        assert r["digests"] == res[0]["digests"]
        assert r["transport"] == "gloo"
        assert all(r["launches"][k] > 0 for k in enc.kernels), r["launches"]
        assert not any(r["plain"].values()), r["plain"]


@pytest.mark.parametrize("coder", ["ac", "rice"])
def test_torch_gpu_cli_device_matches_native(tmp_path, coder):
    """The port's CLI on the card: the default backend (``device``, on
    ``-device cuda``, the default) runs the device encoder's kernels, and
    it and ``--backend tpu`` write the AVI that ``--backend native``
    writes, which decodes, with and without ``-workers 4``, to the raw
    input."""
    from ffmpeg_ffv2_tpu_torch.cli.main import main
    rng = np.random.RandomState(20)
    w, h = 96, 64
    raw = tmp_path / "in.yuv"
    raw.write_bytes(rng.randint(0, 256, 4 * w * h * 3 // 2).astype(
        np.uint8).tobytes())
    enc = ["encode", "-i", str(raw), "-s", f"{w}x{h}", "-level", "3",
           "-slices", "4", "-g", "2", "-coder", coder]
    _build.reset_counts()
    main(enc + ["-o", str(tmp_path / "dev.avi")])
    kernels = dc.RANGE_KERNELS if coder == "ac" else dc.RICE_KERNELS
    assert all(_build.KERNELS[k].launches > 0 for k in kernels)
    for backend in ("native", "tpu"):
        main(enc + ["--backend", backend,
                    "-o", str(tmp_path / f"{backend}.avi")])
        assert ((tmp_path / f"{backend}.avi").read_bytes()
                == (tmp_path / "dev.avi").read_bytes()), backend
    for workers in ("1", "4"):
        out = tmp_path / f"dec{workers}.yuv"
        main(["decode", "-workers", workers, "-i", str(tmp_path / "dev.avi"),
              "-o", str(out)])
        assert out.read_bytes() == raw.read_bytes()


@pytest.mark.parametrize("block_size, workers", [("64", "1"), ("64", "4"),
                                                 ("0", "1")])
def test_torch_gpu_cli_ffv2_matches_host(tmp_path, block_size, workers):
    """``-c ffv2 -qp 16`` through the port's CLI on the card (the default
    -device cuda; -workers 4 is PipelinedFFV2Encoder): every packet of the
    AVI equals NativeFFV2Encoder.encode_host's, K18 (not on the split
    tree) and K19 launched with no plain version; the CLI's decode on the
    card equals decode_host."""
    from ffmpeg_ffv2_tpu_torch.cli.main import main
    from ffmpeg_ffv2_tpu_torch.container.avi import AviReader
    from ffmpeg_ffv2_tpu_torch.ffv2 import FFV2Config
    from ffmpeg_ffv2_tpu_torch.ffv2.native import (NativeFFV2Decoder,
                                                   NativeFFV2Encoder)
    w, h = 200, 136
    frames = [_ffv2_frame(w, h, 3, 8, 30 + t) for t in range(3)]
    raw = tmp_path / "in.yuv"
    raw.write_bytes(b"".join(pl.astype(np.uint8).tobytes()
                             for fr in frames for pl in fr))
    avi = tmp_path / "ffv2.avi"
    _build.reset_counts()
    main(["encode", "-i", str(raw), "-s", f"{w}x{h}", "-pix_fmt", "yuv444p",
          "-c", "ffv2", "-qp", "16", "-block_size", block_size, "-workers",
          workers, "-o", str(avi)])
    # the split tree codes its leaves on the host: K19 only
    path = ("pvq", "lap_pre") if block_size == "64" else ("lap_pre",)
    assert all(_build.KERNELS[k].launches > 0 for k in path)
    assert not any(k.plain_calls for k in _build.KERNELS.values())
    enc = NativeFFV2Encoder(w, h, "yuv444p",
                            FFV2Config(qp=16, block_size=int(block_size)))
    pkts = AviReader(avi.read_bytes()).video.packets
    assert pkts == [enc.encode_host(fr) for fr in frames]
    _build.reset_counts()
    main(["decode", "-i", str(avi), "-o", str(tmp_path / "dec.yuv")])
    assert _build.KERNELS["lap_post"].launches > 0
    assert not any(k.plain_calls for k in _build.KERNELS.values())
    dec = NativeFFV2Decoder(w, h)
    want = b"".join(np.asarray(pl).astype(np.uint8).tobytes()
                    for pkt in pkts for pl in dec.decode_host(pkt))
    assert (tmp_path / "dec.yuv").read_bytes() == want


@pytest.mark.parametrize("coder", ["ac", "rice"])
def test_torch_gpu_cli_mesh_matches_single_device(tmp_path, capfd, coder):
    """``--mesh 2x2`` on the card: a gloo world of 4 ranks sharing it (two
    GOP lanes of two slice ranks) writes the single-device CLI's AVI, every
    rank launching its path's kernels with no plain version."""
    import json
    from ffmpeg_ffv2_tpu_torch.cli.main import main
    rng = np.random.RandomState(21)
    w, h = 96, 64
    raw = tmp_path / "in.yuv"
    raw.write_bytes(rng.randint(0, 256, 5 * w * h * 3 // 2).astype(
        np.uint8).tobytes())
    enc = ["encode", "-i", str(raw), "-s", f"{w}x{h}", "-level", "3",
           "-slices", "4", "-g", "2", "-coder", coder]
    main(enc + ["-o", str(tmp_path / "one.avi")])
    capfd.readouterr()
    main(enc + ["--mesh", "2x2", "-o", str(tmp_path / "mesh.avi")])
    err = capfd.readouterr().err
    assert "--mesh 2x2: 4 ranks on gloo (-device cuda)" in err
    assert ((tmp_path / "mesh.avi").read_bytes()
            == (tmp_path / "one.avi").read_bytes())
    kernels = dc.RANGE_KERNELS if coder == "ac" else dc.RICE_KERNELS
    ranks = json.loads(err.split("--mesh ranks: ")[1].splitlines()[0])
    assert len(ranks) == 4
    for r in ranks:
        assert all(r["launches"].get(k, 0) > 0 for k in kernels), r
        assert not r["plain_calls"], r


def test_torch_gpu_cli_mesh_nccl(tmp_path, capfd):
    """``--mesh 1x1`` on the card: one rank with a card of its own, so the
    CLI picks NCCL; its AVI equals the single-device CLI's, the rank
    launching the range coder's kernels with no plain version."""
    import json
    from ffmpeg_ffv2_tpu_torch.cli.main import main
    rng = np.random.RandomState(22)
    w, h = 96, 64
    raw = tmp_path / "in.yuv"
    raw.write_bytes(rng.randint(0, 256, 4 * w * h * 3 // 2).astype(
        np.uint8).tobytes())
    enc = ["encode", "-i", str(raw), "-s", f"{w}x{h}", "-level", "3",
           "-slices", "4", "-g", "2", "-coder", "ac"]
    main(enc + ["-o", str(tmp_path / "one.avi")])
    capfd.readouterr()
    main(enc + ["--mesh", "1x1", "-o", str(tmp_path / "mesh.avi")])
    err = capfd.readouterr().err
    assert "--mesh 1x1: 1 ranks on nccl (-device cuda)" in err
    assert ((tmp_path / "mesh.avi").read_bytes()
            == (tmp_path / "one.avi").read_bytes())
    (r,) = json.loads(err.split("--mesh ranks: ")[1].splitlines()[0])
    assert r["transport"] == "nccl"
    assert all(r["launches"].get(k, 0) > 0 for k in dc.RANGE_KERNELS), r
    assert not r["plain_calls"], r


def test_torch_gpu_native_runtime_stats_packets():
    """The port's native runtime as built on the card's host, at its
    shipped flags, writes the packets and pass-1 tallies of an -O0 build
    of the same sources, and decodes that build's packets
    (one by one and frame-pipelined) to the input, for every case of
    ``tools/native_check.CASES`` at 1080p: range and Golomb-Rice,
    yuv420p, yuv420p16, bgr0 at versions 3 and 4, version 1, statistics
    on and off, one slice thread and several.  Its yuv420p frames are
    ``chip_smoke.py``'s, where a g++ 13.3 -O3 build once wrote a
    1317490-byte key frame for 772012 with statistics on."""
    from ffmpeg_ffv2_tpu_torch.ffv1 import native
    from ffmpeg_ffv2_tpu_torch.tools import native_check as nc
    w, h = 1920, 1080
    refs = nc.references(nc.build_variants(["O0"]), list(nc.CASES), 3, w,
                         h)
    res = nc.matrix({"shipped": native.build()}, refs, ["shipped"], w, h)
    assert all(v == "ok" for v in res["shipped"].values()), res
