"""The PyTorch port's phase A equals the JAX package's: per-pixel contexts
and folded residuals, bit for bit."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ffmpeg_ffv2_tpu.ffv1 import tpu as jtpu
from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder as JaxEncoder
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.ffv1 import host
from ffmpeg_ffv2_tpu_torch.ffv1 import phase_a as tpa
from ffmpeg_ffv2_tpu_torch.ffv1 import twopass
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config as TConfig
from ffmpeg_ffv2_tpu_torch.ffv1.params import params_from_config as tparams
from ffmpeg_ffv2_tpu_torch.ffv1.rct import RCT_Y_COEFF

W, H = 64, 48
CFG = FFV1Config(level=3, coder=1, slices=4)


def _planes(kind, seed=0, shapes=((H, W), (H // 2, W // 2), (H // 2, W // 2))):
    rng = np.random.RandomState(seed)
    if kind == "flat":
        return [np.full(s, 77, np.int32) for s in shapes]
    return [rng.randint(0, 256, s).astype(np.int32) for s in shapes]


@pytest.mark.parametrize("context", [0, 1])
def test_torch_quant_luts(context):
    p = params_from_config(FFV1Config(level=3, coder=1, slices=4,
                                      context=context), "yuv420p", W, H)
    for qi in range(len(p.context_counts)):
        ours = tpa.build_quant_luts(p.quant_tables[qi])
        ref = jtpu.build_quant_luts(p.quant_tables[qi])
        for a, b in zip(ours, ref):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["random", "flat"])
@pytest.mark.parametrize("context", [0, 1])
def test_torch_plane_context_diff(kind, context):
    p = params_from_config(FFV1Config(level=3, coder=1, slices=4,
                                      context=context), "yuv420p", W, H)
    qt = tpa.lut_for(p, p.context_model)
    jqt = jtpu.lut_for(p, p.context_model)
    five = bool(p.quant_tables[p.context_model][3][127]
                or p.quant_tables[p.context_model][4][127])
    plane = _planes(kind, seed=3)[0]
    crops = np.stack([plane[y:y + h, x:x + w] for (x, y, w, h) in p.rects()])
    ctx, diff = tpa.plane_context_diff(torch.as_tensor(crops), qt, 8, five)
    for k in range(len(crops)):
        jctx, jdiff = jtpu.plane_context_diff(jnp.asarray(crops[k]), jqt, 8,
                                              five)
        assert np.array_equal(ctx[k].numpy(), np.asarray(jctx))
        assert np.array_equal(diff[k].numpy(), np.asarray(jdiff))


@pytest.mark.parametrize("pix,kind", [("yuv420p", "random"),
                                      ("yuv420p", "flat"),
                                      ("gray", "random")])
def test_torch_phase_a_streams(pix, kind):
    """Per-slice (ctx, diff) streams == JAX DeviceFFV1Encoder._phase_a."""
    shapes = ((H, W),) if pix == "gray" else None
    planes = _planes(kind, seed=5, **({"shapes": shapes} if shapes else {}))
    enc = DeviceFFV1Encoder(W, H, pix, CFG, device="cpu").banks[0]
    ctx, diff = enc.phase_a([torch.as_tensor(pl) for pl in planes])
    jenc = JaxEncoder(W, H, pix, CFG, use_pallas=False)
    jctx, jdiff = jenc._phase_a([jnp.asarray(pl) for pl in planes])
    assert ctx.dtype == torch.int32 and diff.dtype == torch.int32
    assert np.array_equal(ctx.numpy(), np.asarray(jctx))
    assert np.array_equal(diff.numpy(), np.asarray(jdiff))


# -- the phase_a kernel's table and launch layouts ---------------------------

def _wrap16_np(x):
    return ((x + 32768) & 0xFFFF) - 32768


def kernel_model(plan, planes):
    """A numpy model of csrc/phase_a.cu read off ``plan.table``: each
    block decodes its (job, tile), stages the tile with its halo and the
    border fill in an array, and computes its samples from the direct
    quantizer rows.  Asserts that every output word is written exactly
    once; returns (ctx, diff) shaped ``plan.out_shape``."""
    t = plan.table.cpu().numpy().astype(np.int64)
    TW, TH = tpa.TILE_W, tpa.TILE_H
    q = t[:tpa.QT_WORDS].reshape(5, 256)
    n_jobs = len(plan.jobs)
    jobs = t[tpa.QT_WORDS:tpa.QT_WORDS + n_jobs * tpa.JOB_WORDS].reshape(
        n_jobs, tpa.JOB_WORDS)
    blocks = t[tpa.QT_WORDS + n_jobs * tpa.JOB_WORDS:].reshape(-1, 2)
    assert len(blocks) == plan.n_blocks
    src = [np.asarray(pl, np.int64) for pl in planes]
    n_out = int(np.prod(plan.out_shape))
    ctx = np.zeros(n_out, np.int64)
    diff = np.zeros(n_out, np.int64)
    written = np.zeros(n_out, np.int64)
    mask, half = (1 << plan.bits) - 1, 1 << (plan.bits - 1)
    for job, tile in blocks:
        p, jx, jy, w, h, off, pitch = jobs[job, :7]
        tiles_x = -(-w // TW)
        y0, x0 = tile // tiles_x * TH, tile % tiles_x * TW
        y = (y0 - 2 + np.arange(TH + 2))[:, None]
        x = (x0 - 2 + np.arange(TW + 3))[None, :]
        yy = np.where(x == -1, y - 1, y)
        xx = np.where(x == -1, 0, np.minimum(x, w - 1))
        ok = (yy >= 0) & (y < h) & (x != -2)
        pl = src[p]
        v = pl[np.clip(jy + yy, 0, pl.shape[0] - 1),
               np.clip(jx + xx, 0, pl.shape[1] - 1)]
        s = np.where(ok, _wrap16_np(v) if plan.wrap else v, 0)
        cur, T, L = s[2:, 2:-1], s[1:-1, 2:-1], s[2:, 1:-2]
        LT, RT = s[1:-1, 1:-2], s[1:-1, 3:]
        cx = q[0][(L - LT) & 255] + q[1][(LT - T) & 255] + q[2][(T - RT) & 255]
        if plan.five:
            cx = cx + q[3][(s[2:, :-3] - L) & 255] + q[4][(s[:-2, 2:-1] - T)
                                                           & 255]
        g = L + T - LT
        pred = np.minimum(np.maximum(np.minimum(L, g), T), np.maximum(L, g))
        d = np.where(cx < 0, pred - cur, cur - pred)
        d = ((d + half) & mask) - half
        cx = np.abs(cx)
        ys = y0 + np.arange(TH)[:, None]
        xs = x0 + np.arange(TW)[None, :]
        live = (ys < h) & (xs < w)
        o = (off + ys * pitch + xs)[live]
        written[o] += 1
        ctx[o] = cx[live]
        diff[o] = d[live]
    assert (written == 1).all(), "an output word written other than once"
    return ctx.reshape(plan.out_shape), diff.reshape(plan.out_shape)


def _session_planes(pix, w, h, seed, kind="random"):
    p = tparams(TConfig(level=3, coder=1, slices=4), pix, w,
                           h)
    rng = np.random.RandomState(seed)
    if p.colorspace == 1:
        shapes = [(h, w)] * (3 + p.transparency)
    else:
        shapes = ([(h, w)] + ([(-(-h >> p.chroma_v_shift),
                                -(-w >> p.chroma_h_shift))] * 2
                              if p.chroma_planes else [])
                  + [(h, w)] * p.transparency)
    if kind == "flat":
        return [np.full(s, (1 << p.bits) - 3, np.int32) for s in shapes]
    return [rng.randint(0, 1 << p.bits, s).astype(np.int32) for s in shapes]


def _units(enc):
    return enc.banks


def _by_ry(enc, seed):
    rng = np.random.RandomState(seed)
    pairs = [RCT_Y_COEFF[i] for i in rng.randint(0, len(RCT_Y_COEFF),
                                                 enc.S)]
    ry, by = (torch.tensor(c, dtype=torch.int32) for c in zip(*pairs))
    return by, ry


@pytest.mark.parametrize("context", [0, 1, "10bit-0", "10bit-1", "2pass",
                                     "custom"])
def test_torch_phase_a_direct_quant_rows(context):
    """The direct 256-entry rows that the kernel reads equal
    ``_apply_quant``'s threshold form on every difference d8 (and on d
    past the byte, through d & 0xFF): the quant tables of context models
    0 and 1 at 8 and 10 bits, a pass-2 parameter set's, and a seeded
    custom table; the rows are the tables themselves."""
    if context == "custom":
        rng = np.random.RandomState(11)
        table = np.sort(rng.randint(-40, 40, (5, 256)), axis=1)
        table = np.concatenate([table[:, 128:], table[:, :128]], axis=1)
    else:
        pix = "yuv420p10" if str(context).startswith("10bit") else "yuv420p"
        ctx_model = int(str(context)[-1]) if context != "2pass" else 1
        p = tparams(TConfig(level=3, coder=1, slices=4,
                                          context=ctx_model), pix, W, H)
        if context == "2pass":
            nat = NativeFFV1Codec(p)
            nat.enable_stats()
            for t, f in enumerate([_planes("random", seed=s) for s in
                                   (1, 2)]):
                nat.encode(f, t == 0)
            p = twopass.apply_pass2(p, twopass.stats_to_text(
                p, *twopass.collect_stats(nat)))
        table = np.asarray(p.quant_tables[p.context_model])
    qt = tpa.build_quant_luts(table)
    rows = tpa.direct_quant_rows(qt)
    assert rows.dtype == np.int32 and rows.shape == (5, 256)
    assert np.array_equal(rows, table)
    d = torch.arange(-700, 700, dtype=torch.int32)
    for k in range(5):
        want = tpa._apply_quant(d, *qt, k)
        assert torch.equal(torch.as_tensor(rows[k])[d & 0xFF], want), k


@pytest.mark.parametrize("pix,wh,cfg", [
    ("yuv420p", (1920, 1080), dict(coder=1, context=1, slices=24)),
    ("yuv420p", (1920, 1080), dict(coder=0, context=0, slices=16)),
    ("yuv422p10", (720, 486), dict(coder=1, slices=24)),
    ("bgr0", (1920, 1080), dict(coder=1, slices=24)),
    ("yuva420p", (100, 70), dict(coder=1, slices=9))],
    ids=["range24", "rice16", "sd-banks", "bgr0-interleaved", "yuva-banks"])
def test_torch_phase_a_table_covers_planes(pix, wh, cfg):
    """A session's descriptor table (every bank's) reads each sample of
    each coded plane exactly once (twice where the odd slices of the yuva
    geometry share a chroma row), and its jobs write each word of the
    (S, npix) streams exactly once: YUV's whole planes back to back in
    coding order a slice, RGB's planes alternating line by line; every
    block names a tile of its job, and the jobs tile exactly."""
    enc = DeviceFFV1Encoder(*wh, pix, TConfig(level=3, slicecrc=1, **cfg),
                            device="cpu")
    p = enc.p
    rgb = p.colorspace == 1
    full = host.build_crop_plan(p)
    extent = [(max(y + h for x, y, w, h in pr),
               max(x + w for x, y, w, h in pr)) for pr in full]
    reads = [np.zeros(e, np.int64) for e in extent]
    for unit in _units(enc):
        plan = unit.pa_plan
        n_jobs = len(plan.jobs)
        t = plan.table.numpy()
        jobs = t[tpa.QT_WORDS:tpa.QT_WORDS + n_jobs * tpa.JOB_WORDS]
        assert np.array_equal(jobs.reshape(n_jobs, -1)[:, :7],
                              np.asarray(plan.jobs))
        blocks = t[tpa.QT_WORDS + n_jobs * tpa.JOB_WORDS:].reshape(-1, 2)
        tiles = [-(-w // tpa.TILE_W) * -(-h // tpa.TILE_H)
                 for _, _, _, w, h, _, _ in plan.jobs]
        assert [list(b) for b in blocks] == [
            [j, k] for j, n in enumerate(tiles) for k in range(n)]
        S, npix = plan.out_shape
        assert (S, npix) == (unit.S, unit.npix)
        written = np.zeros(S * npix, np.int64)
        for k, x, y, w, h, off, pitch in plan.jobs:
            if rgb:
                # the coded planes arrive as (S * h, w) stacks of crops
                si, ph = divmod(y, h)
                assert x == 0 and ph == 0 and pitch == w * len(full)
                assert off == si * npix + k * w
                sx, sy = unit.crop_plan[k][si][:2]
                reads[k][sy:sy + h, sx:sx + w] += 1
            else:
                reads[k][y:y + h, x:x + w] += 1
                assert pitch == w
            written[off + np.arange(h)[:, None] * pitch
                    + np.arange(w)[None, :]] += 1
        assert (written == 1).all()
        if not rgb:
            # contiguous: each slice's planes back to back from si * npix
            for si in range(S):
                spans = sorted((off, w * h) for k, x, y, w, h, off, _
                               in plan.jobs if off // npix == si)
                pos = si * npix
                for off, n in spans:
                    assert off == pos
                    pos += n
                assert pos == (si + 1) * npix
    for r, prects in zip(reads, full):
        # an odd slice's ceil-rounded chroma crop overlaps its neighbour's
        want = np.zeros_like(r)
        for x, y, w, h in prects:
            want[y:y + h, x:x + w] += 1
        assert np.array_equal(r, want)
        assert (want == 1).all() or pix == "yuva420p"


@pytest.mark.parametrize("pix,wh,slices,kind", [
    ("yuv420p", (100, 70), 4, "random"),
    ("yuv420p", (100, 70), 4, "flat"),
    ("gray", (160, 150), 4, "random"),
    ("yuv420p16", (70, 50), 4, "random"),
    ("yuv420p10", (70, 50), 9, "random"),
    ("yuva420p", (50, 38), 12, "random"),
    ("bgr0", (100, 70), 4, "random"),
    ("rgb48", (70, 50), 4, "random")])
def test_torch_phase_a_kernel_model_matches_plain(pix, wh, slices, kind):
    """The numpy model of the kernel, walking a session's table, equals
    the plain version of the same launch (``plan.plain``): 8-, 10- and
    16-bit YUV (16 bits wrap as the kernel reads them), gray, yuva and
    shape banks, RGB with its RCT planes (rgb48: 32-bit samples, no
    wrap), flat and random planes, crops over several tiles."""
    for context in (0, 1):
        cfg = TConfig(level=3, coder=1, slices=slices, context=context)
        enc = DeviceFFV1Encoder(*wh, pix, cfg, device="cpu")
        planes = [torch.as_tensor(x) for x in
                  _session_planes(pix, *wh, seed=slices, kind=kind)]
        for unit in _units(enc):
            plan = unit.pa_plan
            if unit.p.colorspace == 1:
                coded = [c.reshape(-1, c.shape[-1]) for c in tpa.rct_planes(
                    planes, unit.crop_plan[0], unit.p)]
            else:
                coded = planes
            ctx, diff = plan.plain(coded)
            mctx, mdiff = kernel_model(plan, coded)
            assert np.array_equal(mctx, ctx.numpy()), (context, unit.S)
            assert np.array_equal(mdiff, diff.numpy()), (context, unit.S)


@pytest.mark.parametrize("shape", [(3, 1, 1), (2, 1, 5), (4, 5, 1),
                                   (2, 2, 2), (1, 1, 40), (2, 70, 2),
                                   (3, 66, 33), (1, 9, 64)])
@pytest.mark.parametrize("kind", ["random", "flat"])
def test_torch_phase_a_stack_edges(shape, kind):
    """``plane_context_diff``'s stack plan on crops of width 1-2, height
    1, and past a tile each way: the kernel model equals the plain
    version, and both equal the JAX function where it takes the crop (two
    rows and columns or more)."""
    rng = np.random.RandomState(sum(shape))
    s = (np.full(shape, 200, np.int32) if kind == "flat" else
         rng.randint(-32768, 32768, shape).astype(np.int32))
    for context in (0, 1):
        p = tparams(TConfig(level=3, coder=1, slices=4,
                                          context=context), "yuv420p16",
                               W, H)
        qt = tpa.lut_for(p, p.context_model)
        n, h, w = shape
        plan = tpa._stack_plan(n, h, w, tpa.direct_quant_rows(qt).tobytes(),
                               16, context == 1, torch.device("cpu"))
        ctx, diff = tpa.plane_context_diff(torch.as_tensor(s), qt, 16,
                                           context == 1)
        mctx, mdiff = kernel_model(plan, [s.reshape(n * h, w)])
        assert np.array_equal(mctx, ctx.numpy())
        assert np.array_equal(mdiff, diff.numpy())
        if h >= 2 and w >= 2:
            # the JAX function takes crops of two rows and columns or more
            jqt = jtpu.build_quant_luts(p.quant_tables[p.context_model])
            for k in range(n):
                jctx, jdiff = jtpu.plane_context_diff(jnp.asarray(s[k]), jqt,
                                                      16, context == 1)
                assert np.array_equal(ctx[k].numpy(), np.asarray(jctx))
                assert np.array_equal(diff[k].numpy(), np.asarray(jdiff))


@pytest.mark.parametrize("pix,level", [("yuv420p", 3), ("gray", 3),
                                       ("yuv420p10", 3), ("bgr0", 3),
                                       ("bgr0", 4), ("rgb48", 3)])
def test_torch_phase_a_wrapper_plain_equals_streams(pix, level):
    """The session's phase A through the wrapper's plain path (one plain
    call a frame, no launch) equals today's ``phase_a`` / ``phase_a_rgb``
    streams, v4 RGB with per-slice RCT coefficients too."""
    w, h = 64, 48
    enc = DeviceFFV1Encoder(w, h, pix, TConfig(level=level, coder=1,
                                                  slices=4),
                            device="cpu").banks[0]
    planes = [torch.as_tensor(x) for x in _session_planes(pix, w, h, 3)]
    k = _build.KERNELS["phase_a"]
    before = k.plain_calls
    if enc.p.colorspace == 1:
        by, ry = _by_ry(enc, 5) if level == 4 else (None, None)
        got = enc.phase_a(planes, by, ry)
        want = tpa.phase_a_rgb(planes, enc.crop_plan[0], enc.p, enc.qt,
                               enc.code_bits, enc.five, by, ry)
    else:
        got = enc.phase_a(planes)
        want = tpa.phase_a(planes, enc.crop_plan, enc.qt, enc.p.bits,
                           enc.five)
    assert k.plain_calls - before in (1, 4) and k.launches == 0
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    # the rice path's grids are views of the streams
    for grids, stream in zip(map(enc.pa_plan.grids, got), got):
        flat = (tpa.interleave_lines(grids) if enc.p.colorspace == 1 else
                torch.cat([g.reshape(enc.S, -1) for g in grids], dim=1))
        assert torch.equal(flat, stream)


@pytest.mark.parametrize("pix,B", [("yuv420p", 1), ("yuv420p", 3),
                                   ("bgr0", 2)])
def test_torch_phase_a_batch_rows(pix, B):
    """encode_batch's phase A: frame b's rows b * S .. (b + 1) * S of the
    one (B * S, npix) pair equal that frame's own streams."""
    w, h = 64, 48
    enc = DeviceFFV1Encoder(w, h, pix, TConfig(level=3, coder=1,
                                                  slices=4), device="cpu")
    frames = [_session_planes(pix, w, h, 20 + b) for b in range(B)]
    bank = enc.banks[0]
    ctx, diff, (svp, btp, hlen) = bank.batch_streams(frames)
    S = bank.S
    assert ctx.shape == diff.shape == (B * S, bank.npix)
    for b, f in enumerate(frames):
        c, d = bank.phase_a(enc.upload(f))
        assert torch.equal(ctx[b * S:(b + 1) * S], c)
        assert torch.equal(diff[b * S:(b + 1) * S], d)
    assert hlen.shape == (B * S,)
