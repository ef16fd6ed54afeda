"""The PyTorch port's hybrid lane-coder encoder on the CPU (the lane coder's
wrapper runs its plain PyTorch version on CPU tensors): the lane coder
against the JAX scan and the Pallas kernel in interpret mode, the bit
packer and the vectorised compaction against the JAX ones, and
TPUCoderFFV1Encoder's packets against the port's native codec, its
decode and the JAX TPUCoderFFV1Encoder."""

import numpy as np
import pytest
import torch

from ffmpeg_ffv2_tpu.coder.bitio import BitWriter
from ffmpeg_ffv2_tpu.ffv1 import tpu_coder as jtc
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config as JConfig
from ffmpeg_ffv2_tpu.ffv1.pallas_coder import pad_for_pallas, rac_pallas_lanes
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.core.pixfmt import get_pix_fmt
from ffmpeg_ffv2_tpu_torch.ffv1 import tpu_coder as tc
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu_torch.ffv1.rac import rac_lanes, rac_scan_lanes
from ffmpeg_ffv2_tpu_torch.ffv1.twopass import collect_stats
from test_torch_formats import torch_one_thread  # noqa: F401


def ragged_ops(steps=700, lanes=5, seed=0):
    """test_tpu_coder.py:95's case: random ops, lane l ends at 600 + 15 l
    with the two flush steps, NOPs after."""
    rng = np.random.RandomState(seed)
    sv = rng.randint(1, 256, (steps, lanes)).astype(np.int32)
    bit = rng.randint(0, 2, (steps, lanes)).astype(np.int32)
    mode = np.full((steps, lanes), tc.MODE_OP, np.int32)
    for l in range(lanes):
        L = 600 + l * 15
        mode[L:, l] = tc.MODE_NOP
        mode[L, l] = tc.MODE_FLUSH1
        mode[L + 1, l] = tc.MODE_FLUSH2
    return sv, bit, mode


def test_torch_rac_lanes_matches_jax_and_pallas():
    """The plain lane coder (what rac_lanes runs on CPU tensors) equals the
    JAX scan and the TPU kernel in interpret mode, every staged array
    whole (fval at NOP steps too)."""
    sv, bit, mode = ragged_ops()
    ref = [np.asarray(a) for a in jtc.rac_scan_lanes(sv, bit, mode)]
    pal = [np.asarray(a)[:700, :5] for a in rac_pallas_lanes(
        *pad_for_pallas(sv, bit, mode), interpret=True)]
    _build.reset_counts()
    got = rac_lanes(*(torch.as_tensor(a) for a in (sv, bit, mode)))
    k = _build.KERNELS["rac_lanes"]
    assert (k.launches, k.plain_calls) == (0, 1)
    for r, p, g in zip(ref, pal, got):
        assert g.dtype == torch.int32
        assert np.array_equal(r, g.numpy()) and np.array_equal(p, g.numpy())
    with pytest.raises(ValueError, match="contiguous"):
        rac_lanes(*(torch.as_tensor(a).T for a in (sv, bit, mode)))


def test_torch_rac_lanes_single_lane_long_carry():
    """One lane (versions 0/1 have one slice) with a carry run of 500
    pending bytes, against the JAX scan."""
    steps = 1200
    sv = np.full((steps, 1), 255, np.int32)
    bit = np.zeros((steps, 1), np.int32)
    bit[:1000:2] = 1
    mode = np.full((steps, 1), tc.MODE_OP, np.int32)
    mode[1100:] = tc.MODE_NOP
    mode[1100], mode[1101] = tc.MODE_FLUSH1, tc.MODE_FLUSH2
    ref = [np.asarray(a) for a in jtc.rac_scan_lanes(sv, bit, mode)]
    got = rac_scan_lanes(*(torch.as_tensor(a) for a in (sv, bit, mode)))
    for r, g in zip(ref, got):
        assert np.array_equal(r, g.numpy())
    assert int(ref[1].max()) >= 400


def test_torch_bit_pack_lanes_matches_jax_and_bitwriter():
    rng = np.random.RandomState(7)
    steps, lanes = 300, 4
    nb = rng.randint(0, 32, (steps, lanes))
    nb[:, 3] = 32 * (np.arange(steps) % 2)     # whole words, then padding
    nb[250:, 2] = 0
    val = np.zeros((steps, lanes), dtype=np.uint32)
    for i in range(steps):
        for l in range(lanes):
            if nb[i, l]:
                val[i, l] = rng.randint(0, 1 << int(nb[i, l]))
    jw, jt = (np.asarray(a) for a in jtc.bit_pack_lanes(
        val, nb.astype(np.int32)))
    words, total = tc.bit_pack_lanes(torch.as_tensor(val.astype(np.int64)),
                                     torch.as_tensor(nb.astype(np.int32)))
    assert words.dtype == torch.int32 and total.dtype == torch.int32
    assert np.array_equal(words.numpy().view(np.uint32), jw)
    assert np.array_equal(total.numpy(), jt)
    for l in range(lanes):
        data = tc.pack_lane_bytes(words[:, l].numpy(), int(total[l]))
        assert data == jtc.pack_lane_bytes(jw[:, l], int(jt[l]))
        if l < 3:
            bw = BitWriter()
            for i in range(steps):
                bw.put(int(nb[i, l]), int(val[i, l]))
            assert data == bw.flush()
    w0, t0 = tc.bit_pack_lanes(torch.zeros((0, 2), dtype=torch.int64),
                               torch.zeros((0, 2), dtype=torch.int32))
    assert w0.shape == (1, 2) and t0.tolist() == [0, 0]


def test_torch_compact_lanes_matches_jax_loop():
    """The vectorised compaction gives the bytes of the JAX per-event loop,
    on staged events with long fill runs and an empty lane."""
    sv, bit, mode = ragged_ops(seed=3)
    sv[:400:2, 1], bit[:400:2, 1] = 255, 1
    sv[1:400:2, 1], bit[1:400:2, 1] = 255, 0
    mode[:, 4] = tc.MODE_NOP                  # a lane that emits nothing
    first, fcount, fval = (np.asarray(a) for a in
                           jtc.rac_scan_lanes(sv, bit, mode))
    assert fcount.max() > 100
    lanes = tc.compact_lanes(first, fcount, fval)
    assert lanes[4] == b""
    for l in range(5):
        ref = jtc.compact_lane(first[:, l], fcount[:, l], fval[:, l])
        assert lanes[l] == ref
        assert tc.compact_lane(first[:, l], fcount[:, l], fval[:, l]) == ref


# ---------------------------------------------------------------------------
# the encoder: test_tpu_coder.py:20-40's cases at small sizes

CASES = [
    ("v3-range-custom", dict(slices=4, coder=2), "yuv420p"),
    ("v3-range-default", dict(slices=4, coder=-2), "yuv420p"),
    ("v1-range", dict(level=1, coder=2), "yuv420p"),
    ("v0-range", dict(level=0, coder=2), "yuv420p"),
    ("v3-16bit", dict(level=3, slices=4), "yuv444p16"),
    ("v3-ctx1", dict(slices=4, context=1, coder=2), "yuv420p"),
    ("v0-rice", dict(level=0, coder=0), "yuv420p"),
    ("v1-rice", dict(level=1, coder=0), "yuv420p"),
    ("v3-rice", dict(level=3, slices=4, coder=0), "yuv420p"),
    ("v3-rice-gray", dict(level=3, slices=4, coder=0), "gray"),
    ("v3-bgr0", dict(level=3, slices=4, coder=1), "bgr0"),
    ("v4-bgr0-rct", dict(level=4, slices=4, coder=1), "bgr0"),
    ("v3-gbrp12", dict(level=3, slices=4, coder=1), "gbrp12"),
    ("v3-gbrp16", dict(level=3, slices=4, coder=1), "gbrp16"),
    ("v1-bgr0-rice", dict(level=1, coder=0), "bgr0"),
    ("v3-gbrp10-rice", dict(level=3, slices=4, coder=0), "gbrp10"),
]


def frame(fmt, w, h, t):
    """A ramp with a few bits of noise per plane (frame t moves it)."""
    pf = get_pix_fmt(fmt)
    rng = np.random.RandomState(100 + t)
    mx = (1 << pf.bits) - 1
    if pf.colorspace == 1:
        shapes = [(h, w)] * 3
    else:
        cs = (-(-h >> pf.chroma_v_shift), -(-w >> pf.chroma_h_shift))
        shapes = [(h, w)] + ([cs] * 2 if pf.chroma_planes else [])
    out = []
    for c, (hh, ww) in enumerate(shapes):
        yy, xx = np.mgrid[0:hh, 0:ww]
        ramp = (xx * 3 + yy * 2 + 5 * t + 40 * c) << max(0, pf.bits - 8)
        noise = rng.randint(0, 1 << max(2, pf.bits - 6), (hh, ww))
        out.append(np.clip(ramp + noise, 0, mx).astype(np.int64))
    return out


def size_for(fmt):
    return (32, 16) if get_pix_fmt(fmt).bits > 8 else (48, 32)


@pytest.mark.parametrize("name,cfg,fmt", CASES, ids=[c[0] for c in CASES])
def test_torch_tpu_coder_matches_native(name, cfg, fmt):
    """Key and inter frames == the port's NativeFFV1Codec, and decode back
    to the input; the range-coded frames went through the lane coder."""
    w, h = size_for(fmt)
    enc = tc.TPUCoderFFV1Encoder(w, h, fmt, FFV1Config(**cfg), device="cpu")
    nat, dec = NativeFFV1Codec(enc.p), NativeFFV1Codec(enc.p)
    _build.reset_counts()
    for t in range(2):
        f = frame(fmt, w, h, t)
        a = enc.encode(f, force_keyframe=t == 0)
        assert a == nat.encode(f, t == 0), f"frame {t}"
        for x, y in zip(f, dec.decode(a)):
            assert np.array_equal(x, y)
    assert _build.KERNELS["rac_lanes"].plain_calls >= 2


@pytest.mark.parametrize("name", ["v3-range-custom", "v3-rice",
                                  "v4-bgr0-rct"])
def test_torch_tpu_coder_matches_jax(name):
    """Packet for packet against the JAX TPUCoderFFV1Encoder."""
    _, cfg, fmt = next(c for c in CASES if c[0] == name)
    w, h = size_for(fmt)
    enc = tc.TPUCoderFFV1Encoder(w, h, fmt, FFV1Config(**cfg), device="cpu")
    jenc = jtc.TPUCoderFFV1Encoder(w, h, fmt, JConfig(**cfg))
    assert enc.extradata == jenc.extradata
    for t in range(2):
        f = frame(fmt, w, h, t)
        assert enc.encode(f, t == 0) == jenc.encode(f, t == 0), f"frame {t}"


def test_torch_tpu_coder_v4_pcm_fallback():
    """The v4 PCM retry (ffv1enc.c:1107-1117) forced by the shared budget
    hook: the replanned raw-PCM slices equal the native codec's packet,
    and a compressible frame rides the entropy path afterwards."""
    w, h = 32, 16
    cfg = FFV1Config(level=4, coder=1, slices=4)
    p = params_from_config(cfg, "yuv444p16", w, h)
    assert p.version == 4
    rng = np.random.RandomState(0)
    planes = [rng.randint(0, 65536, (h, w)).astype(np.int32)
              for _ in range(3)]
    enc = tc.TPUCoderFFV1Encoder(w, h, "yuv444p16", cfg, device="cpu")
    nat = NativeFFV1Codec(p)
    budget = 1500
    enc.set_budget_override(budget)
    nat.lib.ffv1rt_set_budget_override(nat.handle, budget)
    a = enc.encode(planes, force_keyframe=True)
    assert a == nat.encode(planes, True)
    assert len(a) > w * h * 3 * 2 * 0.9          # PCM really ran
    flat = [np.full((h, w), 99, np.int32) for _ in range(3)]
    fa = enc.encode(flat, force_keyframe=True)
    assert fa == nat.encode(flat, True)
    assert len(fa) < budget


def test_torch_tpu_coder_pass1_stats():
    """Pass-1 statistics through the planner == a native session's."""
    rng = np.random.RandomState(4)
    w, h = 48, 32
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "yuv420p", w, h)
    enc = tc.TPUCoderFFV1Encoder(w, h, "yuv420p", cfg, device="cpu")
    enc.set_stats_mode(True)
    nat = NativeFFV1Codec(p)
    nat.enable_stats()
    for t in range(3):
        f = [rng.randint(0, 256, s).astype(np.int32)
             for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        assert enc.encode(f, force_keyframe=t == 0) == nat.encode(f, t == 0)
    s1, s2, g1 = collect_stats(enc.native)
    r1, r2, g2 = collect_stats(nat)
    assert g1 == g2 == 1
    assert np.array_equal(s1, r1) and np.array_equal(s2, r2)
    assert s1.sum() > 0


def test_torch_tpu_coder_needs_cuda_by_default():
    """The default device is the card; without one the encoder raises and
    does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.TPUCoderFFV1Encoder(48, 32, "yuv420p", FFV1Config(slices=4))
