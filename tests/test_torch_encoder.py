"""The PyTorch port's DeviceFFV1Encoder, end to end on the CPU (every
kernel wrapper runs its plain PyTorch version on CPU tensors): packets
equal NativeFFV1Codec's and the JAX DeviceFFV1Encoder's, byte for byte."""

import dataclasses

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.ffv1 import host
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.tpu_coder import TPUCoderFFV1Encoder
from test_torch_formats import torch_one_thread  # noqa: F401


def _shapes(p, w, h):
    shapes = [(h, w)]
    if p.chroma_planes:
        shapes += [(-(-h >> p.chroma_v_shift),
                    -(-w >> p.chroma_h_shift))] * 2
    return shapes


@pytest.mark.parametrize("pix,wh,level,coder,slices", [
    ("yuv420p", (32, 24), 3, 1, 4),
    ("yuv420p", (32, 24), 3, -2, 4),     # default transition table
    ("gray", (32, 24), 3, 1, 4),
    ("yuv422p10", (32, 16), 3, 1, 4),    # coding depth 10
    ("yuv420p", (32, 24), 4, 1, 4),      # v4 slice headers
    ("yuv420p", (16, 12), 1, 2, 1),      # v1 in-band keyframe header
])
def test_torch_encoder_matches_native(pix, wh, level, coder, slices):
    """Key, inter, flat, key frames == NativeFFV1Codec; context states
    carry across the inter frames."""
    w, h = wh
    cfg = FFV1Config(level=level, coder=coder, slices=slices)
    p = params_from_config(cfg, pix, w, h)
    enc = DeviceFFV1Encoder(w, h, pix, cfg, device="cpu")
    nat = NativeFFV1Codec(p)
    rng = np.random.RandomState(11)
    mx = (1 << p.bits) - 1
    for t in range(4):
        planes = [rng.randint(0, mx + 1, s).astype(np.int32)
                  for s in _shapes(p, w, h)]
        if t == 2:
            planes = [np.full(s, 100, np.int32) for s in _shapes(p, w, h)]
        key = t % 3 == 0
        a = enc.encode(planes, force_keyframe=key)
        b = nat.encode(planes, key)
        assert a == b, f"frame {t}: {len(a)} vs {len(b)} bytes"


def test_torch_encoder_split_groups(monkeypatch):
    """GCAP 64 splits the large context groups into sub-lanes whose
    states carry from tile to tile (the adapt walk's successor chain)."""
    monkeypatch.setattr(host, "GCAP", 64)
    w, h = 64, 48
    cfg = FFV1Config(level=3, coder=1, slices=4)
    p = params_from_config(cfg, "yuv420p", w, h)
    enc = DeviceFFV1Encoder(w, h, "yuv420p", cfg, device="cpu")
    nat = NativeFFV1Codec(p)
    rng = np.random.RandomState(3)
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
        a = enc.encode(planes, force_keyframe=key)
        b = nat.encode(planes, key)
        assert a == b, f"frame {t}"


def test_torch_encoder_runs_plain_versions_on_cpu():
    """On CPU tensors every wrapper of a path takes its plain version and
    no kernel launches (so no CUDA build is needed); between them the
    range path (K2 or K6), the Golomb-Rice path and the hybrid lane
    coder's encoder reach every kernel but the row sort's and the tools'
    (K8-K17, on no encoder path) and FFV2's (K18, K19: on no FFV1
    path)."""
    w, h = 32, 24
    reached = set()
    for coder, emission in ((1, False), (1, True), (0, False), (1, None)):
        _build.reset_counts()
        cfg = FFV1Config(level=3, coder=coder, slices=4)
        enc = (TPUCoderFFV1Encoder(w, h, "gray", cfg, device="cpu")
               if emission is None else
               DeviceFFV1Encoder(w, h, "gray", cfg, device="cpu",
                                 emission_order=emission))
        enc.encode([np.full((h, w), 9, np.int32)], force_keyframe=True)
        for name, k in _build.KERNELS.items():
            assert k.launches == 0, name
            assert (k.plain_calls > 0) == (name in enc.kernels), name
        reached.update(enc.kernels)
    off_path = {name for name, k in _build.KERNELS.items()
                if k.source.rsplit("/", 1)[1] in ("sort.cu", "prims.cu",
                                                  "probes.cu", "ffv2_quant.cu",
                                                  "ffv2_lap.cu")}
    assert len(off_path) == 13
    assert reached == set(_build.KERNELS) - off_path


def _frame_for(p, w, h, seed=1):
    rng = np.random.RandomState(seed)
    shapes = ([(h, w)] * 3 if p.colorspace == 1 else
              _shapes(p, w, h) if p.chroma_planes else [(h, w)])
    return [rng.randint(0, 1 << p.bits, s).astype(np.int32) for s in shapes]


@pytest.mark.parametrize("pix,cfg", [
    ("yuv420p10", FFV1Config(level=3, coder=1, slices=4)),
    ("yuv420p12", FFV1Config(level=3, coder=1, slices=4)),
    ("bgr0", FFV1Config(level=3, coder=1, slices=4)),
    ("yuv420p", FFV1Config(level=3, coder=0, slices=4)),
    ("bgr0", FFV1Config(level=3, coder=0, slices=4)),
], ids=["yuv420p10-cfg0-None", "yuv420p12-cfg1-depth", "bgr0-cfg2-RGB",
        "yuv420p-cfg3-None", "bgr0-cfg4-RGB"])
def test_torch_encoder_scope(pix, cfg):
    """Formats the port covers, deep and RGB ones among them, construct
    and encode a keyframe equal to the native codec's."""
    w, h = 32, 24
    p = params_from_config(cfg, pix, w, h)
    enc = DeviceFFV1Encoder(w, h, pix, cfg, device="cpu")
    planes = _frame_for(p, w, h)
    assert enc.encode(planes, force_keyframe=True) == NativeFFV1Codec(
        p).encode(planes, True)


@pytest.mark.parametrize("pix,cfg,change,err", [
    ("bgr0", FFV1Config(level=4, coder=0, slices=4), None, "version-4 RGB"),
    ("yuv420p", FFV1Config(level=3, coder=1, slices=4),
     "initial_states", "2-pass"),
    ("yuv420p", FFV1Config(level=3, coder=1, slices=4), "bits", "depth"),
], ids=["bgr0-cfg0-None-version-4 RGB", "yuv420p-cfg1-initial_states-2-pass",
        "yuv420p-cfg2-bits-depth"])
def test_torch_encoder_scope_missing(pix, cfg, change, err):
    """What the port still leaves out raises NotImplementedError: v4 RGB
    with Golomb-Rice (as the JAX encoder does) and coding depths above 17.
    2-pass initial states are covered now: per-context initial states (one
    quant table's set, the other's left at None) give the native codec's
    key and inter packets."""
    p = params_from_config(cfg, pix, 64, 48)
    if change == "initial_states":
        rng = np.random.RandomState(12)
        init = [None] * len(p.context_counts)
        init[p.context_model] = rng.randint(
            1, 256, (p.context_counts[p.context_model], 32)).astype(np.uint8)
        p = dataclasses.replace(p, initial_states=init)
        enc = DeviceFFV1Encoder(64, 48, pix, cfg, device="cpu", params=p)
        nat = NativeFFV1Codec(p)
        for t in range(2):
            planes = _frame_for(p, 64, 48, seed=t)
            assert enc.encode(planes, force_keyframe=t == 0) == nat.encode(
                planes, t == 0), f"frame {t}"
        return
    if change == "bits":
        p = dataclasses.replace(p, bits=18)
    with pytest.raises(NotImplementedError, match=err):
        DeviceFFV1Encoder(64, 48, pix, cfg, device="cpu", params=p)


def test_torch_encoder_scope_geometry_and_batch():
    """A non-uniform geometry (35, 33) builds one bank per slice shape and
    encodes, and encode_batch refuses it (as the JAX encoder does);
    encode_batch of a uniform geometry gives the native codec's key
    packets (tests/test_torch_batch.py holds it whole)."""
    cfg = FFV1Config(level=3, coder=1, slices=4)
    enc = DeviceFFV1Encoder(35, 33, "yuv420p", cfg, device="cpu")
    assert len(enc.banks) == 4
    p = params_from_config(cfg, "yuv420p", 35, 33)
    planes = [np.full(s, 50, np.int32) for s in _shapes(p, 35, 33)]
    assert enc.encode(planes, force_keyframe=True) == NativeFFV1Codec(
        p).encode(planes, True)
    with pytest.raises(NotImplementedError, match="non-uniform"):
        enc.encode_batch([planes])
    enc = DeviceFFV1Encoder(64, 48, "yuv420p", cfg, device="cpu")
    assert enc.encode_batch([]) == []
    p = params_from_config(cfg, "yuv420p", 64, 48)
    frames = [_frame_for(p, 64, 48, seed=t) for t in range(2)]
    nat = NativeFFV1Codec(p)
    assert enc.encode_batch(frames) == [nat.encode(f, True) for f in frames]


# ---------------------------------------------------------------------------
# the slice as a whole against the JAX DeviceFFV1Encoder (its XLA
# reference path, use_pallas=False); one shared JAX session, since its
# first CPU frame takes about a minute

W, H = 64, 48
CFG = FFV1Config(level=3, coder=1, slices=4)


def _jax_frames():
    rng = np.random.RandomState(21)
    shapes = [(H, W), (H // 2, W // 2), (H // 2, W // 2)]
    key = [rng.randint(0, 256, s).astype(np.int32) for s in shapes]
    yy, xx = np.mgrid[0:H, 0:W]
    inter = [((xx * 3 + yy + 17) % 256).astype(np.int32)] + [
        np.where(rng.rand(*s) < 0.2, rng.randint(0, 256, s),
                 60).astype(np.int32) for s in shapes[1:]]
    return key, inter


@pytest.fixture(scope="module")
def jax_session():
    key, inter = _jax_frames()
    jenc = jdc.DeviceFFV1Encoder(W, H, "yuv420p", CFG, use_pallas=False)
    key_pkt = jenc.encode(key, force_keyframe=True)
    canonical = np.asarray(jenc.canonical).copy()
    picture_number = jenc.picture_number
    inter_pkt = jenc.encode(inter, force_keyframe=False)
    return dict(key=key, inter=inter, key_pkt=key_pkt, inter_pkt=inter_pkt,
                canonical=canonical, picture_number=picture_number)


def test_torch_encoder_matches_jax(jax_session):
    enc = DeviceFFV1Encoder(W, H, "yuv420p", CFG, device="cpu")
    assert enc.encode(jax_session["key"]) == jax_session["key_pkt"]
    assert np.array_equal(enc.state(), jax_session["canonical"])
    assert enc.encode(jax_session["inter"]) == jax_session["inter_pkt"]


def test_torch_encoder_state_handoff(jax_session):
    """JAX codes the keyframe; its context states continue in the port."""
    enc = DeviceFFV1Encoder(W, H, "yuv420p", CFG, device="cpu")
    enc.load_state(jax_session["canonical"], jax_session["picture_number"])
    assert enc.picture_number == 1
    assert enc.encode(jax_session["inter"]) == jax_session["inter_pkt"]
    with pytest.raises(ValueError):
        enc.load_state(jax_session["canonical"][:-1], 1)
