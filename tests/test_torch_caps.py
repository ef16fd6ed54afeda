"""The cap policy of a shape bank (``ffv1/caps.py``) against the JAX
session's, on the CPU: from caps shrunk below the first keyframe's need,
the port's bank grows and tightens each cap to the JAX
``DeviceFFV1Encoder``'s value after every frame, key and inter, while the
packets stay equal; and the fit loop gives up with the JAX session's
message after its tries."""

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config as JConfig
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu_torch.utils.metrics import StageTrace
from test_torch_formats import torch_one_thread  # noqa: F401

W, H = 64, 48
CFG = dict(level=3, slices=4, gop_size=4)
# each coder's caps, and the values they start from here: below the
# first keyframe's layout, ops, unsort width and render buffer (range),
# or layout, ladder events and bitstream words (rice)
SHRUNK = {1: dict(tiles_cap=1, op_cap=4096, unsort_words=1, render_cap=64,
                  cellrows_cap=1536),
          0: dict(tiles_cap=1, ev_cap=64, nwords=8, cellrows_cap=1536)}


def _frames(n, w=W, h=H, seed=3):
    """Noise over a moving ramp, then inter frames close to it."""
    rng = np.random.RandomState(seed)
    out = []
    for t in range(n):
        planes = []
        for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
            yy, xx = np.mgrid[0:hh, 0:ww]
            ramp = (xx * 3 + yy * 2 + 5 * t) % 256
            planes.append(np.where(rng.rand(hh, ww) < 0.3,
                                   rng.randint(0, 256, (hh, ww)),
                                   ramp).astype(np.int32))
        out.append(planes)
    return out


def _session(coder, w=W, h=H):
    enc = DeviceFFV1Encoder(w, h, "yuv420p", FFV1Config(coder=coder, **CFG),
                            device="cpu")
    enc.trace = StageTrace()
    return enc


@pytest.mark.parametrize("coder", [1, 0], ids=["range", "rice"])
def test_torch_caps_follow_jax(torch_one_thread, coder):  # noqa: F811
    """Three frames (a keyframe, then inter frames) from the shrunk caps:
    the keyframe retries in the layout (and, range, in K4); after each
    frame every cap equals the JAX session's attribute of its name."""
    enc = _session(coder)
    jenc = jdc.DeviceFFV1Encoder(W, H, "yuv420p", JConfig(coder=coder, **CFG),
                                 use_pallas=False)
    caps = enc.banks[0].caps
    for name, v in SHRUNK[coder].items():
        setattr(caps, name, v)
        setattr(jenc, name, v)
    nat = NativeFFV1Codec(enc.p)
    for t, f in enumerate(_frames(3)):
        pkt = enc.encode(f)
        assert pkt == jenc.encode(f) == nat.encode(f, t == 0), t
        got = {k: getattr(caps, k) for k in SHRUNK[coder]}
        assert got == {k: getattr(jenc, k) for k in SHRUNK[coder]}, t
        if t == 0:
            names = [s.name for s in enc.trace.last().stages]
            assert names.count("sizes to host") >= 2
            assert names.count("K4 rac_render") == (2 if coder else 0)
    assert caps.tiles_cap > 1 and caps.cellrows_cap > 1536


@pytest.mark.parametrize("coder,cap,stage,tries,error", [
    (1, "tiles", "sizes to host", 8, "device layout exceeded worst-case caps"),
    (1, "render", "lengths to host", 1 + 6,
     "render buffer exceeded worst-case cap"),
    (0, "tiles", "sizes to host", 8, "device rice exceeded worst-case caps")])
def test_torch_caps_fit_gives_up(torch_one_thread,  # noqa: F811
                                 coder, cap, stage, tries, error):
    """A cap whose worst case is below the frame's need: the fit loop
    grows it to its bound, runs its tries (K4's after the first joint
    read of the lengths), then raises the JAX session's RuntimeError; at
    32x24, since it runs K4's plain version seven times."""
    enc = _session(coder, 32, 24)
    caps = enc.banks[0].caps
    setattr(caps, f"{cap}_cap", 1)
    setattr(caps, f"{cap}_max" if cap == "tiles" else "render_cap_max", 1)
    with pytest.raises(RuntimeError, match=error):
        enc.encode(_frames(1, 32, 24)[0])
    names = [s.name for s in enc.trace.last().stages]
    assert names.count(stage) == tries
