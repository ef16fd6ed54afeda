"""The PyTorch port's DeviceFFV1Encoder on non-uniform slice geometries
(shape banks) and with the emission-order walk (K6), end to end on the CPU
(every kernel wrapper runs its plain PyTorch version on CPU tensors):
packets equal NativeFFV1Codec's byte for byte over key, inter and flat
frames (test_torch_formats._run); the SD tape raster's two banks as one
pipeline under a cap retry in either bank."""

import numpy as np
import pytest

from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
from ffmpeg_ffv2_tpu_torch.utils.metrics import StageTrace
from test_torch_formats import _run, torch_one_thread  # noqa: F401


@pytest.mark.parametrize("pix,coder", [("yuv420p", 1), ("yuv420p", 0),
                                       ("bgr0", 1)])
def test_torch_encoder_shape_banks(pix, coder):
    """(35, 33) at 4 slices: 17/18 x 16/17 slice rects, one bank per
    shape, the packet assembled in global slice order; state() refuses a
    banked session."""
    enc = _run(pix, (35, 33), 3, coder, lossless=False)
    assert len(enc.banks) == 4
    assert sorted(si for b in enc.banks for si in b.slice_ids) == [0, 1, 2, 3]
    for fn in (enc.state, lambda: enc.load_state(None, 0)):
        with pytest.raises(ValueError, match="shape banks"):
            fn()


@pytest.mark.parametrize("pix,wh", [("yuv420p", (32, 24)),
                                    ("yuv444p16", (24, 16)),
                                    ("rgb48", (24, 16))])
def test_torch_encoder_emission_order(pix, wh):
    """emission_order=True: K6's plain version in place of K2's and the
    repack; only the path's kernels' wrappers run."""
    _build.reset_counts()
    enc = _run(pix, wh, 3, 1, emission=True)
    assert enc.kernels == ("phase_a", "place", "adapt_emission", "expand",
                           "rac_render")
    for name, k in _build.KERNELS.items():
        assert k.launches == 0
        assert (k.plain_calls > 0) == (name in enc.kernels), name


def _tape_frames(n, w=96, h=50, seed=11):
    """10-bit 4:2:2 frames: noise over a moving gradient in luma, noise
    over the whole range in chroma."""
    rng = np.random.RandomState(seed)
    y = np.indices((h, w)).sum(0) * 7
    return [[((y + 13 * t + rng.randint(0, 48, (h, w))) % 1024)
             .astype(np.int32)]
            + [rng.randint(0, 1024, (h, w // 2)).astype(np.int32)
               for _ in range(2)] for t in range(n)]


@pytest.mark.parametrize("context,gop", [(1, 1), (0, 1), (1, 3), (0, 3)])
@pytest.mark.parametrize("case", ["render cap, bank 0", "render cap, bank 1",
                                  "layout cap, bank 1"])
def test_torch_encoder_banks_pipelined_retries(torch_one_thread,  # noqa: F811
                                               case, context, gop):
    """96x50 yuv422p10 at 24 slices (rows of 12 and 13 lines: two shape
    banks), both banks' K4 launched before their lengths are read: a cap
    forced too small in one bank on frame 1 (an inter frame at gop 3)
    retries in that bank alone, a render cap after bank 1 was enqueued;
    the packets are the native codec's, and at gop 3 the inter frame
    after it shows that each bank's states carried through the retry."""
    w, h = 96, 50
    cfg = FFV1Config(level=3, coder=1, context=context, slices=24,
                     slicecrc=1, gop_size=gop)
    enc = DeviceFFV1Encoder(w, h, "yuv422p10", cfg, device="cpu")
    enc.trace = StageTrace()
    assert len(enc.banks) == 2
    nat = NativeFFV1Codec(enc.p)
    kind, bank = case.split(" cap, bank ")
    bank = int(bank)
    for t, f in enumerate(_tape_frames(2 if gop == 1 else 3)):
        if t == 1:
            if kind == "render":
                enc.banks[bank].caps.render_cap = 64
            else:
                enc.banks[bank].caps.tiles_cap = 1
        assert enc.encode(f) == nat.encode(f, t % gop == 0), t
    st = enc.trace.calls()[1].stages
    names = [s.name for s in st]
    read = names.index("lengths to host")
    assert [s.bank for s in st[:read] if s.name == "K4 rac_render"] == [0, 1]
    if kind == "render":
        (again,) = [i for i, s in enumerate(st) if s.name == "K4 rac_render"
                    and i > read]
        assert st[again].bank == bank and st[again].attempt >= 1
    else:
        assert names.count("K4 rac_render") == 2
        assert max(s.attempt for s in st if s.bank == bank) >= 1
