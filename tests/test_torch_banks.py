"""The PyTorch port's DeviceFFV1Encoder on non-uniform slice geometries
(shape banks) and with the emission-order walk (K6), end to end on the CPU
(every kernel wrapper runs its plain PyTorch version on CPU tensors):
packets equal NativeFFV1Codec's byte for byte over key, inter and flat
frames (test_torch_formats._run)."""

import pytest

from ffmpeg_ffv2_tpu_torch import _build
from test_torch_formats import _run, torch_one_thread  # noqa: F401


@pytest.mark.parametrize("pix,coder", [("yuv420p", 1), ("yuv420p", 0),
                                       ("bgr0", 1)])
def test_torch_encoder_shape_banks(pix, coder):
    """(35, 33) at 4 slices: 17/18 x 16/17 slice rects, one bank per
    shape, the packet assembled in global slice order; state() refuses a
    banked session."""
    enc = _run(pix, (35, 33), 3, coder, lossless=False)
    assert enc.banks is not None and len(enc.banks) == 4
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
