"""The port's DeviceFFV1Encoder.encode_batch on the CPU on deep YUV, RGB
and the emission-order walk, against the JAX encode_batch, the native
codec frame by frame and the session afterwards
(test_torch_batch.check_batch; a file of its own so that the suite's
workers share the JAX encoder's CPU time)."""

import pytest

from ffmpeg_ffv2_tpu.ffv1.params import params_from_config
from test_torch_batch import CFG, H, W, check_batch, random_frames
from test_torch_formats import torch_one_thread  # noqa: F401


@pytest.mark.parametrize("pix,emission", [
    ("yuv422p10", False),     # coding depth 10
    ("bgr0", False),          # version 3: the fixed RCT, coding depth 9
    ("rgb48", False),         # coding depth 17
    ("yuv420p", True)])       # K6 in place of K2 and emission_pack
def test_torch_encode_batch_formats(pix, emission):
    p = params_from_config(CFG, pix, W, H)
    enc = check_batch(pix, random_frames(p, 2, seed=4, flat=1),
                      emission=emission)
    if emission:
        assert "adapt_emission" in enc.kernels
