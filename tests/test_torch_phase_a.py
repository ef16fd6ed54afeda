"""The PyTorch port's phase A equals the JAX package's: per-pixel contexts
and folded residuals, bit for bit."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ffmpeg_ffv2_tpu.ffv1 import tpu as jtpu
from ffmpeg_ffv2_tpu.ffv1.device_coder import DeviceFFV1Encoder as JaxEncoder
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu_torch.ffv1 import phase_a as tpa
from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder

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
    enc = DeviceFFV1Encoder(W, H, pix, CFG, device="cpu")
    ctx, diff = enc.phase_a([torch.as_tensor(pl) for pl in planes])
    jenc = JaxEncoder(W, H, pix, CFG, use_pallas=False)
    jctx, jdiff = jenc._phase_a([jnp.asarray(pl) for pl in planes])
    assert ctx.dtype == torch.int32 and diff.dtype == torch.int32
    assert np.array_equal(ctx.numpy(), np.asarray(jctx))
    assert np.array_equal(diff.numpy(), np.asarray(jdiff))
