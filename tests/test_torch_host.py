"""The PyTorch port's numpy host helpers equal their JAX-package originals,
and the port imports no jax."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu.ffv1.expand_pallas import OP_GRAN
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu.ffv1.codec_py import SliceState
from ffmpeg_ffv2_tpu.ffv1.tpu_encoder import TPUFFV1Encoder
from ffmpeg_ffv2_tpu_torch.ffv1 import host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("coder", [1, -2])
def test_torch_transition_tables(coder):
    p = params_from_config(FFV1Config(level=3, coder=coder, slices=4),
                           "yuv420p", 64, 48)
    for a, b in zip(host.transition_tables(p), jdc.transition_tables(p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    a = host.packed_transition_table(p)
    b = jdc.packed_transition_table(p)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_torch_quantize_cap_and_sizes():
    for cap_max in (1000, 1 << 20):
        for gran in (1, 7, 4096):
            for need in list(range(0, 300)) + [4095, 4096, 4097, 99999,
                                               cap_max, cap_max + 5]:
                assert (host.quantize_cap(need, cap_max, gran)
                        == jdc.quantize_cap(need, cap_max, gran))
    for bits in range(1, 18):
        assert host.k_max_for_bits(bits) == jdc.k_max_for_bits(bits)
        assert host.payload_field(bits) == jdc.payload_field(bits)
        assert host.n_sv_words(bits) == jdc.n_sv_words(bits)
        assert host.n_ev_words(bits) == jdc.n_ev_words(bits)
    assert np.array_equal(host.SLOT_AT_ROW, jdc.SLOT_AT_ROW)
    assert np.array_equal(host.ROW_OF_SLOT, jdc.ROW_OF_SLOT)
    assert (host.GCAP, host.TERMINATOR_SV, host.OP_GRAN) == (
        jdc.GCAP, jdc.TERMINATOR_SV, OP_GRAN)


@pytest.mark.parametrize("level,coder,slices", [(3, 1, 4), (3, -2, 30),
                                                (1, 2, 1), (4, 1, 4)])
def test_torch_plan_slice_prefix(level, coder, slices):
    cfg = FFV1Config(level=level, coder=coder, slices=slices)
    p = params_from_config(cfg, "yuv420p", 192, 108)
    rects = p.rects()
    for key in (True, False):
        for si in range(p.slice_count):
            a = host.plan_slice_prefix(p, SliceState(p), si, rects[si], key)
            b = jdc.plan_slice_prefix(p, SliceState(p), si, rects[si], key)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("pix,wh,slices", [
    ("yuv420p", (64, 48), 4), ("yuv420p", (1920, 1080), 30),
    ("yuv420p", (35, 33), 4), ("gray", (48, 32), 4), ("bgr0", (48, 32), 4),
    ("yuva420p", (64, 48), 4)])
def test_torch_build_crop_plan(pix, wh, slices):
    p = params_from_config(FFV1Config(level=3, coder=1, slices=slices),
                           pix, *wh)
    shell = TPUFFV1Encoder.__new__(TPUFFV1Encoder)
    shell.p = p
    assert host.build_crop_plan(p) == TPUFFV1Encoder._build_plan(shell)


def test_torch_port_imports_without_jax():
    """Every module of the port imports with jax blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import ffmpeg_ffv2_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'ffmpeg_ffv2_tpu_torch.ffv1.device_coder' in names\n"
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 9
