"""The plain versions of the port's tool kernels (K10-K17, ffmpeg_ffv2_tpu_
torch/tools/) against the TPU kernel bodies of tools/microbench_pallas.py
and tools/probe_mosaic.py, run in Pallas interpret mode on the CPU; and
the tools' CPU runs.  The JAX tools are loaded by path and not edited."""

import functools
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.tools import microbench_prims as mp
from ffmpeg_ffv2_tpu_torch.tools import probes
from test_torch_formats import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mbp():
    return _load("microbench_pallas")


@pytest.mark.parametrize("prim", ["roll", "rowcx", "transpose"])
@pytest.mark.parametrize("R,reps", [(512, 16), (128, 4)])
def test_torch_prims_plain_match_pallas(mbp, prim, R, reps):
    """K10-K12's plain versions equal roll_kernel, rowcx_kernel and
    transpose_kernel (interpret mode) on the tool's arange input."""
    body = {"roll": mbp.roll_kernel, "rowcx": mbp.rowcx_kernel,
            "transpose": mbp.transpose_kernel}[prim]
    shape = (R, 128)
    x = np.arange(R * 128, dtype=np.int32).reshape(shape)
    x[R // 2] = np.iinfo(np.int32).max - np.arange(128)   # + 1 wraps
    want = pl.pallas_call(functools.partial(body, reps=reps),
                          out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
                          interpret=True)(jnp.asarray(x))
    wrapper, plain = mp.PRIMS[prim][:2]
    _build.reset_counts()
    got = wrapper(torch.as_tensor(x), reps)
    assert mp.PRIMS[prim][2].plain_calls == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(plain(torch.as_tensor(x), reps).numpy(),
                                  np.asarray(want))


PROBES = [("p1_scalar_extract", (), probes.scalar_extract_plain, 1023),
          ("p1b_scalar_in_ds", (), probes.scalar_in_ds_plain, 4),
          ("p2_big_prefetch", (12 * 1024,), probes.big_prefetch_plain, 120),
          ("p2_big_prefetch", (32 * 1024,), probes.big_prefetch_plain, 120),
          ("p2_big_prefetch", (128 * 1024,), probes.big_prefetch_plain, 120),
          ("p4_roll_dynamic", (), probes.roll_dynamic_plain, 127),
          ("p5_taa_rows", (), probes.taa_rows_plain, True)]


@pytest.mark.parametrize("fn,args,plain,expected", PROBES)
def test_torch_probes_plain_match_pallas(monkeypatch, fn, args, plain,
                                         expected):
    """K13-K17's plain versions equal the probe kernels of probe_mosaic.py
    (interpret mode) on the whole output, for the probe's own inputs; the
    port's probe inputs are the JAX tool's."""
    mod = _load("probe_mosaic")
    calls = []
    real = pl.pallas_call

    def recording(*a, **kw):
        f = real(*a, **dict(kw, interpret=True))

        def call(*xs):
            y = f(*xs)
            calls.append(([np.asarray(v) for v in xs], np.asarray(y)))
            return y
        return call

    monkeypatch.setattr(mod.pl, "pallas_call", recording)
    assert getattr(mod, fn)(*args) == expected
    (ins, want), = calls
    got = plain(*(torch.as_tensor(v.copy()) for v in ins))
    np.testing.assert_array_equal(got.numpy(), want)
    ours = {p[0]: p for p in probes.inputs("cpu")}
    name = {"p1_scalar_extract": "scalar extract (jnp.max)",
            "p1b_scalar_in_ds": "scalar in pl.ds",
            "p2_big_prefetch": f"prefetch {args[0] // 1024 if args else 0}K",
            "p4_roll_dynamic": "dynamic roll",
            "p5_taa_rows": "take_along_axis rows"}[fn]
    _, K, wrapper, _, targs, result, exp = ours[name]
    assert exp == expected
    for a, b in zip(targs, ins):
        np.testing.assert_array_equal(a.numpy(), b)
    got = wrapper(*targs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert result(got) == expected


def test_torch_probe_plain_edges():
    """Negative maxima take jnp's floor modulo; the sums wrap as int32."""
    v = -torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128) - 1
    assert int(probes.scalar_in_ds_plain(v)[0, 0]) == int(v[3, 0])   # -1 % 4
    assert int(probes.roll_dynamic_plain(v)[0, 0]) == int(v[0, 127])  # sh 1
    tab = torch.full((64,), 2 ** 30, dtype=torch.int32)
    out = probes.big_prefetch_plain(tab, torch.zeros((4, 128),
                                                     dtype=torch.int32))
    assert int(out[0, 0]) == 0                        # 16 * 2^30 mod 2^32


def test_torch_tools_cpu_runs():
    """The tools on the CPU: every case exact, every line says so, and the
    wrappers refuse what their kernels do not take."""
    r = mp.run_case("roll", "roll", 512, 16, device="cpu", timing_reps=1)
    assert r["exact_plain"] and r["launches"] == 0 and "cpu" in mp.line(r)
    for r in probes.run("cpu", timing_reps=1):
        assert r["exact_plain"] and r["result"] == r["expected"], r["name"]
        assert "cpu" in r["device"]
    assert probes.main(["--device", "cpu"]) == 0
    x = torch.zeros((128, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        mp.rowcx(x, 64)                       # blocks 128 apart need 256
    with pytest.raises(ValueError):
        mp.transpose(torch.zeros((48, 128), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        mp.roll(torch.zeros((8, 64), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        probes.scalar_in_ds(torch.zeros((2, 128), dtype=torch.int32))
    with pytest.raises(ValueError):
        probes.big_prefetch(torch.zeros(60, dtype=torch.int32),
                            torch.zeros((4, 128), dtype=torch.int32))


def test_torch_profiled_ms_holds_the_kernel_count(monkeypatch):
    """``tools.profiled_ms`` takes the profile again where the profiler
    saw fewer kernels than the call launches (copies not counted), and
    fails after PROFILE_TRIES such profiles; off the card it measures
    nothing."""
    import ffmpeg_ffv2_tpu_torch.tools as tools
    full = {"Memcpy HtoD": [0.001, 1.0], "local": [0.5, 3.0],
            "gather": [0.25, 1.0]}
    short = {"Memcpy HtoD": [0.001, 1.0], "local": [0.4, 2.4]}
    seen = []

    def fake(profiles):
        def device_profile(fn, reps, device):
            seen.append(device)
            return profiles[len(seen) - 1]
        return device_profile

    monkeypatch.setattr(tools, "device_profile", fake([short, full]))
    ms, n = tools.profiled_ms(None, 5, "cuda", 4)
    assert ms == pytest.approx(0.751) and n == 4
    assert len(seen) == 2
    seen.clear()
    monkeypatch.setattr(tools, "device_profile",
                        fake([short] * tools.PROFILE_TRIES))
    with pytest.raises(AssertionError, match="not the 4 launched"):
        tools.profiled_ms(None, 5, "cuda", 4)
    assert len(seen) == tools.PROFILE_TRIES
    assert tools.profiled_ms(None, 5, "cpu", 4) == (None, None)
