"""The order arguments of the redesigned tool kernels K10 (``roll_kernel``,
``ffmpeg_ffv2_tpu_torch/csrc/prims.cu``) and K15
(``big_prefetch_kernel``, ``csrc/probes.cu``), on the CPU; and the launch
path that every wrapper shares (``_build.Kernel``).

Each model below runs its kernel's design on numpy, lane by lane and
register by register: K10's row in a warp's registers (lane l holds
elements l + 32 k in register k), a shuffle from lane (l - s) & 31 for a
roll by s < 32 with lanes l < s taking register k - 1, renames of the
registers for s = 32 and 64, seven rolls a round and the reps % 7 tail;
K15's warp a row, lanes l and l + 16 holding table word l, four xor
shuffles adding in unsigned 32-bit arithmetic, and lane l writing words
l + 32 k, k < 4.  Neither model is a plain version: each is held against
the plain version and against the TPU body of the JAX tool
(``tools/microbench_pallas.py:roll_kernel``, ``tools/probe_mosaic.py``'s
``p2_big_prefetch`` kernel), run in Pallas interpret mode."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.tools import microbench_prims as mp
from ffmpeg_ffv2_tpu_torch.tools import probes
from test_torch_formats import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES, REGS, WARP = 128, 4, 32
LANE = np.arange(WARP)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def to_registers(x):
    """v[r, l, k]: register k of lane l of row r's warp, x[r, l + 32 k]."""
    R = x.shape[0]
    return x.astype(np.uint32).reshape(R, REGS, WARP).transpose(0, 2, 1)


def from_registers(v):
    return v.transpose(0, 2, 1).reshape(v.shape[0], LANES).view(np.int32)


def roll_pass(v, sh):
    """One rep of K10: roll by s = 1 << sh, then + 1 (uint32 wraps)."""
    s = 1 << sh
    if s < WARP:
        u = v[:, (LANE - s) & (WARP - 1), :]     # __shfl_sync, a register
        prev = u[:, :, [(k + REGS - 1) % REGS for k in range(REGS)]]
        v = np.where((LANE < s)[None, :, None], prev, u)
    else:                                        # a rename of registers
        d = s // WARP
        v = v[:, :, [(k + REGS - d) % REGS for k in range(REGS)]]
    return v + np.uint32(1)


def roll_network(x, reps):
    """K10 on numpy: seven passes a round, then the reps % 7 tail."""
    v = to_registers(x)
    i = 0
    while i + 7 <= reps:
        for sh in range(7):
            v = roll_pass(v, sh)
        i += 7
    for sh in range(reps - i):
        v = roll_pass(v, sh)
    return from_registers(v)


def prefetch_network(tab, x):
    """K15 on numpy: acc[i, l] is lane l's sum in row i's warp."""
    G = x.shape[0]
    t = tab.astype(np.uint32)
    acc = t[16 * np.arange(G)[:, None] + (LANE & 15)[None, :]]
    for o in (8, 4, 2, 1):               # __shfl_xor_sync steps
        acc = acc + acc[:, LANE ^ o]
    assert (acc == acc[:, :1]).all()     # every lane holds the row's sum
    words = x.astype(np.uint32).reshape(G, 4, WARP) * np.uint32(0)
    return (words + acc[:, None, :]).reshape(G, LANES).view(np.int32)


def _hostile(rng, R):
    x = rng.randint(-2 ** 31, 2 ** 31, (R, LANES), dtype=np.int64)
    x[R // 2] = 2 ** 31 - 1 - np.arange(LANES)        # + 1 wraps
    return x.astype(np.int32)


@pytest.mark.parametrize("reps", [0, 1, 6, 7, 8, 13, 64])
def test_torch_roll_network_matches_plain_and_pallas(reps):
    mbp = _load("microbench_pallas")
    x = _hostile(np.random.RandomState(reps), 16)
    want = np.asarray(pl.pallas_call(
        functools.partial(mbp.roll_kernel, reps=reps),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32),
        interpret=True)(jnp.asarray(x)))
    got = roll_network(x, reps)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        mp.roll_plain(torch.as_tensor(x), reps).numpy(), got)


@pytest.mark.parametrize("sh", range(7))
def test_torch_roll_pass_is_one_roll(sh):
    """Each pass of a round alone is the roll by its s: for s < 32 the
    lanes below s take the register before, s = 32 and 64 move whole
    registers."""
    x = _hostile(np.random.RandomState(sh), 4)
    want = (np.roll(x, 1 << sh, axis=1).astype(np.int64) + 1).astype(
        np.uint32).view(np.int32)
    np.testing.assert_array_equal(
        from_registers(roll_pass(to_registers(x), sh)), want)


def _pallas_prefetch(tab, x):
    """The kernel body of probe_mosaic.p2_big_prefetch (captured from the
    tool's own call) on ``tab`` and ``x``, over a grid of x's rows."""
    mod = _load("probe_mosaic")
    bodies = []
    real = pl.pallas_call

    def capture(kern, **kw):
        bodies.append(kern)
        return real(kern, **dict(kw, interpret=True))

    mod.pl.pallas_call = capture
    try:
        assert mod.p2_big_prefetch(16 * 8) == 120
    finally:
        mod.pl.pallas_call = real
    G = x.shape[0]
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(G,),
        in_specs=[pl.BlockSpec((1, LANES), lambda i, *_: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, LANES), lambda i, *_: (i, 0),
                               memory_space=pltpu.VMEM))
    return np.asarray(real(
        bodies[0], grid_spec=spec, interpret=True,
        out_shape=jax.ShapeDtypeStruct((G, LANES), jnp.int32))(
            jnp.asarray(tab), jnp.asarray(x)))


@pytest.mark.parametrize("G", [1, 4, 33])
def test_torch_prefetch_network_matches_plain_and_pallas(G):
    """On tables whose row sums wrap past INT32_MAX (and below INT32_MIN),
    with a table longer than the rows need."""
    rng = np.random.RandomState(G)
    tab = rng.randint(2 ** 29, 2 ** 31, 16 * G + 7).astype(np.int32)
    tab[16:32] = -tab[16:32] - 1                      # a row below INT_MIN
    sums = tab[:16 * G].astype(np.int64).reshape(G, 16).sum(1)
    assert sums.max() > 2 ** 31 - 1
    x = rng.randint(-2 ** 31, 2 ** 31, (G, LANES),
                    dtype=np.int64).astype(np.int32)
    got = prefetch_network(tab, x)
    np.testing.assert_array_equal(got[:, 0], sums.astype(np.uint32).view(
        np.int32))
    np.testing.assert_array_equal(got, _pallas_prefetch(tab, x))
    np.testing.assert_array_equal(probes.big_prefetch_plain(
        torch.as_tensor(tab), torch.as_tensor(x)).numpy(), got)


class _FakeLib:
    """Stands in for the loaded library: error strings only."""

    @staticmethod
    def ffv2_error_string(err):
        return b"invalid argument" if err == 1 else b"unknown"


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_torch_kernel_launch_counts_and_raises(monkeypatch, name):
    """Every kernel's ``launch`` calls its bound launcher with the
    wrapper's arguments, counts one launch when it returns 0, and raises
    (counting nothing) on a nonzero cudaError_t; ``plain_for`` takes the
    plain version for CPU tensors only."""
    k = _build.KERNELS[name]
    monkeypatch.setattr(_build, "_lib", _FakeLib())
    calls, rc = [], [0]

    def launcher(*args):
        calls.append(args)
        return rc[0]

    monkeypatch.setattr(k, "_fn", launcher)
    monkeypatch.setattr(k, "launches", 0)
    monkeypatch.setattr(k, "plain_calls", 0)
    args = tuple(range(len(k.argtypes)))
    k.launch(*args)
    k.launch(*args)
    assert k.launches == 2 and calls == [args, args]
    rc[0] = 1
    with pytest.raises(RuntimeError,
                       match=f"{name} kernel: CUDA error 1: invalid"):
        k.launch(*args)
    assert k.launches == 2
    assert k.plain_for(torch.device("cpu")) and k.plain_calls == 1
    assert not k.plain_for(torch.device("cuda", 0)) and k.plain_calls == 1
    with pytest.raises(ValueError):
        k.plain_for(torch.device("meta"))


def test_torch_kernel_check_conditions():
    """``Kernel.check`` refuses each condition alone: type, shape (given
    as a tuple or a list), device and contiguity."""
    k = _build.KERNELS["roll"]
    t = torch.zeros((4, LANES), dtype=torch.int32)
    cpu = torch.device("cpu")
    k.check("x", t, (4, LANES), cpu)
    k.check("x", t, [4, LANES], cpu)
    for bad, shape, dev in ((t.long(), (4, LANES), cpu),
                            (t, (5, LANES), cpu), (t, (4, LANES, 1), cpu),
                            (t, (4, LANES), torch.device("meta")),
                            (torch.zeros((LANES, 4), dtype=torch.int32).T,
                             (4, LANES), cpu)):
        with pytest.raises(ValueError, match="roll: x must be"):
            k.check("x", bad, shape, dev)
