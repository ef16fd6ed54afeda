"""The order arguments of the redesigned tool kernels K10 (``roll_kernel``,
``ffmpeg_ffv2_tpu_torch/csrc/prims.cu``), K12 (``transpose_kernel``,
``csrc/prims.cu``), K14 (``scalar_in_ds_kernel``, ``csrc/probes.cu``) and
K15 (``big_prefetch_kernel``, ``csrc/probes.cu``), on the CPU; and the
launch path that every wrapper shares (``_build.Kernel``).

Each model below runs its kernel's design on numpy, lane by lane and
register by register: K10's row in a warp's registers (lane l holds
elements l + 32 k in register k), a shuffle from lane (l - s) & 31 for a
roll by s < 32 with lanes l < s taking register k - 1, renames of the
registers for s = 32 and 64, seven rolls a round and the reps % 7 tail;
K12's 32 x 32 tile in a block of four warps, each gathering its 8
registers (pairs j, 32 - j; 0 and 16) of the skewed layout (lane l,
register k: T[l][(l + k) & 31]),
each transpose a shuffle of register (32 - j) & 31 from lane (l + j) & 31
a register j, one register index for the whole warp, then + 1, and each
register k stored to row (l + k) & 31 of column l; K14's
one warp, four words of row 0 a lane, a max, five xor shuffles and
jnp's floor modulo picking the row; K15's warp a row, lanes l and l + 16
holding table word l, four xor shuffles adding in unsigned 32-bit
arithmetic, and lane l writing words l + 32 k, k < 4.  No model is a
plain version: each is held against the plain version and against the
TPU body of the JAX tool (``tools/microbench_pallas.py:roll_kernel`` and
``transpose_kernel``, ``tools/probe_mosaic.py``'s ``p1b_scalar_in_ds``
and ``p2_big_prefetch`` kernels), run in Pallas interpret mode."""

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


TILE, TILE_WARPS, TILE_SLOTS = 32, 4, 8


def slot_register(g, s):
    """The register of the skewed layout in slot s of warp g: slots 2p and
    2p + 1 hold j = 4 g + 1 + p and 32 - j; the last warp's slots 6 and 7
    hold registers 0 and 16."""
    if g == TILE_WARPS - 1 and s >= 6:
        return (s & 1) * 16
    j = 4 * g + 1 + (s >> 1)
    return TILE - j if s & 1 else j


def tiles_of(x):
    """The 32 x 32 tiles of x, t[n, r, c], in row-major tile order."""
    R, W = x.shape
    return (x.astype(np.uint32).reshape(R // TILE, TILE, W // TILE, TILE)
            .transpose(0, 2, 1, 3).reshape(-1, TILE, TILE))


def skewed_load(x, g):
    """K12's load for warp g: slot s of lane l (register k) gathers
    B[(l + k) & 31][l] of its tile B, the skewed layout of B^T."""
    t = tiles_of(x)
    v = np.empty((len(t), TILE, TILE_SLOTS), np.uint32)
    for s in range(TILE_SLOTS):
        v[:, :, s] = t[:, (LANE + slot_register(g, s)) & (TILE - 1), LANE]
    return v


def transpose_pass(v, g):
    """One transpose of warp g's slots v[t, l, s], then + 1: slot s
    (register j) takes the slot of register (32 - j) & 31 (its pair's, or
    its own for 0 and 16), one slot for every lane, from lane (l + j) & 31."""
    w = np.empty_like(v)
    for s in range(TILE_SLOTS):
        j = slot_register(g, s)
        src = s if g == TILE_WARPS - 1 and s >= 6 else s ^ 1
        assert slot_register(g, src) == (TILE - j) % TILE
        w[:, :, s] = v[:, (LANE + j) & (TILE - 1), src] + np.uint32(1)
    return w


def skewed_store(parts, shape):
    """Slot s of lane l in warp g (register k) is element ((l + k) & 31, l)
    of its tile."""
    R, W = shape
    tiles = np.empty((len(parts[0]), TILE, TILE), np.uint32)
    for g, v in enumerate(parts):
        for s in range(TILE_SLOTS):
            tiles[:, (LANE + slot_register(g, s)) & (TILE - 1), LANE] = \
                v[:, :, s]
    return (tiles.reshape(R // TILE, W // TILE, TILE, TILE)
            .transpose(0, 2, 1, 3).reshape(R, W).view(np.int32))


def transpose_network(x, reps):
    """K12 on numpy: each of a tile's four warps gathers its 8 registers
    of the skewed tile, runs 2 reps transposes on them and stores them."""
    parts = []
    for g in range(TILE_WARPS):
        v = skewed_load(x, g)
        for _ in range(reps):
            v = transpose_pass(transpose_pass(v, g), g)
        parts.append(v)
    return skewed_store(parts, x.shape)


def skew(t):
    """The skewed layout of tiles t[n, r, c]: lane l, register k holds
    t[l][(l + k) & 31]."""
    k = np.arange(TILE)
    return t[:, LANE[:, None], (LANE[:, None] + k[None, :]) & (TILE - 1)]


def _wrapping(rng, shape):
    x = rng.randint(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
    x[shape[0] // 2] = 2 ** 31 - 1 - np.arange(shape[1]) % 3   # + 1 wraps
    return x.astype(np.int32)


@pytest.mark.parametrize("shape", [(32, 32), (64, 96), (512, 128)])
@pytest.mark.parametrize("reps", [0, 1, 3, 32])
def test_torch_transpose_network_matches_plain_and_pallas(shape, reps):
    mbp = _load("microbench_pallas")
    x = _wrapping(np.random.RandomState(reps + shape[1]), shape)
    want = np.asarray(pl.pallas_call(
        functools.partial(mbp.transpose_kernel, reps=reps),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
        interpret=True)(jnp.asarray(x)))
    got = transpose_network(x, reps)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        mp.transpose_plain(torch.as_tensor(x), reps).numpy(), got)


def test_torch_transpose_skewed_layout():
    """The slots hold each register once, 31 of them shuffled a transpose
    and at most 8 a warp; the warps' loads hold the skew of each tile's
    transpose and the store puts it back; one pass takes each warp's
    registers of the skew of T to those of the skew of T^T + 1, and two
    give back T + 2."""
    regs = [slot_register(g, s) for g in range(TILE_WARPS)
            for s in range(TILE_SLOTS)]
    assert sorted(regs) == list(range(TILE))
    x = _wrapping(np.random.RandomState(5), (64, 96))
    tiles = tiles_of(x)
    parts = [skewed_load(x, g) for g in range(TILE_WARPS)]
    v = np.empty((len(tiles), TILE, TILE), np.uint32)
    for g, p in enumerate(parts):
        v[:, :, [slot_register(g, s) for s in range(TILE_SLOTS)]] = p
    np.testing.assert_array_equal(v, skew(tiles.transpose(0, 2, 1)))
    np.testing.assert_array_equal(skewed_store(parts, x.shape), x)
    want = skew(tiles) + np.uint32(1)
    for g, p in enumerate(parts):
        mine = [slot_register(g, s) for s in range(TILE_SLOTS)]
        w = transpose_pass(p, g)
        np.testing.assert_array_equal(w, want[:, :, mine])
        np.testing.assert_array_equal(transpose_pass(w, g), p + np.uint32(2))


def floor_mod(a, m):
    """probes.cu's floor_mod: C's truncating %, then + m below 0."""
    r = np.fmod(a, m)
    return np.where(r < 0, r + m, r)


def in_ds_network(v):
    """K14 on numpy: lane l takes the max of row 0's words l + 32 k (k <
    4), five xor shuffles spread the row's max, and lane l copies words
    l + 32 k of row floor_mod(max, 4)."""
    m = v[0].reshape(REGS, WARP).max(0)
    for o in (16, 8, 4, 2, 1):
        m = np.maximum(m, m[LANE ^ o])
    assert (m == m[0]).all()
    row = floor_mod(m.astype(np.int64), 4)
    lanes = LANE[:, None] + WARP * np.arange(REGS)[None, :]
    out = np.empty((1, LANES), np.int32)
    out[0, lanes] = v[row[:, None], lanes]
    return out


def _pallas_in_ds(v):
    """The kernel body of probe_mosaic.p1b_scalar_in_ds (captured from the
    tool's own call) on ``v``, its scratch sized to v."""
    mod = _load("probe_mosaic")
    bodies = []
    real = pl.pallas_call

    def capture(kern, **kw):
        bodies.append(kern)
        return real(kern, **dict(kw, interpret=True))

    mod.pl.pallas_call = capture
    try:
        assert mod.p1b_scalar_in_ds() == 4
    finally:
        mod.pl.pallas_call = real
    return np.asarray(real(
        bodies[0], interpret=True,
        out_shape=jax.ShapeDtypeStruct((1, LANES), jnp.int32),
        scratch_shapes=[pltpu.VMEM(v.shape, jnp.int32)])(jnp.asarray(v)))


@pytest.mark.parametrize("R", [4, 8, 300])
@pytest.mark.parametrize("top", [-1, -2, -3, -4, -2 ** 31, 2 ** 31 - 1])
def test_torch_in_ds_network_matches_plain_and_pallas(R, top):
    """Row 0's max ``top`` picks row floor_mod(top, 4): negative maxima
    take jnp's floor modulo, not C's; R = 300 lies past the old 256-row
    cap of the wrapper."""
    rng = np.random.RandomState(R + top % 97)
    v = rng.randint(-2 ** 31, 2 ** 31, (R, LANES), dtype=np.int64)
    v[0] = top - rng.randint(0, top + 2 ** 31 + 1, LANES, dtype=np.int64)
    v[0, rng.randint(LANES)] = top
    v = v.astype(np.int32)
    got = in_ds_network(v)
    np.testing.assert_array_equal(got[0], v[top % 4])
    np.testing.assert_array_equal(got, _pallas_in_ds(v))
    np.testing.assert_array_equal(
        probes.scalar_in_ds_plain(torch.as_tensor(v)).numpy(), got)
    np.testing.assert_array_equal(
        probes.scalar_in_ds(torch.as_tensor(v)).numpy(), got)


@pytest.mark.parametrize("R", [8, 300, 4096])
def test_torch_probe_bounds_count_the_words_moved(R):
    """The probes' bound bytes: K14 reads row 0 and the row it picks and
    writes one, whatever R; K15 reads 16 table words a row, not the table;
    K13 reads v and writes v's shape."""
    v = torch.zeros((R, LANES), dtype=torch.int32)
    assert probes._bytes(probes._K14, (v,), probes.scalar_in_ds(v)) == \
        3 * LANES * 4
    x4 = torch.zeros((4, LANES), dtype=torch.int32)
    tab = torch.zeros(R * LANES, dtype=torch.int32)
    assert probes._bytes(probes._K15, (tab, x4), x4) == \
        (2 * 4 * LANES + 16 * 4) * 4
    assert probes._bytes(probes._K13, (v,), v) == 2 * R * LANES * 4


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
