"""The order arguments of the redesigned tool kernels K10 (``roll_kernel``,
``ffmpeg_ffv2_tpu_torch/csrc/prims.cu``), K12 (``transpose_kernel``,
``csrc/prims.cu``), K13 (``scalar_extract_warp_kernel`` and, past 8 rows,
``scalar_extract_block_kernel``, ``csrc/probes.cu``), K14
(``scalar_in_ds_kernel``), K15 (``big_prefetch_kernel``), K16
(``roll_dynamic_kernel``) and K17 (``taa_rows_kernel``, all four
``csrc/probes.cu``), on the CPU; and
the launch path that every wrapper shares (``_build.Kernel``).

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
register k stored to row (l + k) & 31 of column l; K13's one warp up to
8 rows (lane l holding words l + 32 k, k < 4 R, in its 32 registers,
INT_MIN in the rest, their max, five xor shuffles, each word plus the max
in unsigned 32-bit arithmetic), and past
8 rows its block of 1024 threads (a grid-stride max from INT_MIN, each
warp's xor shuffles, the 32 warps' maxima combined by warp 0); K14's
one warp, four words of row 0 a lane, a max, five xor shuffles and
jnp's floor modulo picking the row; K15's warp a row, lanes l and l + 16
holding table word l, four xor shuffles adding in unsigned 32-bit
arithmetic, and lane l writing words l + 32 k, k < 4; K16's warps of two
rows, each reducing row 0 itself (four words a lane, five xor shuffles,
the floor modulo twice), then loading word (l + 32 k - sh) & 127 of each
of its rows and storing it at l + 32 k, the grid's last warp, when short
of rows, copying its one row; K17's warp a row in blocks of four, lane
l holding idx words and the row's words l + 32 k, each output word four
shuffles (one a register, from lane idx & 31) and a select on idx >> 5.
No model is a
plain version: each is held against the plain version and against the
TPU body of the JAX tool (``tools/microbench_pallas.py:roll_kernel`` and
``transpose_kernel``, ``tools/probe_mosaic.py``'s ``p1_scalar_extract``,
``p1b_scalar_in_ds``, ``p2_big_prefetch``, ``p4_roll_dynamic`` and
``p5_taa_rows`` kernels), run in Pallas interpret mode."""

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


@functools.lru_cache(maxsize=None)
def _tool_body(probe, expected):
    """The kernel body of ``probe_mosaic.<probe>``, captured from the
    tool's own call (run in interpret mode, its result checked)."""
    mod = _load("probe_mosaic")
    bodies = []
    real = pl.pallas_call

    def capture(kern, **kw):
        bodies.append(kern)
        return real(kern, **dict(kw, interpret=True))

    mod.pl.pallas_call = capture
    try:
        assert getattr(mod, probe)() == expected
    finally:
        mod.pl.pallas_call = real
    return bodies[0]


def _pallas_in_ds(v):
    """The kernel body of probe_mosaic.p1b_scalar_in_ds on ``v``, its
    scratch sized to v."""
    return np.asarray(pl.pallas_call(
        _tool_body("p1b_scalar_in_ds", 4), interpret=True,
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


INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
SE_WARP_ROWS, BLOCK = 8, 1024        # K13's one-warp rows, its block
ROLL_ROWS = 2                        # K16's rows a warp


def butterfly_max(m):
    """Five __shfl_xor_sync max steps over the last axis, a warp's lanes;
    every lane ends with the warp's max."""
    for o in (16, 8, 4, 2, 1):
        m = np.maximum(m, m[..., LANE ^ o])
    assert (m == m[..., :1]).all()
    return m


def scalar_extract_network(v):
    """K13 on numpy.  Up to 8 rows, one warp: lane l holds words l + 32 k
    in registers k < 4 R of its 32 and INT_MIN in the rest (neither loaded
    nor stored), the max of all 32, the butterfly, each word plus the max
    (uint32).
    Past 8 rows, the block: thread t's max from INT_MIN over words t +
    1024 j, each warp's butterfly, warp 0's butterfly over the 32 warps'
    maxima, then the add."""
    R = v.shape[0]
    x = v.reshape(-1).astype(np.int64)
    if R <= SE_WARP_ROWS:
        n = 4 * R
        # w[l, k]: lane l's register k, word l + 32 k where k < n
        w = np.full((WARP, SE_WARP_ROWS * REGS), INT_MIN, np.int64)
        w[:, :n] = x.reshape(n, WARP).T
        m = butterfly_max(w.max(1))
        out = (w[:, :n] + m[:, None]).astype(np.uint32).T
    else:
        m = np.full(BLOCK, INT_MIN, np.int64)
        for j in range(-(-x.size // BLOCK)):
            e = np.arange(BLOCK) + BLOCK * j
            m = np.where(e < x.size, np.maximum(m, x[np.minimum(
                e, x.size - 1)]), m)
        red = butterfly_max(m.reshape(BLOCK // WARP, WARP))[:, 0]
        out = (x + butterfly_max(red)[0]).astype(np.uint32)
    return out.reshape(R, LANES).view(np.int32)


def roll_dynamic_network(v):
    """K16 on numpy: warp g takes rows 2 g, 2 g + 1; each warp reduces
    row 0 itself (four words a lane, the butterfly) and takes sh =
    floor_mod(128 - floor_mod(max, 128), 128).  A warp whose rows all lie
    below R loads word (l + 32 k - sh) & 127 of each of them, then stores
    each at l + 32 k; the last warp, short of rows, copies its one row."""
    R = v.shape[0]
    out = np.full_like(v, 12345)
    words = LANE[:, None] + WARP * np.arange(REGS)[None, :]   # [l, k]

    def rows(r0, n, sh):
        w = [v[r0 + j, (words - sh[:, None]) & (LANES - 1)]
             for j in range(n)]
        for j in range(n):
            out[r0 + j, words] = w[j]

    for g in range(-(-R // ROLL_ROWS)):
        m = butterfly_max(v[0].reshape(REGS, WARP).max(0).astype(np.int64))
        sh = floor_mod(LANES - floor_mod(m, LANES), LANES)     # every lane
        r0 = ROLL_ROWS * g
        rows(r0, ROLL_ROWS if r0 + ROLL_ROWS <= R else 1, sh)
    return out


def _pallas_same_shape(probe, expected, v):
    return np.asarray(pl.pallas_call(
        _tool_body(probe, expected), interpret=True,
        out_shape=jax.ShapeDtypeStruct(v.shape, jnp.int32))(jnp.asarray(v)))


def _extract_input(rng, R, case):
    """int32 (R, 128) whose max lies in the last row: INT_MAX (the add
    wraps), INT_MIN everywhere (INT_MIN + INT_MIN wraps to 0), all
    negative with max -1, or random."""
    if case == "int_min":
        return np.full((R, LANES), INT_MIN, np.int32)
    hi = {"int_max": INT_MAX, "minus_1": -1, "random": 2 ** 20}[case]
    v = rng.randint(INT_MIN, hi, (R, LANES), dtype=np.int64)
    v[R - 1, rng.randint(LANES)] = hi
    return v.astype(np.int32)


@pytest.mark.parametrize("R", [1, 7, 8, 9, 24, 300])
@pytest.mark.parametrize("case", ["int_max", "int_min", "minus_1",
                                  "random"])
def test_torch_scalar_extract_network_matches_plain_and_pallas(R, case):
    """K13's one warp (R = 1, 7, 8: registers past 4 R unused at 1 and 7)
    and its block (R = 9, 24, 300) equal the plain version, the CPU
    wrapper and the p1_scalar_extract body."""
    v = _extract_input(np.random.RandomState(R), R, case)
    got = scalar_extract_network(v)
    want = (v.astype(np.int64) + v.max()).astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _pallas_same_shape("p1_scalar_extract", 1023, v))
    t = torch.as_tensor(v)
    np.testing.assert_array_equal(probes.scalar_extract_plain(t).numpy(), got)
    np.testing.assert_array_equal(probes.scalar_extract(t).numpy(), got)


@pytest.mark.parametrize("R", [1, 8, 9, 300])
@pytest.mark.parametrize("top", [-1, -2, -3, -4, -128, -129, INT_MIN,
                                 INT_MAX])
def test_torch_roll_dynamic_network_matches_plain_and_pallas(R, top):
    """K16's warps of two rows, each finding the shift from row 0's max
    ``top``: at negative maxima jnp's floor modulo and C's differ in the
    inner step (-129: 127 against -1) but give the same shift (1); an odd
    R leaves a warp's second row past the array."""
    rng = np.random.RandomState(R + top % 97)
    v = rng.randint(INT_MIN, INT_MAX, (R, LANES), dtype=np.int64)
    v[0] = top - rng.randint(0, top - INT_MIN + 1, LANES, dtype=np.int64)
    v[0, rng.randint(LANES)] = top
    v = v.astype(np.int32)
    got = roll_dynamic_network(v)
    np.testing.assert_array_equal(got, np.roll(v, (LANES - top % LANES)
                                               % LANES, axis=1))
    np.testing.assert_array_equal(
        got, _pallas_same_shape("p4_roll_dynamic", 127, v))
    t = torch.as_tensor(v)
    np.testing.assert_array_equal(probes.roll_dynamic_plain(t).numpy(), got)
    np.testing.assert_array_equal(probes.roll_dynamic(t).numpy(), got)


def test_torch_probe_edge_inputs_are_hostile():
    """``probes.edge_inputs`` (``chip_smoke.py`` phase 14's K13, K16 and
    K17 beside the tools' rows) holds what it says: K13's max INT_MAX,
    K16's row-0 max -129, the rows of ``EDGE_ROWS``; K17 at the rows of
    ``TAA_EDGE_ROWS`` with every idx pattern; the CPU wrappers equal the
    numpy models there."""
    cases = probes.edge_inputs("cpu")
    rows = {}
    for _, K, _, _, args in cases:
        rows.setdefault(K.name, []).append(args[0].shape[0])
    n_pat = len(probes.TAA_PATTERNS)
    assert rows == {"probe_scalar_extract": list(probes.EDGE_ROWS),
                    "probe_roll_dynamic": list(probes.EDGE_ROWS),
                    "probe_taa_rows": [R for R in probes.TAA_EDGE_ROWS
                                       for _ in range(n_pat)]}
    patterns = set()
    for label, K, fn, plain, args in cases:
        x = args[0].numpy()
        if K is probes._K13:
            assert x.max() == INT_MAX, label
            want = scalar_extract_network(x)
        elif K is probes._K16:
            assert x[0].max() == -129, label
            want = roll_dynamic_network(x)
        else:
            idx = args[1].numpy()[0]
            pattern = label.split("idx ")[1]
            patterns.add(pattern)
            if pattern == "permutation":
                assert sorted(idx) == list(range(LANES)), label
            else:
                np.testing.assert_array_equal(
                    idx, probes.taa_index(pattern), label)
            want = taa_rows_network(x, idx)
        np.testing.assert_array_equal(fn(*args).numpy(), want)
        np.testing.assert_array_equal(plain(*args).numpy(), want)
    assert patterns == set(probes.TAA_PATTERNS)


TAA_WARPS = 4                        # K17's warps a block, a row each


def taa_rows_network(v, idx):
    """K17 on numpy: warp w of block b takes row 4 b + w (a warp past R
    does nothing); lane l loads idx words l + 32 k into src[k] and the
    row's words l + 32 k into w[k], all before any use; output word
    l + 32 k is the select on src[k] >> 5 among four shuffles, one of
    each register w[0..3], from lane src[k] & 31."""
    R = v.shape[0]
    out = np.full_like(v, 12345)
    src = idx.reshape(REGS, WARP).T                       # [l, k]
    words = LANE[:, None] + WARP * np.arange(REGS)[None, :]
    for b in range(-(-R // TAA_WARPS)):
        for wp in range(TAA_WARPS):
            r = b * TAA_WARPS + wp
            if r >= R:
                continue
            w = v[r, words]                               # [l, k]
            o = np.empty((WARP, REGS), v.dtype)
            for k in range(REGS):
                s, hi = src[:, k] & 31, src[:, k] >> 5
                shf = [w[s, reg] for reg in range(REGS)]
                o[:, k] = np.select([hi == 0, hi == 1, hi == 2], shf[:3],
                                    shf[3])
            out[r, words] = o
    return out


def _pallas_taa_rows(v, idx):
    """The kernel body of probe_mosaic.p5_taa_rows (written for 10 rows)
    over v's rows in blocks of 10 (v padded with copies of row 0), a grid
    step a block."""
    R = v.shape[0]
    n = -(-R // 10)
    x = np.concatenate([v, np.repeat(v[:1], 10 * n - R, 0)])
    return np.asarray(pl.pallas_call(
        _tool_body("p5_taa_rows", True), interpret=True, grid=(n,),
        in_specs=[pl.BlockSpec((10, LANES), lambda i: (i, 0)),
                  pl.BlockSpec((1, LANES), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((10, LANES), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32))(
            jnp.asarray(x), jnp.asarray(idx.astype(np.int32)[None, :])))[:R]


@pytest.mark.parametrize("R", [1, 9, 10, 4096])
@pytest.mark.parametrize("pattern", ["7 l mod 128", "permutation", "all 0",
                                     "all 127", "identity"])
def test_torch_taa_rows_network_matches_plain_and_pallas(R, pattern):
    """K17's warp a row, each output word four shuffles and a select,
    equals the plain version, the CPU wrapper and the p5_taa_rows body:
    one row (one warp), 9 and the tool's 10 (the last block short of
    warps), 4096 (1024 full blocks); idx the tool's 7 l mod 128, a seeded
    permutation, all 0, all 127 (every word from lane 31's register 3)
    and the identity."""
    rng = np.random.RandomState(R)
    v = rng.randint(INT_MIN, INT_MAX, (R, LANES), dtype=np.int64).astype(
        np.int32)
    idx = probes.taa_index(pattern, rng)
    assert pattern in probes.TAA_PATTERNS
    got = taa_rows_network(v, idx)
    np.testing.assert_array_equal(got, v[:, idx])
    np.testing.assert_array_equal(got, _pallas_taa_rows(v, idx))
    t, ti = torch.as_tensor(v), torch.as_tensor(idx.astype(np.int32)[None])
    np.testing.assert_array_equal(probes.taa_rows_plain(t, ti).numpy(), got)
    np.testing.assert_array_equal(probes.taa_rows(t, ti).numpy(), got)


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
