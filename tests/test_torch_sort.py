"""The port's row sort (ffmpeg_ffv2_tpu_torch.ops.sort) against the JAX
package's ops/sort_pallas.py: the phase plan equals ``_plan``, the plain
bitonic network equals ``jax.lax.sort`` on duplicate-free keys and the
Pallas kernels (interpret mode) element for element on duplicate keys,
in both of their branches; the op's contract on CPU tensors."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ffmpeg_ffv2_tpu.ops import sort_pallas as sp
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.ops import sort
from ffmpeg_ffv2_tpu_torch.tools import microbench_sort as mbs
from test_torch_formats import torch_one_thread  # noqa: F401

INT32_MAX = np.iinfo(np.int32).max


def _eq(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("L", range(10, 23))
def test_torch_sort_plan_matches_jax(L):
    for Lc in range(1, L + 1):
        for a, b in zip(sort.plan(L, Lc), sp._plan(L, Lc)):
            assert a.dtype == b.dtype and np.array_equal(a, b), (L, Lc)


@pytest.mark.parametrize("L", [10, 13, 17, 22])
def test_torch_sort_plan_expands_to_the_network(L):
    """Every chunking runs the unchunked stage table's sub-stages in its
    order."""
    full = [(k, j) for k in range(L) for j in range(k, -1, -1)]
    _, ks, js = sort.plan(L, L)
    assert list(zip(ks.tolist(), js.tolist())) == full
    for Lc in range(1, L + 1):
        assert sort.substages(*sort.plan(L, Lc)) == full, Lc


@pytest.mark.parametrize("L", range(1, 21))
def test_torch_sort_plan_merged_expands_to_the_network(L):
    """plan_merged keeps plan's local phases and cuts each k's cross
    sub-stages j = k .. Lc into ceil(m / R) groups of at most R, in order;
    its sub-stages are the unchunked network's, for every Lc and R."""
    full = [(k, j) for k in range(L) for j in range(k, -1, -1)]
    for Lc in range(1, L + 1):
        ref, ks, js = sort.plan(L, Lc)
        for R in range(1, 6):
            phases, mks, mjs = sort.plan_merged(L, Lc, R)
            assert phases.dtype == np.int32 and phases.shape[1] == 4
            assert np.array_equal(mks, ks) and np.array_equal(mjs, js)
            assert sort.substages(phases, mks, mjs) == full, (Lc, R)
            local = phases[phases[:, 0] == sort.LOCAL]
            assert np.array_equal(local[:, 1:3], ref[ref[:, 0] ==
                                                     sort.LOCAL][:, 1:])
            merged = phases[phases[:, 0] == sort.MERGED]
            assert ((merged[:, 3] >= 1) & (merged[:, 3] <= R)).all()
            assert (merged[:, 2] - merged[:, 3] + 1 >= Lc).all()
            assert len(merged) == sum(-(-(k - Lc + 1) // R)
                                      for k in range(Lc, L))
    with pytest.raises(ValueError):
        sort.plan_merged(L, 1, 0)


def _pallas_case(B, M, n_ops, num_keys, seed):
    """tests/test_sort_pallas.py:_case's operands (unique keys, an
    INT32_MAX padded tail; for 2 keys a duplicated key0 and unique
    (key0, key1))."""
    rng = np.random.RandomState(seed)
    key = np.stack([rng.permutation(M).astype(np.int32) for _ in range(B)])
    npad = M // 5
    key[:, M - npad:] = INT32_MAX - np.arange(npad)
    ops = [key]
    if num_keys == 2:
        k0 = rng.randint(0, 7, (B, M)).astype(np.int32)
        k1 = np.stack([rng.permutation(M).astype(np.int32)
                       for _ in range(B)])
        ops = [k0, k1]
    for _ in range(n_ops - len(ops)):
        ops.append(rng.randint(-2**31, 2**31 - 1, (B, M), dtype=np.int32))
    return ops


@pytest.mark.parametrize("B,M,n_ops,num_keys,seed", [
    (1, 1024, 1, 1, 101), (3, 1024, 2, 1, 302), (2, 2048, 3, 2, 203),
    (1, 4096, 9, 1, 109), (2, 8192, 2, 1, 202),
    (1, 8192, 2, 1, 7), (1, 16384, 4, 1, 11)])
def test_torch_bitonic_plain_matches_lax_sort(B, M, n_ops, num_keys, seed):
    """Every case of tests/test_sort_pallas.py (the VMEM cases, then the
    hierarchical ones)."""
    ops = _pallas_case(B, M, n_ops, num_keys, seed)
    want = jax.lax.sort(tuple(jnp.asarray(o) for o in ops),
                        num_keys=num_keys, dimension=1)
    _eq(sort.bitonic_plain([torch.as_tensor(o) for o in ops], num_keys),
        want)


def _dup_ops(B, M, n_ops, num_keys, seed):
    rng = np.random.RandomState(seed)
    ops = [rng.randint(0, 50, (B, M)).astype(np.int32)]
    if num_keys == 2:
        ops.append(rng.randint(0, 3, (B, M)).astype(np.int32))
    ops[0][:, :M // 8] = INT32_MAX          # sentinels, duplicated too
    for _ in range(n_ops - len(ops)):
        ops.append(rng.randint(-2**31, 2**31 - 1, (B, M), dtype=np.int64)
                   .astype(np.int32))
    return ops


@pytest.mark.parametrize("B,M,n_ops,num_keys,kw", [
    (2, 2048, 2, 1, {}),
    (2, 2048, 3, 2, {}),
    (1, 8192, 2, 1, dict(chunk_log2=10, vmem_budget=10 * 1024 * 4)),
    (1, 16384, 3, 2, dict(chunk_log2=11, vmem_budget=14 * 2048 * 4))])
def test_torch_bitonic_plain_matches_pallas_on_duplicates(B, M, n_ops,
                                                          num_keys, kw):
    """Among duplicate keys the order is the network's: the plain version
    equals the Pallas kernels element for element, in the VMEM branch
    (_rowsort_kernel) and the hierarchical one (_sort_kernel)."""
    ops = _dup_ops(B, M, n_ops, num_keys, seed=M + n_ops)
    budget = kw.get("vmem_budget", 10 << 20)
    assert (B > 1 or n_ops * M * 4 <= budget) == (not kw)
    want = sp.sort_rows_pallas([jnp.asarray(o) for o in ops], num_keys,
                               interpret=True, **kw)
    got = sort.bitonic_plain([torch.as_tensor(o) for o in ops], num_keys)
    _eq(got, want)
    # the network is not stable: the case must tell the two orders apart
    stable = jax.lax.sort(tuple(jnp.asarray(o) for o in ops),
                          num_keys=num_keys, dimension=1, is_stable=True)
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(want[num_keys:], stable[num_keys:]))


@pytest.mark.parametrize("num_keys", [1, 2])
def test_torch_bitonic_plain_chunking_invariant(num_keys):
    ops = [torch.as_tensor(o) for o in _dup_ops(2, 4096, 3, num_keys, 5)]
    whole = sort.bitonic_plain(ops, num_keys)
    for c in (1, 5, 8, 10, 11, 12, 20):
        for a, b in zip(sort.bitonic_plain(ops, num_keys, chunk_log2=c),
                        whole):
            assert torch.equal(a, b), c


def _indexed_cases():
    """(name, operands, num_keys): the duplicate-key cases and the Pallas
    cases, for one and two keys, from n = num_keys + 1 (the kernels'
    direct mode) up to 12 operands."""
    for nk in (1, 2):
        for n in (nk + 1, nk + 2, 5, 12):
            yield (f"dup nk={nk} n={n}", _dup_ops(2, 2048, n, nk, 31 + n),
                   nk)
            yield (f"pallas nk={nk} n={n}",
                   _pallas_case(1, 4096, n, nk, 41 + n), nk)
    yield "dup 1 op", _dup_ops(3, 1024, 1, 1, 5), 1


@pytest.mark.parametrize("case", list(_indexed_cases()),
                         ids=lambda c: c[0])
def test_torch_bitonic_plain_indexed_matches_plain(case):
    """Keys and an int32 column through the network, then a gather of every
    payload, equal the network on all operands element for element,
    duplicate keys (and their INT32_MAX sentinels) included; chunked as
    the kernels chunk too."""
    _, ops, nk = case
    ops = [torch.as_tensor(o) for o in ops]
    want = sort.bitonic_plain(ops, nk)
    for chunk in (None, 9):
        got = sort.bitonic_plain_indexed(ops, nk, chunk_log2=chunk)
        assert len(got) == len(ops)
        for a, b in zip(got, want):
            assert torch.equal(a, b), chunk


@pytest.mark.parametrize("num_keys", [1, 2])
def test_torch_bitonic_plain_merged_order(num_keys):
    """The network run in plan_merged's order (chunks and merge groups
    the kernels use) equals the unchunked network."""
    ops = [torch.as_tensor(o) for o in _dup_ops(2, 8192, 4, num_keys, 17)]
    whole = sort.bitonic_plain(ops, num_keys)
    for c, R in ((8, 1), (8, 4), (9, 5), (10, 2), (3, 3), (13, 4)):
        got = sort.bitonic_plain(ops, num_keys, chunk_log2=c, merge=R)
        for a, b in zip(got, whole):
            assert torch.equal(a, b), (c, R)


def test_torch_sort_geometry():
    """What the kernels run at the tools' shapes on an H100: index mode
    carries the keys and the column (W = num_keys + 1) past one payload,
    direct mode the operands; the chunk follows W; one call's kernels."""
    def geo(n, nk, B, M):
        g = sort.geometry(n, nk, B, M)
        return (g["mode"], g["W"], g["Lc"], g["local"], g["merged"],
                g["gather"], g["kernels"])

    assert geo(10, 1, 1, 1 << 22) == ("index", 2, 14, 9, 12, 1, 22)
    assert geo(7, 1, 1, 1 << 22) == geo(10, 1, 1, 1 << 22)
    assert geo(9, 1, 30, 1 << 17) == ("index", 2, 14, 4, 3, 1, 8)
    assert geo(2, 1, 30, 1 << 17) == ("direct", 2, 14, 4, 3, 0, 7)
    assert geo(3, 2, 30, 1 << 17) == ("direct", 3, 14, 4, 3, 0, 7)
    assert geo(5, 2, 30, 1 << 17) == ("index", 3, 14, 4, 3, 1, 8)
    assert geo(1, 1, 200, 1 << 15) == ("direct", 1, 14, 2, 1, 0, 3)
    assert geo(17, 2, 200, 1 << 14) == ("index", 3, 14, 1, 0, 1, 2)
    # one row of 2^16 holds 4 chunks of 2^14: the chunk shrinks to 2^10
    # (64 blocks; no smaller)
    assert geo(4, 1, 1, 1 << 16) == ("index", 2, 10, 7, 8, 1, 16)
    # merging took x 10's cross passes from 36 to 12
    assert (sort.plan(22, 14)[0][:, 0] == sort.CROSS).sum() == 36


def test_torch_sort_rows_cpu_contract(monkeypatch):
    """On CPU tensors sort_rows takes the plain version (counted on the
    body the JAX branch rule picks) and raises where the JAX op asserts."""
    ops = [torch.as_tensor(o) for o in _dup_ops(3, 1024, 2, 1, 9)]
    _build.reset_counts()
    got = sort.sort_rows(ops)
    for a, b in zip(got, sort.bitonic_plain(ops)):
        assert torch.equal(a, b)
    assert (_build.KERNELS["rowsort"].plain_calls,
            _build.KERNELS["sort"].plain_calls) == (1, 0)
    assert sort.body_for(1, 1 << 22, 7).name == "sort"
    assert sort.body_for(1, 1 << 20, 3).name == "sort"   # 12 MB in one row
    assert sort.body_for(1, 1 << 16, 4).name == "rowsort"
    assert sort.body_for(30, 1 << 17, 9).name == "rowsort"
    monkeypatch.setattr(sort, "VMEM_BUDGET", 4096)
    one = [o[:1].clone() for o in ops]
    got = sort.sort_rows(one)                         # now the flat body
    assert _build.KERNELS["sort"].plain_calls == 1
    for a, b in zip(got, sort.bitonic_plain(one)):
        assert torch.equal(a, b)
    bad = [
        ([torch.zeros((2, 1536), dtype=torch.int32)], 1),    # not 2^k
        ([torch.zeros((2, 512), dtype=torch.int32)], 1),     # < 1024
        (ops, 3),                                            # num_keys
        (ops[:1], 2),                                        # too few
        ([ops[0], ops[1].long()], 1),                        # dtype
        ([ops[0], ops[1][:2]], 1),                           # shape
        ([], 1)]
    for operands, nk in bad:
        with pytest.raises(ValueError):
            sort.sort_rows(operands, nk)
    with pytest.raises(ValueError):                          # other device
        sort.sort_rows([t.to("meta") for t in ops])


def test_torch_sort_chunk_log2_for():
    """The chunk for the H100's 227 KB of opt-in shared memory."""
    smem = 227 * 1024
    assert [sort.chunk_log2_for(n, smem) for n in (1, 2, 4, 6, 7, 9, 10)] == [
        15, 14, 13, 13, 13, 12, 12]
    with pytest.raises(ValueError):
        sort.chunk_log2_for(40000, smem)
    assert sort.compare_exchanges(1 << 22) == (1 << 22) * 22 * 23 // 4


@pytest.mark.parametrize("kind", ["perm", "slice", "global", "rand30"])
def test_torch_microbench_sort_cpu(kind):
    """The tool's cases at a small size on the CPU: its operands, the plain
    version (through the op) against itself and the library, and every
    line saying it ran on the CPU."""
    if kind == "global":
        M = 1 << 22
        ops = mbs.make_operands(kind, 1, M, 2)
        assert ops[0].shape == (1, M) and (ops[0][0, mbs.S * mbs.CAP:]
                                          == INT32_MAX).all()
        return
    r = mbs.run_case(kind, 2, 2048, 3, kind, device="cpu", reps=1)
    assert r["exact_plain"] and r["exact_library"] and r["kernel"] == \
        "rowsort"
    # 2 x 2048 keys of 30 random bits happen to be distinct
    assert r["unique_keys"] == (kind != "slice")
    assert r["library_compared"] == ("keys only" if kind == "slice"
                                     else "all operands")
    assert "cpu" in mbs.line(r)
    assert (r["mode"], r["W"], r["Lc"], r["R"], r["kernels"]) == (
        "index", 2, 10, sort.MERGE_R, 4)
    assert r["profiled_ms"] is None and "not measured" in mbs.line(r)
