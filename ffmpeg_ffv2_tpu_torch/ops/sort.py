"""Multi-operand bitonic row sort.

Counterpart of ``ffmpeg_ffv2_tpu/ops/sort_pallas.py:sort_rows_pallas``
and of its two TPU kernel bodies: ``_sort_kernel`` (``_sort_flat``, the
hierarchical sort of one long row) and ``_rowsort_kernel``
(``_sort_vmem``, the whole stage table on each row).  ``sort_rows``
launches ``csrc/sort.cu`` (K8 ``ffv2_sort`` or K9 ``ffv2_rowsort``, by the
JAX op's branch rule) on CUDA tensors and takes the plain
``bitonic_plain`` on CPU tensors.

The network: for ``k`` in ``0..L-1`` and ``j`` in ``k..0`` one
compare-exchange sub-stage pairs element ``g`` with ``g ^ (1 << j)``; the
pair sorts ascending iff bit ``k + 1`` of the lower index is 0, and swaps
only where the keys (signed int32, lexicographic over ``num_keys``
operands) are strictly out of order.  Every sub-stage is a fixed function
of its input, so the output, the order among equal keys included, is the
same for every chunking of the schedule (``plan``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

_K8 = _build.KERNELS["sort"]
_K9 = _build.KERNELS["rowsort"]

LOCAL, CROSS = 0, 1
VMEM_BUDGET = 10 << 20      # the JAX op's branch rule (sort_pallas.py:318)
_stage_tables = {}


def plan(L: int, Lc: int):
    """Phase descriptors and the stage table for sorting 2^L elements in
    2^Lc-element chunks (a copy of ``sort_pallas._plan``): phases (P, 3)
    int32 rows (LOCAL, first stage, end stage) or (CROSS, k, j), and the
    stage table's ks, js."""
    stages = []
    phases = []
    s0 = len(stages)
    for k in range(Lc):
        for j in range(k, -1, -1):
            stages.append((k, j))
    phases.append((LOCAL, s0, len(stages)))
    for k in range(Lc, L):
        for j in range(k, Lc - 1, -1):
            phases.append((CROSS, k, j))
        s0 = len(stages)
        for j in range(Lc - 1, -1, -1):
            stages.append((k, j))
        phases.append((LOCAL, s0, len(stages)))
    return (np.asarray(phases, np.int32),
            np.asarray([k for k, _ in stages], np.int32),
            np.asarray([j for _, j in stages], np.int32))


def substages(phases, ks, js) -> list:
    """The (k, j) sub-stages of a plan in the order its phases run them."""
    out = []
    for typ, a, b in phases.tolist():
        if typ == LOCAL:
            out += list(zip(ks[a:b].tolist(), js[a:b].tolist()))
        else:
            out.append((a, b))
    return out


def _lt(a, b, num_keys):
    """a <lex b over the first num_keys operands (signed int32)."""
    lt = a[0] < b[0]
    if num_keys == 2:
        lt = lt | ((a[0] == b[0]) & (a[1] < b[1]))
    return lt


def _exchange(x, num_keys: int, k: int, j: int):
    """One compare-exchange sub-stage on the (n, B, M) stack."""
    n, B, M = x.shape
    h = 1 << j
    v = x.reshape(n, B, M // (2 * h), 2, h)
    lo, hi = v[:, :, :, 0], v[:, :, :, 1]
    # bit k + 1 of the lower index blk * 2h + r is bit k - j of blk
    blk = torch.arange(M // (2 * h), device=x.device)
    asc = (((blk >> (k - j)) & 1) == 0)[:, None]
    swap = torch.where(asc, _lt(hi, lo, num_keys), _lt(lo, hi, num_keys))
    return torch.stack([torch.where(swap, hi, lo), torch.where(swap, lo, hi)],
                       dim=3).reshape(n, B, M)


def bitonic_plain(operands, num_keys: int = 1, chunk_log2: int | None = None):
    """Plain version: the network's sub-stages in ``plan(L, chunk_log2)``
    order (unchunked when None), each one vectorised step over the whole
    (n, B, M) stack.  operands: (B, M) int32 tensors, M a power of two.
    Returns a tuple of (B, M) tensors."""
    x = torch.stack(list(operands))
    M = x.shape[2]
    L = M.bit_length() - 1
    Lc = L if chunk_log2 is None else min(chunk_log2, L)
    for k, j in substages(*plan(L, Lc)):
        x = _exchange(x, num_keys, k, j)
    return tuple(x.unbind(0))


def compare_exchanges(M: int) -> int:
    """The network's compare-exchange count for one row of M elements."""
    L = M.bit_length() - 1
    return M * L * (L + 1) // 4


def chunk_log2_for(n: int, smem_bytes: int) -> int:
    """The largest chunk, 2^Lc elements of n int32 operands, that one
    block's shared memory holds."""
    Lc = 0
    while n * 4 << (Lc + 1) <= smem_bytes:
        Lc += 1
    if Lc < 1:
        raise ValueError(f"sort_rows: {n} operands do not fit in "
                         f"{smem_bytes} bytes of shared memory")
    return Lc


def _stage_table(L: int, Lc: int, device):
    """plan(L, Lc)'s phases (host) and its stage table packed k << 8 | j
    (on the device, cached)."""
    key = (L, Lc, str(device))
    if key not in _stage_tables:
        phases, ks, js = plan(L, Lc)
        packed = torch.as_tensor((ks << 8) | js, dtype=torch.int32,
                                 device=device)
        _stage_tables[key] = (np.ascontiguousarray(phases), packed)
    return _stage_tables[key]


def body_for(B: int, M: int, n: int) -> _build.Kernel:
    """The JAX op's branch rule: the rowsort body (K9) for batched rows or
    rows that fit its VMEM budget, else the flat body (K8)."""
    return _K9 if B > 1 or n * M * 4 <= VMEM_BUDGET else _K8


def sort_rows(operands, num_keys: int = 1):
    """Sort each row of the int32 ``operands`` ascending by the first
    ``num_keys`` operands (lexicographic, signed).  All operands are (B, M)
    with M a power of two and at least 1024.  Equals ``torch.sort(stable=
    True)`` + gathers when each row's key tuple is duplicate-free; among
    duplicate keys the order is the bitonic network's.  Pad with key =
    INT32_MAX to sort a shorter prefix.  Returns a tuple of (B, M)
    tensors (on CUDA, views of one (n, B, M) buffer)."""
    operands = list(operands)
    if not operands:
        raise ValueError("sort_rows: no operands")
    B, M = operands[0].shape
    n = len(operands)
    if M & (M - 1) or M < 1024:
        raise ValueError(f"sort_rows: M must be a power of two >= 1024, "
                         f"got {M}")
    if num_keys not in (1, 2) or num_keys > n:
        raise ValueError(f"sort_rows: num_keys must be 1 or 2 and at most "
                         f"the {n} operands, got {num_keys}")
    dev = operands[0].device
    K = body_for(B, M, n)
    for i, t in enumerate(operands):
        if (t.dtype != torch.int32 or tuple(t.shape) != (B, M)
                or t.device != dev):
            raise ValueError(f"sort_rows: operand {i} must be an int32 "
                             f"({B}, {M}) tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if K.plain_for(dev):
        return bitonic_plain(operands, num_keys)
    L = M.bit_length() - 1
    props = torch.cuda.get_device_properties(dev)
    Lc = min(L, chunk_log2_for(n, props.shared_memory_per_block_optin))
    phases, stages = _stage_table(L, Lc, dev)
    x = torch.stack(operands)
    K.launch(x.data_ptr(), n, B, M, num_keys, Lc, phases.ctypes.data,
             phases.shape[0], stages.data_ptr(), _build.stream_handle(x))
    return tuple(x.unbind(0))
