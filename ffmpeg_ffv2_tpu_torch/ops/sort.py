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
same for every chunking of the schedule (``plan``, ``plan_merged``).

The kernels carry ``W`` int32 words an element through the network
(``geometry``): in *index mode* (more than one payload) the keys and the
element's original column, after which a gather fetches each payload by
that column; in *direct mode* (at most one payload) the operands
themselves.  The swap decision reads the keys only, so the column ends in
the permutation the payloads would have taken, and both modes give the
same output element for element (``bitonic_plain_indexed``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

_K8 = _build.KERNELS["sort"]
_K9 = _build.KERNELS["rowsort"]

LOCAL, CROSS, MERGED = 0, 1, 2
VMEM_BUDGET = 10 << 20      # the JAX op's branch rule (sort_pallas.py:318)
MERGE_R = 4                 # cross sub-stages one merged pass runs
CHUNK_LOG2_MIN = 10         # the smallest chunk (M >= 1024)
CHUNK_LOG2_MAX = 14         # the local kernel: 2^Lc / 16 threads <= 1024
H100_LIMITS = (232448, 132)  # an H100's opt-in shared memory a block, SMs
_stage_tables = {}
_card_limits = {}


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


def plan_merged(L: int, Lc: int, R: int):
    """``plan(L, Lc)`` with each run of one ``k``'s cross sub-stages
    (``j = k .. Lc``) cut into groups of at most ``R``, each a MERGED
    phase: phases (P, 4) int32 rows (LOCAL, first stage, end stage, 0) or
    (MERGED, k, first j, count), and the same stage table."""
    if R < 1:
        raise ValueError(f"plan_merged: R must be at least 1, got {R}")
    phases, ks, js = plan(L, Lc)
    out = []
    for typ, a, b in phases.tolist():
        if typ == LOCAL:
            out.append([LOCAL, a, b, 0])
        elif (out[-1][0] == MERGED and out[-1][1] == a and out[-1][3] < R):
            out[-1][3] += 1          # cross rows of one k run j downward
        else:
            out.append([MERGED, a, b, 1])
    return np.asarray(out, np.int32), ks, js


def substages(phases, ks, js) -> list:
    """The (k, j) sub-stages of a plan (``plan`` or ``plan_merged``) in the
    order its phases run them."""
    out = []
    for row in phases.tolist():
        typ, a, b = row[:3]
        if typ == LOCAL:
            out += list(zip(ks[a:b].tolist(), js[a:b].tolist()))
        elif typ == CROSS:
            out.append((a, b))
        else:
            out += [(a, b - i) for i in range(row[3])]
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


def bitonic_plain(operands, num_keys: int = 1, chunk_log2: int | None = None,
                  merge: int | None = None):
    """Plain version: the network's sub-stages in ``plan(L, chunk_log2)``
    order (unchunked when None; ``plan_merged(L, chunk_log2, merge)``'s
    when ``merge`` is given), each one vectorised step over the whole
    (n, B, M) stack.  operands: (B, M) int32 tensors, M a power of two.
    Returns a tuple of (B, M) tensors."""
    x = torch.stack(list(operands))
    M = x.shape[2]
    L = M.bit_length() - 1
    Lc = L if chunk_log2 is None else min(chunk_log2, L)
    order = plan(L, Lc) if merge is None else plan_merged(L, Lc, merge)
    for k, j in substages(*order):
        x = _exchange(x, num_keys, k, j)
    return tuple(x.unbind(0))


def bitonic_plain_indexed(operands, num_keys: int = 1,
                          chunk_log2: int | None = None):
    """Plain version of the kernels' index mode: the network on the key
    operands and an int32 column index, then a gather of every payload by
    that index.  Equals ``bitonic_plain`` element for element."""
    operands = list(operands)
    B, M = operands[0].shape
    col = torch.arange(M, dtype=torch.int32,
                       device=operands[0].device).expand(B, M)
    out = bitonic_plain(operands[:num_keys] + [col], num_keys, chunk_log2)
    idx = out[num_keys].long()
    return out[:num_keys] + tuple(torch.gather(p, 1, idx)
                                  for p in operands[num_keys:])


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


def words_and_chunk(n: int, num_keys: int, B: int, L: int, limits):
    """The words W an element carries through the kernels (index mode:
    the keys and the column; direct mode: the n operands) and the chunk
    log2 Lc: the largest chunk whose W planes, padded one word in 33,
    fit in a block's shared memory (``limits``: the card's opt-in shared
    memory a block and its SM count), made smaller while the B rows hold
    fewer chunks than the card has SMs."""
    smem, sms = limits
    W = num_keys + 1 if n > num_keys + 1 else n
    Lc = min(L, CHUNK_LOG2_MAX, chunk_log2_for(W, smem * 32 // 33))
    while Lc > CHUNK_LOG2_MIN and B << (L - Lc) < sms:
        Lc -= 1
    return W, Lc


def geometry(n: int, num_keys: int, B: int, M: int,
             limits=H100_LIMITS) -> dict:
    """What the kernels run for n operands of B rows of M on a card of
    ``limits`` (``card_limits``): the mode, the words ``W`` an element
    carries through the network, the chunk ``2^Lc``, the merge group
    ``R``, and the device kernels of one call: local and merged phases,
    and the gather (index mode)."""
    index = n > num_keys + 1
    L = M.bit_length() - 1
    W, Lc = words_and_chunk(n, num_keys, B, L, limits)
    typ = plan_merged(L, Lc, MERGE_R)[0][:, 0]
    local, merged = int((typ == LOCAL).sum()), int((typ == MERGED).sum())
    return dict(mode="index" if index else "direct", W=W, Lc=Lc, R=MERGE_R,
                local=local, merged=merged, gather=int(index),
                kernels=local + merged + int(index))


def card_limits(device) -> tuple:
    """The card's opt-in shared memory a block and its SM count (cached
    per device)."""
    key = torch.device(device).index or 0
    if key not in _card_limits:
        props = torch.cuda.get_device_properties(key)
        _card_limits[key] = (props.shared_memory_per_block_optin,
                             props.multi_processor_count)
    return _card_limits[key]


def _stage_table(L: int, Lc: int, device):
    """plan_merged(L, Lc, MERGE_R)'s phases (host) and its stage table
    packed k << 8 | j (on the device, cached)."""
    key = (L, Lc, str(device))
    if key not in _stage_tables:
        phases, ks, js = plan_merged(L, Lc, MERGE_R)
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
    tensors (on CUDA, views of one (n, B, M) buffer).  On CUDA one
    launcher call runs ``geometry``'s kernels on the current stream."""
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
    # the kernels read the operands in 16-byte vectors
    operands = [t if t.is_contiguous() and t.data_ptr() % 16 == 0
                else t.clone(memory_format=torch.contiguous_format)
                for t in operands]
    L = M.bit_length() - 1
    W, Lc = words_and_chunk(n, num_keys, B, L, card_limits(dev))
    phases, stages = _stage_table(L, Lc, dev)
    out = torch.empty((n, B, M), dtype=torch.int32, device=dev)
    # index mode works on a (W, B, M) scratch; direct mode in the output
    x = out if W == n else torch.empty((W, B, M), dtype=torch.int32,
                                       device=dev)
    ptrs = np.array([t.data_ptr() for t in operands], np.int64)
    table = torch.empty(n, dtype=torch.int64, device=dev)
    K.launch(ptrs.ctypes.data, table.data_ptr(), n, B, M, num_keys, W, Lc,
             phases.ctypes.data, phases.shape[0], stages.data_ptr(),
             x.data_ptr(), out.data_ptr(), _build.stream_handle(out))
    return tuple(out.unbind(0))
