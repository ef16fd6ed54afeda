"""The port's row sort (``ops.sort_rows``: K8 and K9) at the FFV1 device
pipeline's sort shapes, against its plain version and the library sort.

Counterpart of ``tools/microbench_sort.py`` (layout, class and unsort
shapes, permutation keys), with the sorter cases of ``tools/
microbench_unsort.py`` (candidate D, per-slice rows of slice-local keys
with duplicates and 12% INT32_MAX sentinels, and candidate B, the same
records as one global row, padded to 2^22 with INT32_MAX keys as the op
requires) and ``tools/microbench_sort2.py:93-96`` (the batched 30 x 128K
shape, random 30-bit keys).  Per case: what the kernels run
(``ops.sort.geometry``: index or direct mode, the words ``W`` an element
carries, the chunk log2 ``Lc``, the merge group ``R``, and the device
kernels of one call: local + merged + gather), the op's time (CUDA
events: its host work and the launches), its device time alone and the
kernels the profiler saw a call (``torch.profiler``), the plain
version's time (one run, which is also its comparison run), the
library's (``torch.sort(stable=True)`` of the key, then ``torch.gather``
of each payload), the bound (every operand read and written once),
exactness against the plain version on every element, and against the
library: whole where each row's keys are duplicate-free, else the keys
only (the network is not stable).

    python -m ffmpeg_ffv2_tpu_torch.tools.microbench_sort [substring] \
        [--device cpu] [--profile]

``--profile`` also prints each case's device time by kernel (one line a
kernel name: ms and launches a call).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import sort
from . import (bound_ms, device_label, device_ms, device_ms_once,
               device_profile, launches_of, profiled_ms)

INT32_MAX = 2 ** 31 - 1
NUM_KEYS = 1                    # every case sorts by operand 0 alone
S, CAP = 30, 1 << 17            # 1080p / 30 slices, cells a slice

# (name, B, M, operands, key kind)
CASES = [
    ("layout (30,131072)x2", 30, 1 << 17, 2, "perm"),
    ("class (1,65536)x4", 1, 1 << 16, 4, "perm"),
    ("unsort (1,4194304)x7", 1, 1 << 22, 7, "perm"),
    ("unsort (1,4194304)x10", 1, 1 << 22, 10, "perm"),
    ("unsort D per-slice (30,131072)x6", S, CAP, 6, "slice"),
    ("unsort D per-slice (30,131072)x9", S, CAP, 9, "slice"),
    ("unsort B global (1,3932160 padded to 4194304)x6", 1, 1 << 22, 6,
     "global"),
    ("unsort B global (1,3932160 padded to 4194304)x9", 1, 1 << 22, 9,
     "global"),
    ("sort2 rowsort (30,131072)x2", 30, 1 << 17, 2, "rand30"),
    ("sort2 rowsort (30,131072)x4", 30, 1 << 17, 4, "rand30"),
]


def make_operands(kind: str, B: int, M: int, n: int, seed: int = 1):
    """The case's int32 (B, M) operands as numpy arrays, from a seed:
    ``perm`` a permutation key per row and 30-bit payloads (microbench_
    sort.py); ``slice`` slice-local keys below 2^17 with 12% INT32_MAX
    and full-range payloads (microbench_unsort.py); ``global`` those
    records of S x CAP in one row, padded to M with INT32_MAX keys and 0
    payloads; ``rand30`` 30-bit keys and payloads (microbench_sort2.py)."""
    rng = np.random.RandomState(seed)
    if kind == "perm":
        key = np.stack([rng.permutation(M).astype(np.int32)
                        for _ in range(B)])
        return [key] + [rng.randint(0, 1 << 30, (B, M), dtype=np.int32)
                        for _ in range(n - 1)]
    if kind in ("slice", "global"):
        rows, cols = (S, CAP) if kind == "global" else (B, M)
        key = np.where(rng.rand(rows, cols) < 0.88,
                       rng.randint(0, 1 << 17, (rows, cols)),
                       INT32_MAX).astype(np.int32)
        ops = [key] + [rng.randint(-2 ** 31, 2 ** 31 - 1, (rows, cols),
                                   dtype=np.int64).astype(np.int32)
                       for _ in range(n - 1)]
        if kind == "slice":
            return ops
        N = rows * cols
        out = []
        for i, o in enumerate(ops):
            row = np.full((1, M), INT32_MAX if i == 0 else 0, np.int32)
            row[0, :N] = o.reshape(-1)
            out.append(row)
        return out
    if kind == "rand30":
        return [rng.randint(0, 1 << 30, (B, M), dtype=np.int32)
                for _ in range(n)]
    raise ValueError(f"unknown key kind {kind!r}")


def library_sort(operands):
    """The library yardstick: a stable sort of the key, then a gather of
    each payload by its permutation."""
    key, idx = torch.sort(operands[0], dim=1, stable=True)
    return (key,) + tuple(torch.gather(p, 1, idx) for p in operands[1:])


def run_case(name, B, M, n, kind, device="cuda", reps=5, seed=1) -> dict:
    """One case: the op once (its launches counted), then the comparisons
    and the timings.  The profiler's kernel count is held to
    ``geometry``'s (``profiled_ms`` raises where it never agrees)."""
    ops = [torch.as_tensor(o, device=device)
           for o in make_operands(kind, B, M, n, seed)]
    kern = sort.body_for(B, M, n)
    limits = (sort.card_limits(device) if torch.device(device).type ==
              "cuda" else sort.H100_LIMITS)
    geo = sort.geometry(n, NUM_KEYS, B, M, limits)
    got, launches = launches_of(lambda: sort.sort_rows(ops, NUM_KEYS),
                                (kern,))
    ref, plain_ms = device_ms_once(
        lambda: sort.bitonic_plain(ops, NUM_KEYS), device)
    err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, ref))
    exact_plain = all(torch.equal(a, b) for a, b in zip(got, ref))
    del ref
    lib = library_sort(ops)
    unique = bool((lib[0][:, 1:] != lib[0][:, :-1]).all())
    if unique:
        exact_library = all(torch.equal(a, b) for a, b in zip(got, lib))
    else:
        exact_library = torch.equal(got[0], lib[0])
    del got, lib
    ms = device_ms(lambda: sort.sort_rows(ops, NUM_KEYS), reps, device)
    dev_ms, dev_kernels = profiled_ms(
        lambda: sort.sort_rows(ops, NUM_KEYS), reps, device, geo["kernels"])
    library_ms = device_ms(lambda: library_sort(ops), reps, device)
    nbytes = 2 * n * B * M * 4
    cx = B * sort.compare_exchanges(M)
    bnd, by = bound_ms(nbytes, cx)
    L = M.bit_length() - 1
    return dict(name=name, kernel=kern.name, B=B, M=M, operands=n,
                num_keys=NUM_KEYS, keys=kind, unique_keys=unique,
                launches=launches[kern.name],
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bnd, bound_by=by, bound_bytes=nbytes, bound_ops=cx,
                compare_exchanges=cx, network_substages=L * (L + 1) // 2,
                **geo, profiled_ms=dev_ms, profiled_kernels=dev_kernels,
                max_abs_err=err, exact_plain=exact_plain,
                exact_library=exact_library,
                library_compared="all operands" if unique else "keys only",
                device=device_label(device))


def run(cases=CASES, device="cuda", reps=5) -> list:
    """Every case of ``cases`` (tuples as in CASES); returns a dict each."""
    return [run_case(*c, device=device, reps=reps) for c in cases]


def line(r: dict) -> str:
    el = r["B"] * r["M"]
    prof = ("not measured" if r["profiled_ms"] is None else
            f"{r['profiled_ms']:.4f} ms in {r['profiled_kernels']:g} "
            f"kernels")
    return (f"{r['name']:50s} [{r['device']}] {r['kernel']} {r['mode']} "
            f"W={r['W']} Lc={r['Lc']} R={r['R']} kernels {r['local']} "
            f"local + {r['merged']} merged + {r['gather']} gather: "
            f"{r['ms']:9.3f} ms ({el / r['ms'] / 1e3:8.1f} Mel/s), device "
            f"alone {prof}, plain "
            f"{r['plain_ms']:9.2f} ms, library {r['library_ms']:8.3f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), launches "
            f"{r['launches']}, exact plain={r['exact_plain']} library="
            f"{r['exact_library']} ({r['library_compared']})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("select", nargs="?", default="",
                    help="run only the cases whose name holds this")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--profile", action="store_true",
                    help="print each case's device time by kernel")
    args = ap.parse_args(argv)
    ok = True
    for c in CASES:
        if args.select in c[0]:
            r = run_case(*c, device=args.device)
            print(line(r), flush=True)
            ok &= r["exact_plain"] and r["exact_library"]
            if args.profile:
                _, B, M, n, kind = c
                ops = [torch.as_tensor(o, device=args.device)
                       for o in make_operands(kind, B, M, n)]
                prof = device_profile(lambda: sort.sort_rows(ops, NUM_KEYS),
                                      5, args.device)
                for name, (ms, cnt) in prof.items():
                    print(f"    {ms:9.4f} ms {cnt:5.1f} x {name[:110]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
