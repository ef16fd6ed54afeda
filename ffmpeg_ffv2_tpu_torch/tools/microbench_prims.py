"""The data-movement primitives of the bitonic sorter, on the card: lane
roll (K10), row-block compare-exchange (K11) and 2-D transpose (K12).

Counterpart of ``tools/microbench_pallas.py`` (``roll_kernel``,
``rowcx_kernel``, ``transpose_kernel``) at its shapes and reps, on its
input ``arange(R * 128).reshape(R, 128)``.  ``roll``, ``rowcx`` and
``transpose`` launch ``csrc/prims.cu`` on CUDA tensors and take the plain
versions (``*_plain``, the JAX bodies written with torch's calls) on CPU
tensors.  Per case: the kernel's time for all reps and per pass (CUDA
events around the wrapper; and ``device_ms``, the device time alone
behind a sleep kernel, ``kernel_times.device_ms``), the plain version's
(its comparison run), the library's (the plain version's
calls, warmed, for all reps; and one call, ``torch.roll``, ``torch.
minimum`` + ``torch.maximum`` or ``.T.contiguous()``, for one pass), the
bound and exactness against the plain version.

    python -m ffmpeg_ffv2_tpu_torch.tools.microbench_prims [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import _build
from . import bound_ms, device_label, device_ms, device_ms_once, launches_of
from .kernel_times import device_ms as device_ms_alone

LANES = 128
_K10 = _build.KERNELS["roll"]
_K11 = _build.KERNELS["rowcx"]
_K12 = _build.KERNELS["transpose"]

# (name, primitive, rows, reps), as tools/microbench_pallas.py:main
CASES = [
    ("roll lanes (512,128) x64", "roll", 512, 64),
    ("roll lanes (2048,128) x64", "roll", 2048, 64),
    ("row cmpex (512,128) x64", "rowcx", 512, 64),
    ("row cmpex (2048,128) x64", "rowcx", 2048, 64),
    ("transpose (128,128) x32 (64 transposes)", "transpose", 128, 32),
    ("transpose (512,128) x32 (64 transposes)", "transpose", 512, 32),
]


def roll_plain(x, reps: int):
    """reps times: roll the lanes by 1 << (i % 7) (out[l] = in[l - s]),
    then + 1."""
    for i in range(reps):
        x = torch.roll(x, 1 << (i % 7), dims=1) + 1
    return x


def rowcx_plain(x, reps: int):
    """reps times: the min and max of row blocks b = 1 << (i % 8) apart."""
    R = x.shape[0]
    for i in range(reps):
        b = 1 << (i % 8)
        v = x.reshape(R // (2 * b), 2, b, LANES)
        lo, hi = v[:, 0], v[:, 1]
        x = torch.stack([torch.minimum(lo, hi), torch.maximum(lo, hi)],
                        dim=1).reshape(R, LANES)
    return x


def transpose_plain(x, reps: int):
    """reps times: x = x.T + 1; x = x.T + 1 (each transpose a copy)."""
    for _ in range(reps):
        x = x.T.contiguous() + 1
        x = x.T.contiguous() + 1
    return x


def roll(x, reps: int):
    """K10 wrapper: x contiguous int32 (R, 128)."""
    R, dev = x.shape[0], x.device
    _K10.check("x", x, (R, LANES), dev)
    if _K10.plain_for(dev):
        return roll_plain(x, reps)
    out = torch.empty_like(x)
    _K10.launch(x.data_ptr(), R, reps, out.data_ptr(),
                _build.stream_handle(x))
    return out


def rowcx(x, reps: int):
    """K11 wrapper: x contiguous int32 (R, 128), R a multiple of twice the
    largest block distance, 2 << min(reps - 1, 7)."""
    R = x.shape[0]
    _K11.check("x", x, (R, LANES), x.device)
    group = 2 << min(max(reps - 1, 0), 7)
    if R % group:
        raise ValueError(f"rowcx: {R} rows do not split into blocks of "
                         f"{group} rows")
    if _K11.plain_for(x.device):
        return rowcx_plain(x, reps)
    out = torch.empty_like(x)
    _K11.launch(x.data_ptr(), R, reps, out.data_ptr(),
                _build.stream_handle(x))
    return out


def transpose(x, reps: int):
    """K12 wrapper: x contiguous int32 (R, W), R and W multiples of 32."""
    R, W = x.shape
    _K12.check("x", x, (R, W), x.device)
    if R % 32 or W % 32:
        raise ValueError(f"transpose: ({R}, {W}) is not a multiple of 32 "
                         "both ways")
    if _K12.plain_for(x.device):
        return transpose_plain(x, reps)
    out = torch.empty_like(x)
    _K12.launch(x.data_ptr(), R, W, reps, out.data_ptr(),
                _build.stream_handle(x))
    return out


PRIMS = {
    "roll": (roll, roll_plain, _K10,
             lambda x: torch.roll(x, 1, dims=1), 1),
    "rowcx": (rowcx, rowcx_plain, _K11,
              lambda x: (torch.minimum(x[0::2], x[1::2]),
                         torch.maximum(x[0::2], x[1::2])), 1),
    "transpose": (transpose, transpose_plain, _K12,
                  lambda x: x.T.contiguous(), 2),
}


def run_case(name, prim, R, reps, device="cuda", timing_reps=20) -> dict:
    kern_fn, plain_fn, K, one_call, per_rep = PRIMS[prim]
    x = torch.arange(R * LANES, dtype=torch.int32,
                     device=device).reshape(R, LANES)
    got, launches = launches_of(lambda: kern_fn(x, reps), (K,))
    ref, plain_ms = device_ms_once(lambda: plain_fn(x, reps), device)
    err = int((got.long() - ref.long()).abs().max())
    passes = reps * per_rep
    ms = device_ms(lambda: kern_fn(x, reps), timing_reps, device)
    alone = (device_ms_alone(lambda: kern_fn(x, reps), timing_reps)
             if torch.device(device).type == "cuda" else None)
    nbytes, ops = 2 * x.numel() * 4, passes * x.numel()
    bnd, by = bound_ms(nbytes, ops)
    return dict(name=name, kernel=K.name, shape=[R, LANES], reps=reps,
                passes=passes, launches=launches[K.name], ms=ms,
                device_ms=alone,
                ms_per_pass=ms / passes, plain_ms=plain_ms,
                library_ms=device_ms(lambda: plain_fn(x, reps), timing_reps,
                                     device),
                library_ms_per_pass=device_ms(lambda: one_call(x),
                                              timing_reps, device),
                bound_ms=bnd, bound_by=by, bound_bytes=nbytes, bound_ops=ops,
                max_abs_err=err, exact_plain=torch.equal(got, ref),
                device=device_label(device))


def run(cases=CASES, device="cuda") -> list:
    return [run_case(*c, device=device) for c in cases]


def line(r: dict) -> str:
    el = r["shape"][0] * r["shape"][1]
    alone = ("" if r["device_ms"] is None
             else f" (device alone {r['device_ms']:.4f})")
    return (f"{r['name']:42s} [{r['device']}] {r['ms']:8.4f} ms total{alone}, "
            f"{r['ms_per_pass'] * 1e3:8.3f} us/pass, "
            f"{el / r['ms_per_pass'] / 1e6:8.2f} Gelem/s/pass; plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
            f"({r['library_ms_per_pass'] * 1e3:.3f} us one call), bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}), launches "
            f"{r['launches']}, exact={r['exact_plain']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    ok = True
    for c in CASES:
        r = run_case(*c, device=args.device)
        print(line(r), flush=True)
        ok &= r["exact_plain"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
