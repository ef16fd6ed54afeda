"""The capability probes of ``tools/probe_mosaic.py`` on the card (K13-K17).

Each probe runs the CUDA counterpart of one TPU kernel body there, on the
JAX tool's inputs, and prints ``OK   name: result`` (or ``FAIL name:
error``) as the JAX tool does; the expected results are 1023, 4, 120 (for
tables of 12K, 32K and 128K words), 127 and True.  The wrappers launch
``csrc/probes.cu`` on CUDA tensors and take the plain versions (the JAX
bodies in torch's calls) on CPU tensors; ``run`` also holds every kernel
against its plain version and times both.

    python -m ffmpeg_ffv2_tpu_torch.tools.probes [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import _build
from . import (bound_ms, device_label, device_ms, device_ms_once,
               launches_of, profiled_ms)

LANES = 128
_K13 = _build.KERNELS["probe_scalar_extract"]
_K14 = _build.KERNELS["probe_scalar_in_ds"]
_K15 = _build.KERNELS["probe_big_prefetch"]
_K16 = _build.KERNELS["probe_roll_dynamic"]
_K17 = _build.KERNELS["probe_taa_rows"]


def scalar_extract_plain(v):
    """p1: v + max(v)."""
    return v + v.amax()


def scalar_in_ds_plain(v):
    """p1b: row max(v[0]) mod 4 of v, (1, 128)."""
    return v.index_select(0, (v[0].amax() % 4).reshape(1))


def big_prefetch_plain(tab, x):
    """p2: row i is x[i] * 0 + the int32 sum of tab[16 i .. 16 i + 16)."""
    G = x.shape[0]
    sums = tab[:G * 16].reshape(G, 16).sum(1).to(torch.int32)
    return x * 0 + sums[:, None]


def roll_dynamic_plain(v):
    """p4: roll the lanes by (128 - max(v[0]) mod 128) mod 128."""
    sh = (LANES - v[0].amax() % LANES) % LANES
    lane = torch.arange(LANES, device=v.device)
    return v.index_select(1, (lane - sh) % LANES)


def taa_rows_plain(v, idx):
    """p5: take_along_axis(v, broadcast(idx), axis=1), idx (1, 128)."""
    return torch.gather(v, 1, idx.long().expand(v.shape[0], LANES))


def _rows(K, v):
    K.check("v", v, (v.shape[0], LANES), v.device)
    return v.shape[0]


def scalar_extract(v):
    """K13 wrapper: v contiguous int32 (R, 128) -> (R, 128)."""
    R = _rows(_K13, v)
    if _K13.plain_for(v.device):
        return scalar_extract_plain(v)
    out = torch.empty_like(v)
    _K13.launch(v.data_ptr(), R, out.data_ptr(), _build.stream_handle(v))
    return out


def scalar_in_ds(v):
    """K14 wrapper: v contiguous int32 (R, 128), R >= 4 (the probe reads
    one of rows 0..3) -> (1, 128)."""
    R = _rows(_K14, v)
    if R < 4:
        raise ValueError(f"scalar_in_ds: {R} rows, not 4 or more")
    if _K14.plain_for(v.device):
        return scalar_in_ds_plain(v)
    out = torch.empty((1, LANES), dtype=torch.int32, device=v.device)
    _K14.launch(v.data_ptr(), R, out.data_ptr(), _build.stream_handle(v))
    return out


def big_prefetch(tab, x):
    """K15 wrapper: tab contiguous int32 (N,) with N >= 16 G, x contiguous
    int32 (G, 128) -> (G, 128)."""
    G, n, dev = x.shape[0], tab.shape[0], x.device
    _K15.check("x", x, (G, LANES), dev)
    _K15.check("tab", tab, (n,), dev)
    if n < 16 * G:
        raise ValueError(f"big_prefetch: a table of {n} words for {G} "
                         "rows of 16")
    if _K15.plain_for(dev):
        return big_prefetch_plain(tab, x)
    out = torch.empty_like(x)
    _K15.launch(tab.data_ptr(), n, x.data_ptr(), G, out.data_ptr(),
                _build.stream_handle(x))
    return out


def roll_dynamic(v):
    """K16 wrapper: v contiguous int32 (R, 128) -> (R, 128)."""
    R = _rows(_K16, v)
    if _K16.plain_for(v.device):
        return roll_dynamic_plain(v)
    out = torch.empty_like(v)
    _K16.launch(v.data_ptr(), R, out.data_ptr(), _build.stream_handle(v))
    return out


def taa_rows(v, idx):
    """K17 wrapper: v contiguous int32 (R, 128), idx contiguous int32
    (1, 128) with values in [0, 128) -> (R, 128)."""
    R = _rows(_K17, v)
    _K17.check("idx", idx, (1, LANES), v.device)
    if _K17.plain_for(v.device):
        return taa_rows_plain(v, idx)
    out = torch.empty_like(v)
    _K17.launch(v.data_ptr(), idx.data_ptr(), R, out.data_ptr(),
                _build.stream_handle(v))
    return out


def inputs(device):
    """The JAX tool's probes: (name, kernel, wrapper, plain, args,
    result of the output, expected result)."""
    def ar(n):
        return torch.arange(n, dtype=torch.int32, device=device)

    x8 = ar(8 * LANES).reshape(8, LANES)
    x10 = ar(10 * LANES).reshape(10, LANES)
    idx = (ar(LANES)[None, :] * 7) % LANES
    taa_ref = np.take_along_axis(x10.cpu().numpy(), np.broadcast_to(
        idx.cpu().numpy(), (10, LANES)), axis=1)
    first = lambda y: int(y[0, 0])          # noqa: E731
    probes = [
        ("scalar extract (jnp.max)", _K13, scalar_extract,
         scalar_extract_plain, (x8,), first, 1023),
        ("scalar in pl.ds", _K14, scalar_in_ds, scalar_in_ds_plain,
         (x8 % 7,), first, 4)]
    for n in (12, 32, 128):
        x4 = torch.zeros((4, LANES), dtype=torch.int32, device=device)
        probes.append((f"prefetch {n}K", _K15, big_prefetch,
                       big_prefetch_plain, (ar(n * 1024), x4), first, 120))
    probes += [
        ("dynamic roll", _K16, roll_dynamic, roll_dynamic_plain,
         (x8 % LANES,), first, 127),
        ("take_along_axis rows", _K17, taa_rows, taa_rows_plain, (x10, idx),
         lambda y: bool(np.array_equal(y.cpu().numpy(), taa_ref)), True)]
    return probes


EDGE_ROWS = (1, 9, 4096)
TAA_EDGE_ROWS = (1, 9, 10, 4096)
TAA_PATTERNS = ("7 l mod 128", "permutation", "all 0", "all 127",
                "identity")


def taa_index(pattern, rng=None):
    """K17's idx (128,) int64 for a pattern of ``TAA_PATTERNS``: the JAX
    tool's 7 l mod 128, a random permutation (from ``rng``, a seeded
    numpy RandomState), all 0, all 127 or the identity."""
    lane = np.arange(LANES, dtype=np.int64)
    if pattern == "permutation":
        return (rng or np.random.RandomState(0)).permutation(LANES)
    return {"7 l mod 128": lane * 7 % LANES, "all 0": lane * 0,
            "all 127": lane * 0 + LANES - 1, "identity": lane}[pattern]


def edge_inputs(device):
    """K13 and K16 at row counts beside the tool's 8 (one row; 9, K13's
    first past its one-warp form; 4096), on hostile words, and K17 at the
    rows of ``TAA_EDGE_ROWS`` (one row; 9 and the tool's 10, whose last
    block of four warps a row is short; 4096) with each idx of
    ``TAA_PATTERNS``: (label, kernel,
    wrapper, plain, args).  K13's max is INT_MAX in the last row, so
    the add wraps; K16's row-0 max is -129, where jnp's floor modulo and
    C's differ in the inner step."""
    rng = np.random.RandomState(0)

    def words(R, row0_max=None):
        v = rng.randint(-2 ** 31, 2 ** 31 - 1, (R, LANES), dtype=np.int64)
        v[R - 1, rng.randint(LANES)] = 2 ** 31 - 1
        if row0_max is not None:
            v[0] = row0_max - rng.randint(0, row0_max + 2 ** 31 + 1, LANES,
                                          dtype=np.int64)
            v[0, rng.randint(LANES)] = row0_max
        return torch.as_tensor(v.astype(np.int32), device=device)

    out = []
    for R in EDGE_ROWS:
        out += [(f"R={R}, max INT_MAX", _K13, scalar_extract,
                 scalar_extract_plain, (words(R),)),
                (f"R={R}, row 0 max -129", _K16, roll_dynamic,
                 roll_dynamic_plain, (words(R, -129),))]
    for R in TAA_EDGE_ROWS:
        for pattern in TAA_PATTERNS:
            idx = torch.as_tensor(
                taa_index(pattern, rng).astype(np.int32)[None, :],
                device=device)
            out.append((f"R={R}, idx {pattern}", _K17, taa_rows,
                        taa_rows_plain, (words(R), idx)))
    return out


def _bytes(K, args, out) -> int:
    """The words the function must move: each input read once and the
    output written once, but K14 reads two rows of v (row 0 and the row it
    picks), not v, and K15 16 table words a row, not the table."""
    if K is _K14:
        return 4 * (2 * LANES + out.numel())
    n = sum(a.numel() for a in args if a.dim() == 2) + out.numel()
    if K is _K15:
        n += 16 * args[1].shape[0]
    return 4 * n


def run(device="cuda", timing_reps=20) -> list:
    """Every probe: its result, the kernel against its plain version on the
    whole output, the launches of the probe's one call, and the times
    (CUDA events around the call, and its device time alone from
    ``torch.profiler``)."""
    out = []
    for name, K, fn, plain, args, result, expected in inputs(device):
        got, launches = launches_of(lambda: fn(*args), (K,))
        ref, plain_ms = device_ms_once(lambda: plain(*args), device)
        nbytes, ops = _bytes(K, args, got), got.numel()
        bnd, by = bound_ms(nbytes, ops)
        out.append(dict(
            name=name, kernel=K.name, result=result(got), expected=expected,
            launches=launches[K.name], output=got,
            max_abs_err=int((got.long() - ref.long()).abs().max()),
            exact_plain=torch.equal(got, ref),
            ms=device_ms(lambda: fn(*args), timing_reps, device),
            profiled_ms=profiled_ms(lambda: fn(*args), timing_reps,
                                    device, 1)[0],
            plain_ms=plain_ms,
            library_ms=device_ms(lambda: plain(*args), timing_reps, device),
            bound_ms=bnd, bound_by=by, bound_bytes=nbytes, bound_ops=ops,
            device=device_label(device)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    print(f"device: {device_label(args.device)}", flush=True)
    ok = True
    for name, K, fn, plain, a, result, expected in inputs(args.device):
        try:
            got = fn(*a)
            r = result(got)
            good = r == expected and torch.equal(got, plain(*a))
            print(f"{'OK  ' if good else 'FAIL'} {name}: {r} "
                  f"[{device_label(args.device)}]", flush=True)
        except Exception as e:
            msg = str(e).split("\n")[0][:200]
            good = False
            print(f"FAIL {name}: {type(e).__name__}: {msg} "
                  f"[{device_label(args.device)}]", flush=True)
        ok &= good
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
