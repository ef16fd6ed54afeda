"""Holds builds of the native runtime (``native/ffv1_runtime.cpp`` and
``ffv2_runtime.cpp``) at other compiler flags against an ``-O0`` build of
the same sources, on the host that runs it, and finds where a build goes
wrong:

    python -m ffmpeg_ffv2_tpu_torch.tools.native_check [--size WxH]
        [--frames N] [--cases a,b] [--variants shipped,O3,...]
        [--add NAME=FLAG,FLAG] [--time] [--sanitize] [--warnings]
        [--bisect COUNTER,...] [--rtl VARIANT:PASS,...] [--out DIR]

The matrix (always run): for each case of ``CASES`` (range and
Golomb-Rice, yuv420p, yuv420p16, bgr0 at versions 3 and 4, version 1,
pass-1 statistics on and off, one slice thread and several) each variant
encodes ``--frames`` frames (the first a key frame) and must give the
``-O0`` build's packets and, with statistics on, its tallies; each
variant decodes the ``-O0`` packets, one by one and frame-pipelined, to
the input.  One line a case and variant: ``ok`` or what differs.  The
variants are ``VARIANTS`` (the shipped flags, -O3, -O2, -O3
-fno-strict-aliasing) and those ``--add`` names.

``--time`` prints each variant's encode ms a frame (host clock, median
of the inter frames of ``TIME_REPS`` passes) for the cases named in
``TIME_CASES``.  ``--sanitize`` runs the first failing case (else the
first case) under ``-O3`` builds with ``-fsanitize=undefined`` and
``-fsanitize=address`` (the latter in a child process with the
sanitizer's runtime preloaded) and under valgrind's memcheck where the
host has it, and prints what each reports.  ``--warnings`` counts the
``-O3 -Wall -Wextra`` warnings of the sources.  ``--bisect`` takes GCC
debug counters (``ipa_mod_ref``, ``ipa_mod_ref_pta``, ...): for each, it
finds the least ``-fdbg-cnt=COUNTER:N`` at which the ``-O3`` build fails
the first failing case, and writes the ``-fdump-tree-optimized`` dumps at
N - 1 and N and their diff to ``--out`` (``build/native_check`` by
default), so that the one transformation that breaks the packets can be
read.  ``--rtl`` writes the RTL dumps of the named passes and the
assembly for the functions whose names hold ``--function``.  Builds go
to ``build/native/<hash>`` (``ffv1/native.py:build``), keyed by the
compiler too.  Exit code 1 where the shipped build fails a case.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import ctypes
import difflib
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..ffv1 import native
from ..ffv1.params import FFV1Config, params_from_config

COMMON = ["-std=c++17", "-fPIC", "-shared", "-pthread"]
# each variant builds the library as it ships: the FFV1 and FFV2 runtimes,
# two translation units.  O3 is the shipped flags without -fno-peephole2;
# O3_no_strict_aliasing the flag that first hid the fault by moving it
VARIANTS = {
    "O0": ["-O0", *COMMON],
    "shipped": list(native._CXX_FLAGS),
    "O3": ["-O3", *COMMON],
    "O2": ["-O2", *COMMON],
    "O3_no_strict_aliasing": ["-O3", "-fno-strict-aliasing", *COMMON],
}
# label: (pix_fmt, FFV1Config fields, pass-1 statistics, slice threads;
# 0 = one a core up to the slice count)
CASES = {
    "yuv420p_range": ("yuv420p", dict(level=3, coder=1, slices=30), 0, 0),
    "yuv420p_range_stats": ("yuv420p", dict(level=3, coder=1, slices=30),
                            1, 0),
    "yuv420p_range_stats_1t": ("yuv420p", dict(level=3, coder=1,
                                               slices=30), 1, 1),
    "yuv420p_rice": ("yuv420p", dict(level=3, coder=0, slices=30), 0, 0),
    "yuv420p_rice_1t": ("yuv420p", dict(level=3, coder=0, slices=30), 0, 1),
    "yuv420p16_range": ("yuv420p16", dict(level=3, coder=1, slices=30),
                        0, 0),
    "yuv420p16_range_stats": ("yuv420p16", dict(level=3, coder=1,
                                                slices=30), 1, 0),
    "bgr0_v4_range_stats": ("bgr0", dict(level=4, coder=1, slices=30),
                            1, 0),
    "bgr0_rice": ("bgr0", dict(level=3, coder=0, slices=30), 0, 0),
    "yuv420p_v1_range_stats": ("yuv420p", dict(level=1, coder=1), 1, 0),
}
TIME_CASES = ("yuv420p_range", "yuv420p_range_stats", "yuv420p_rice",
              "yuv420p_range_stats_1t", "yuv420p_rice_1t")
TIME_REPS = 3


def synth_frames(codec, n):
    """``chip_smoke.synth_1080p_frames`` at the params' planes and sample
    depth: a quantised gradient plus 2-bit seeded noise (plane 0 and
    alpha), ramps (planes 1 and 2), moving with t; at 1080p yuv420p these
    are that function's frames."""
    p = codec.p
    mx = (1 << p.bits) - 1
    shapes = codec._plane_shapes()
    noise = np.random.RandomState(0).randint(0, 4, shapes[0])
    frames = []
    for t in range(n):
        planes = []
        for i, (h, w) in enumerate(shapes):
            yy, xx = np.mgrid[0:h, 0:w]
            if i in (1, 2):
                v = i * ((xx + yy) % 256) * (mx + 1) // 256 + (3, 1)[i - 1] * t
            else:
                v = ((xx * 3 + yy * 2) % 256 // 8 * 8 * (mx + 1) // 256
                     + (5 + i) * t + noise[:h, :w])
            planes.append((v & mx).astype(np.int32))
        frames.append(planes)
    return frames


def build_variants(names):
    """Build each variant (in parallel, one g++ each); name -> path."""
    with cf.ThreadPoolExecutor(max(1, min(len(names),
                                          os.cpu_count() or 1))) as ex:
        futs = {k: ex.submit(native.build, VARIANTS[k]) for k in names}
        return {k: f.result() for k, f in futs.items()}


def params_of(case, w, h):
    pix, cfg, _, _ = CASES[case]
    return params_from_config(FFV1Config(**cfg), pix, w, h)


def get_stats(codec):
    """The session's summed pass-1 tallies as bytes (rc_stat, rc_stat2)."""
    p = codec.p
    n2 = p.context_counts[p.context_model] * 32 * 2
    rc = np.zeros(512, np.uint64)
    rc2 = np.zeros(n2, np.uint64)
    u64 = ctypes.POINTER(ctypes.c_uint64)
    gob = codec.lib.ffv1rt_get_stats(codec.handle, rc.ctypes.data_as(u64),
                                     rc2.ctypes.data_as(u64), n2)
    return rc.tobytes() + rc2.tobytes() + int(gob).to_bytes(4, "little")


def encode_run(lib, case, frames, w, h):
    """(packets, tallies or None) of one session over ``frames``."""
    _, _, stats, threads = CASES[case]
    codec = native.NativeFFV1Codec(params_of(case, w, h), threads, lib)
    if stats:
        codec.enable_stats()
    pkts = [codec.encode(f, t == 0) for t, f in enumerate(frames)]
    return pkts, (get_stats(codec) if stats else None)


def check_case(lib, case, frames, ref, w, h):
    """'ok', or what differs from the -O0 build's (packets, tallies)."""
    pkts, tallies = encode_run(lib, case, frames, w, h)
    bad = [f"frame {t}: {len(a)} bytes for {len(b)}"
           for t, (a, b) in enumerate(zip(pkts, ref[0])) if a != b]
    if tallies != ref[1]:
        bad.append("pass-1 tallies differ")
    p = params_of(case, w, h)
    dec = native.NativeFFV1Codec(p, 0, lib)
    got = []
    try:
        got.append([dec.decode(pkt) for pkt in ref[0]])
        got.append(native.NativeFFV1Codec(p, 0, lib).decode_pipelined(
            ref[0]))
    except ValueError as e:
        bad.append(f"decode raised {e}")
    for name, dec_frames in zip(("decode", "decode_pipelined"), got):
        if not all(np.array_equal(a, b) for fa, fb in zip(dec_frames, frames)
                   for a, b in zip(fa, fb)):
            bad.append(f"{name} differs from the input")
    return "ok" if not bad else "; ".join(bad)


def references(libs, cases, n, w, h):
    """case -> (frames, -O0 packets and tallies)."""
    o0 = native.load(libs["O0"])
    out = {}
    for case in cases:
        frames = synth_frames(native.NativeFFV1Codec(params_of(case, w, h),
                                                     1, o0), n)
        out[case] = (frames, encode_run(o0, case, frames, w, h))
    return out


def matrix(libs, refs, variants, w, h):
    """{variant: {case: 'ok' or what differs}}, one line printed each."""
    res = {}
    for v in variants:
        lib = native.load(libs[v])
        res[v] = {}
        for case, (frames, ref) in refs.items():
            res[v][case] = check_case(lib, case, frames, ref, w, h)
            print(f"matrix {v:18s} {case:24s} {res[v][case]}", flush=True)
    return res


def time_variants(libs, refs, variants, w, h):
    """Encode ms a frame by variant and case (host clock)."""
    out = {}
    for v in variants:
        lib = native.load(libs[v])
        for case in TIME_CASES:
            if case not in refs:
                continue
            frames = refs[case][0]
            _, _, stats, threads = CASES[case]
            ms = []
            for _ in range(TIME_REPS):
                codec = native.NativeFFV1Codec(params_of(case, w, h),
                                               threads, lib)
                if stats:
                    codec.enable_stats()
                for t, f in enumerate(frames):
                    t0 = time.perf_counter()
                    codec.encode(f, t == 0)
                    if t:
                        ms.append((time.perf_counter() - t0) * 1e3)
            out.setdefault(case, {})[v] = float(np.median(ms))
            print(f"time {v:18s} {case:24s} {out[case][v]:.3f} ms a frame",
                  flush=True)
    return out


def child(args):
    """One case under one build, in this process: print ``RESULT <json>``
    (run by ``--sanitize`` with a sanitizer's runtime preloaded)."""
    w, h = args.size
    o0 = native.load(args.o0)
    lib = native.load(args.lib)
    frames = synth_frames(native.NativeFFV1Codec(
        params_of(args.child, w, h), 1, o0), args.frames)
    ref = encode_run(o0, args.child, frames, w, h)
    print("RESULT " + json.dumps(check_case(lib, args.child, frames, ref,
                                            w, h)), flush=True)


def _child_cmd(case, lib, o0, args):
    return [sys.executable, "-m", "ffmpeg_ffv2_tpu_torch.tools.native_check",
            "--child", case, "--lib", lib, "--o0", o0,
            "--size", "x".join(map(str, args.size)),
            "--frames", str(args.frames)]


def _tail(text, n=40):
    return "\n".join(text.strip().splitlines()[-n:])


def sanitize(case, o0, args, out_dir):
    """Run ``case`` under -O3 builds with UBSan and ASan, and under
    valgrind's memcheck where the host has it; print each verdict."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root,
               UBSAN_OPTIONS="print_stacktrace=1",
               ASAN_OPTIONS="detect_leaks=0:verify_asan_link_order=0")
    runs = {}
    for name, flags in (("O3_ubsan", ["-O3", "-g", "-fsanitize=undefined"]),
                        ("O3_asan", ["-O3", "-g", "-fsanitize=address"])):
        try:
            lib = native.build(flags + COMMON, native._SRC)
        except RuntimeError as e:
            print(f"sanitize {name}: build failed: {_tail(str(e), 5)}")
            continue
        e = dict(env)
        if name == "O3_asan":
            rt = subprocess.run(["g++", "-print-file-name=libasan.so"],
                                capture_output=True, text=True).stdout
            e["LD_PRELOAD"] = rt.strip()
        runs[name] = (_child_cmd(case, lib, o0, args), e)
    valgrind = shutil.which("valgrind")
    if valgrind:
        lib = native.build(["-O3", "-g", *COMMON], native._SRC)
        runs["O3_memcheck"] = ([valgrind, "--error-exitcode=9",
                                "--track-origins=yes", *_child_cmd(
                                    case, lib, o0, args)], env)
    else:
        print("sanitize memcheck: valgrind is not on this host")
    for name, (cmd, e) in runs.items():
        r = subprocess.run(cmd, capture_output=True, text=True, env=e,
                           cwd=root)
        with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
            f.write(r.stdout + "\n----\n" + r.stderr)
        result = [ln for ln in r.stdout.splitlines()
                  if ln.startswith("RESULT ")]
        reports = [ln for ln in r.stderr.splitlines()
                   if "runtime error" in ln or "ERROR: AddressSanitizer" in ln
                   or "Invalid read" in ln or "Invalid write" in ln
                   or "uninitialised" in ln]
        print(f"sanitize {name}: rc {r.returncode}, "
              f"{result[0] if result else 'no result'}, "
              f"{len(reports)} reports")
        for ln in reports[:10]:
            print(f"  {ln}")
        if r.returncode and not result:
            print(_tail(r.stderr, 15))


def warnings():
    """The -O3 -Wall -Wextra warnings of the FFV1 runtime, counted by
    option."""
    with tempfile.TemporaryDirectory() as td:
        r = subprocess.run(["g++", "-O3", "-Wall", "-Wextra", *COMMON,
                            "-o", os.path.join(td, "w.so"), *native._SRC],
                           capture_output=True, text=True)
    lines = [ln for ln in r.stderr.splitlines() if "warning:" in ln]
    kinds = {}
    for ln in lines:
        k = ln.rsplit("[", 1)[-1].rstrip("]") if ln.endswith("]") else "?"
        kinds[k] = kinds.get(k, 0) + 1
    print(f"warnings -O3 -Wall -Wextra: {len(lines)} {kinds}")
    for ln in lines[:20]:
        print(f"  {ln}")


def _fails(flags, case, ref, frames, w, h):
    lib = native.load(native.build(flags, native._SRC))
    return check_case(lib, case, frames, ref, w, h) != "ok"


def rtl_dumps(variant, passes, function, out_dir):
    """Compile the FFV1 runtime at ``variant``'s flags to assembly with
    ``-fdump-rtl-PASS-slim`` for each of ``passes``, and write the part
    of each dump, and of the assembly, that belongs to the functions
    whose name holds ``function`` to ``out_dir/rtl_PASS.txt`` and
    ``out_dir/rtl.s``."""
    d = os.path.abspath(os.path.join(out_dir, "rtl"))
    os.makedirs(d, exist_ok=True)
    flags = [f for f in VARIANTS[variant] if f != "-shared"]
    asm = os.path.join(d, "ffv1.s")
    subprocess.run(["g++", *flags, "-S", *(f"-fdump-rtl-{p}-slim"
                                          for p in passes),
                    "-o", asm, native._SRC[0]], check=True, cwd=d)

    def sections(path, start):
        keep, out = False, []
        with open(path) as f:
            for ln in f:
                if start(ln):
                    keep = function in ln
                if keep:
                    out.append(ln)
        return out
    for p in passes:
        dump = [g for g in glob.glob(os.path.join(d, "*r.*"))
                if g.endswith("r." + p)]
        if not dump:
            print(f"rtl {p}: no dump")
            continue
        part = sections(dump[0], lambda ln: ln.startswith(";; Function "))
        with open(os.path.join(out_dir, f"rtl_{p}.txt"), "w") as f:
            f.writelines(part)
        os.unlink(dump[0])
        print(f"rtl {p}: {len(part)} lines of {function}")
    part = sections(asm, lambda ln: ln.startswith("_Z") and
                    ln.rstrip().endswith(":"))
    with open(os.path.join(out_dir, "rtl.s"), "w") as f:
        f.writelines(part)


def bisect(counter, case, refs, w, h, out_dir):
    """Least N at which -O3 with -fdbg-cnt=COUNTER:N fails ``case``; dumps
    the optimized trees at N - 1 and N and their diff to ``out_dir``."""
    frames, ref = refs[case]
    o3 = VARIANTS["O3"]

    def flags(n):
        return [*o3, f"-fdbg-cnt={counter}:{n}"]
    # one table a translation unit; the limit applies in each
    r = subprocess.run(["g++", *o3, "-fdbg-cnt-list", "-o", os.devnull,
                        *native._SRC], capture_output=True, text=True)
    total = None
    for ln in (r.stdout + r.stderr).splitlines():
        parts = ln.split()
        if parts and parts[0] == counter:
            total = max(total or 0, int(parts[1]))
    if total is None:
        print(f"bisect {counter}: no such counter in this g++")
        return None
    if _fails(flags(0), case, ref, frames, w, h):
        print(f"bisect {counter}: fails with the counter at 0 "
              f"(of {total}): not this counter")
        return None
    if not _fails(flags(total), case, ref, frames, w, h):
        print(f"bisect {counter}: passes with the counter at {total} "
              f"(all): no fault to bisect")
        return None
    lo, hi = 0, total                    # lo passes, hi fails
    k = max(1, min(7, os.cpu_count() or 1))
    while hi - lo > 1:
        pts = sorted({lo + (hi - lo) * (i + 1) // (k + 1)
                      for i in range(k)} - {lo, hi})
        with cf.ThreadPoolExecutor(len(pts)) as ex:
            paths = list(ex.map(lambda n: native.build(flags(n),
                                                       native._SRC), pts))
        verdict = [check_case(native.load(p), case, frames, ref, w, h)
                   != "ok" for p in paths]
        for n, bad in zip(pts, verdict):
            if bad:
                hi = n
                break
            lo = n
        print(f"bisect {counter}: between {lo} and {hi} of {total}",
              flush=True)
    dumps = {}
    for n in (hi - 1, hi):
        d = os.path.join(out_dir, f"{counter}_{n}")
        os.makedirs(d, exist_ok=True)
        subprocess.run(["g++", *flags(n), "-fdump-tree-optimized",
                        "-fdump-ipa-modref", "-dumpdir", d + "/", "-o",
                        os.path.join(d, "lib.so"), *native._SRC],
                       capture_output=True, text=True, check=True)
        opt = sorted(glob.glob(os.path.join(d, "*.optimized")))
        with open(opt[0]) as f:
            dumps[n] = f.read().splitlines()
    diff = list(difflib.unified_diff(dumps[hi - 1], dumps[hi],
                                     f"{counter}:{hi - 1}",
                                     f"{counter}:{hi}", n=12, lineterm=""))
    path = os.path.join(out_dir, f"{counter}_{hi}.diff")
    with open(path, "w") as f:
        f.write("\n".join(diff) + "\n")
    funcs = [ln for ln in diff if ln.startswith(";; Function")]
    print(f"bisect {counter}: fails from {hi} of {total}; the optimized "
          f"trees at {hi - 1} and {hi} differ in {len(diff)} diff lines "
          f"({path}); {funcs[:4]}")
    print(_tail("\n".join(diff), 60))
    return hi


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="1920x1080",
                    type=lambda s: tuple(int(v) for v in s.split("x")))
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--variants", default=",".join(
        v for v in VARIANTS if v != "O0"))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--warnings", action="store_true")
    ap.add_argument("--bisect", default="")
    ap.add_argument("--add", action="append", default=[],
                    metavar="NAME=FLAG,FLAG",
                    help="a variant of its own flags (the common ones "
                         "added), run with the others")
    ap.add_argument("--rtl", default="", metavar="VARIANT:PASS,PASS",
                    help="dump these RTL passes of --function")
    ap.add_argument("--function", default="put_symbol_stats")
    ap.add_argument("--out", default="build/native_check")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    ap.add_argument("--lib", default="", help=argparse.SUPPRESS)
    ap.add_argument("--o0", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args)
        return 0
    w, h = args.size
    os.makedirs(args.out, exist_ok=True)
    for item in args.add:
        name, flags = item.split("=", 1)
        VARIANTS[name] = [*flags.split(","), *COMMON]
    if args.rtl:
        variant, passes = args.rtl.split(":")
        rtl_dumps(variant, passes.split(","), args.function, args.out)
    r = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    print(f"g++: {r.stdout.splitlines()[0]}; {os.cpu_count()} cores; "
          f"{w}x{h}, {args.frames} frames a case", flush=True)
    variants = args.variants.split(",")
    cases = args.cases.split(",")
    t0 = time.perf_counter()
    libs = build_variants(["O0", *variants])
    print(f"built {len(libs)} variants in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    refs = references(libs, cases, args.frames, w, h)
    res = matrix(libs, refs, variants, w, h)
    failing = [c for c in cases if any(res[v][c] != "ok" for v in variants)]
    print(f"failing cases: {failing}")
    summary = {"matrix": res, "failing": failing}
    if args.time:
        summary["ms_a_frame"] = time_variants(libs, refs, variants, w, h)
    if args.warnings:
        warnings()
    if args.sanitize:
        sanitize((failing or cases)[0], libs["O0"], args, args.out)
    for counter in filter(None, args.bisect.split(",")):
        case = next((c for c in failing if res.get("O3", {}).get(c, "ok")
                     != "ok"), None)
        if case is None:
            print(f"bisect {counter}: -O3 fails no case")
            break
        summary.setdefault("bisect", {})[counter] = bisect(
            counter, case, refs, w, h, args.out)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    shipped_ok = all(v == "ok" for v in res.get("shipped", {}).values())
    return 0 if shipped_ok else 1


if __name__ == "__main__":
    sys.exit(main())
