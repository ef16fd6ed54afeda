"""CUDA-event times of the range path's kernels K4 (rac_render), K2
(adapt), emission_pack, K6 (adapt_emission), K3 (expand) and K1 (place),
of K1, K5 (vlc) and the ladder on the Golomb-Rice path, of K7 (rac_lanes,
the hybrid lane coder), of FFV2's K18 (pvq) and K19 (lap), and of the
tool kernels K10-K17, at the main path's shapes, for the checkout at
``--root``:

    python3 ffmpeg_ffv2_tpu_torch/tools/kernel_times.py [--root DIR]
        [--cases range,rgb48,bgr0_v4,rice,rice16,rice_bgr0,lanes,ffv2,
                 lap,rowcx,prefetch,roll,transpose,in_ds,probes]

``--root`` (default: this checkout) is the root of a checkout of the
repository, whose ``ffmpeg_ffv2_tpu_torch`` and ``chip_smoke.py`` are
imported, so that two versions of the kernels are timed by the same code
on one card: unpack the other version under a git-ignored directory and
run the script for each root in turns.  It captures frame 0 of 1080p
yuv420p (``FFV1Config(level=3, coder=1, slices=30)``, and ``coder=0``
for the rice case) and of 1080p rgb48 (``slicecrc=1``, coding depth 17,
R = 7) through that checkout's ``chip_smoke.probe`` and times each
kernel's wrapper on the captured inputs (median of ``REPS`` runs after a
warm-up); the packing of K2's slot words into emission order at the
frame's unsort width is ``adapt.pack_emission`` where the checkout has
it, else its plain repack (``pack_by`` says which).  ``bgr0_v4`` times
K6 and K2 on frame 0 of 1080p bgr0 at version 4 (``emission_order=True``,
``chip_smoke.synth_rgb_frames``, coding depth 9), and the packing with
K6's zero fill where the checkout has the kernel.  The rice cases time
K5 on frame 0 of 1080p yuv420p (``coder=0``; ``rice`` with K1 too), of
the same frame in 16 bits (``yuv420p16``, x << 8 | x, the params forced
to Golomb-Rice: pb = 16; ``rice16``) and of 1080p bgr0 (``chip_smoke.synth_rgb_frames``, coding
depth 9; ``rice_bgr0``); ``lanes`` times K7 on the lane matrices that
``TPUCoderFFV1Encoder`` (``coder=1``) plans for yuv420p frame 0.  The
``rice`` and ``rice16`` cases also time the ladder (``run_index_scan``)
on frame 0's events, with the device time of each kernel and torch op of
one call, and ``rice16`` the whole frame: ``encode()`` of frame 0 as an
inter frame after a key frame, ``FRAME_REPS`` times (host clock).  ``ffv2`` times K18 (``quantize_t``) on the streams of
``chip_smoke.synth_ffv2_frames`` frame 0 (1920x1080 yuv444p, qp
``chip_smoke.FFV2_QP``, 64x64 blocks): every band, then each run of
bands of one class (``pvq_classes``, where the checkout's library names
the classes) alone, with the device time of one
call, and each class's device time (``device_ms``) at each qp of
``QP_SWEEP`` (at qp 0 only the set-up runs: loads, sums, stores; each
step adds one pulse search).  ``lap`` times K19 on that frame's Q12
planes (``lap_frame``, pre and post, sb 64) and on a rank's band of
phase 19's 3840x2160 frame (``lap_dir``: the band's horizontal
direction, its two 32-row halo slabs at sb 16, its vertical direction);
``rowcx`` times K11 at ``tools/microbench_pallas.py``'s shapes
(``ROWCX_SHAPES``), ``roll`` K10 at them (``ROLL_SHAPES``) and
``prefetch`` K15 (``probes.big_prefetch``) on ``tools/probe_mosaic.py``'s
tables of 12K, 32K and 128K words at G = 4, ``transpose`` K12 at
``tools/microbench_pallas.py``'s shapes (``TRANSPOSE_SHAPES``), ``in_ds``
K14 and ``probes`` K13, K16 and K17 on ``tools/probe_mosaic.py``'s inputs
(``probes.inputs``), and K13, K16 and K17 on those inputs grown to the
rows of ``PROBE_TAIL_ROWS`` (``arange``; K16 ``% 128``, K17 with the
tool's idx: K13's block form past 8 rows, K16's and K17's grids of
several blocks); each is checked against its plain
version first, and
these six also time the launch floor, an empty kernel launched through
the checkout's own ``Kernel.launch`` (``empty_kernel``), and split a
call's host enqueue into its parts (``host_split_us``: a shape check,
``empty_like``, the stream handle, the launch).  Each gives its
launches a call, the CUDA-event ms around the wrapper, the device time
alone (``device_ms``), the host's
enqueue time alone (``host_ms``), the kernels' ``-Xptxas -v``
registers, spills and shared memory (``ptxas_of``) and counts of chosen
SASS instructions (``sass_counts``; MUFU.RCP is a division by a value
known only at run time).  For
K1 and K3 it also prints the device time of each kernel and torch op
that one wrapper call runs (``torch.profiler``, ms a call by name), and
K1's and K3's device time alone and host enqueue, and
the layout stage and K1 together (the encoder's own ``front``
or ``rice_front`` on frame 0, stopped by its ``mark`` hook after K1:
the median and quartiles of ``LAYOUT_REPS`` runs, and the device time
alone of one run, the sum of its kernels' spans).  Prints one JSON line
per case: the card (``nvidia-smi`` name and power limit), the root, ms,
ns a step (K4: the longest slice's live steps; K7: the lanes' steps) and
ns a chain row (K2, K6, K5: the longest tile chain's rows).  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time


REPS = 9                    # timed runs a kernel, after a warm-up
LAYOUT_REPS = 101           # timed runs of the layout stage and K1
FRAME_REPS = 7              # timed inter frames of the rice16 case
QP_SWEEP = (0, 1, 2, 4, 8, 16, 32)


def device_ms(fn, reps: int) -> float:
    """Median device time of fn()'s kernels over reps runs, after one
    warm-up: a sleep kernel (~1 ms) keeps the card busy while the host
    enqueues the start event, fn()'s launches and the stop event, so the
    span between the events holds fn()'s kernels and none of its host
    work or launch latency."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]
TOOL_CASES = ("rowcx", "prefetch", "roll", "transpose", "in_ds",
              "probes")
CASES = ("range", "rgb48", "bgr0_v4", "rice", "rice16", "rice_bgr0",
         "lanes", "ffv2", "lap") + TOOL_CASES
ROWCX_SHAPES = ((2048, 64), (512, 64))   # tools/microbench_pallas.py's
ROLL_SHAPES = ((512, 64), (2048, 64))    # tools/microbench_pallas.py's
TRANSPOSE_SHAPES = ((128, 32), (512, 32))  # tools/microbench_pallas.py's
PREFETCH_WORDS = (12, 32, 128)           # K table words, G = 4 rows
# the kernels of the probes case, by their names in _build.KERNELS
PROBE_KERNELS = ("probe_scalar_extract", "probe_roll_dynamic",
                 "probe_taa_rows")
PROBE_TAIL_ROWS = (9, 4096)   # K13, K16 and K17 past the tools' rows
TOOL_SASS = ("SHFL.IDX", "SHFL.BFLY", "BAR.SYNC", "LDS", "STS", "LDG.E",
             "STG.E", "LDL", "STL")
TOOL_REPS = 51              # timed runs of a tool kernel (µs-scale spans)
HOST_LOOP = 200             # calls a host-clock loop of the host split
# an empty kernel behind a launcher of K15's arguments, the launch floor
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" cudaError_t ffv2_empty(const int*, int, const int*, int, int*,
                                  cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return cudaGetLastError();
}
"""
EMPTY_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
               "-Xcompiler", "-fPIC")


def host_ms(fn, reps: int) -> float:
    """Median host time of enqueueing fn() (its Python, ctypes and launch
    calls) while a sleep kernel keeps the card busy, so no call waits on
    the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def ptxas_of(lib_path: str, name: str) -> dict:
    """{kernel: registers, spills, shared bytes} from the ``-Xptxas -v``
    lines of the build log beside ``lib_path``, for the entry functions
    whose mangled name holds ``name``."""
    log = os.path.join(os.path.dirname(lib_path), "build.log")
    out, fn = {}, None
    with open(log) as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)'?", line)
            if m:
                fn = m.group(1) if name in m.group(1) else None
                continue
            if fn is None:
                continue
            d = out.setdefault(fn, {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                d["spill_stores"], d["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                d["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                d["smem_bytes"] = int(m.group(1)) if m else 0
    return out


def sass_counts(lib_path: str, name: str, ops) -> dict:
    """{function: {op: count}} of the SASS instructions ``ops`` (e.g.
    "MUFU.RCP", a division by a value known only at run time) in the
    library's functions whose mangled name holds ``name``
    (``cuobjdump -sass``); empty where the toolkit has no cuobjdump."""
    from ffmpeg_ffv2_tpu_torch import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1) if name in m.group(1) else None
            if fn:
                out[fn] = {op: 0 for op in ops}
            continue
        if fn:
            for op in ops:
                if re.search(r"\b" + re.escape(op) + r"\b", line):
                    out[fn][op] += 1
    return out


def empty_kernel(_build):
    """A ``Kernel`` of the timed checkout whose launcher (K15's arguments)
    starts an empty kernel of one warp: the launch floor of a wrapper.
    ``EMPTY_CU`` is built under this script's own checkout, named by a
    hash of its source and flags, and its launcher is set on the timed
    checkout's loaded library (in memory), so that checkout's own
    ``Kernel.launch`` (whatever its version) finds it as it finds any
    launcher."""
    import ctypes
    import hashlib
    import tempfile
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    h = hashlib.sha256("\0".join([EMPTY_CU, *EMPTY_FLAGS]).encode())
    out_dir = os.path.join(here, "build", "kernel_times",
                           h.hexdigest()[:16])
    so = os.path.join(out_dir, "libffv2_empty.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            cu = os.path.join(tmp, "empty.cu")
            with open(cu, "w") as f:
                f.write(EMPTY_CU)
            part = os.path.join(tmp, "libffv2_empty.so")
            subprocess.run([_build._nvcc(), *EMPTY_FLAGS, "-o", part, cu],
                           check=True)
            os.replace(part, so)
    P, I = ctypes.c_void_p, ctypes.c_int
    args = [P, I, P, I, P, P]
    fn = ctypes.CDLL(so).ffv2_empty
    fn.argtypes, fn.restype = args, I
    setattr(_build.load(), "ffv2_empty", fn)
    return _build.Kernel("empty", "ffv2_empty", args, so, "none")


def loop_us(fn, n: int = HOST_LOOP, tries: int = 5) -> float:
    """Host µs a call of fn(), the best of ``tries`` loops of n calls
    (the card drained between loops)."""
    import torch
    best = None
    for _ in range(tries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) * 1e6 / n
        best = us if best is None else min(best, us)
    torch.cuda.synchronize()
    return best


def pvq_classes(bands) -> list:
    """K18's classes of band lengths as its launcher assigns them (the
    library's ``ffv2_pvq_class_of``), as runs of consecutive bands:
    [(positions a lane, first band, last band + 1)]."""
    from ffmpeg_ffv2_tpu_torch import _build
    lib = _build.load()
    runs = []
    for i, (a, b) in enumerate(zip(bands, bands[1:])):
        c = lib.ffv2_pvq_class_of(b - a)
        if c < 0:
            raise ValueError(f"K18 refuses a band of {b - a} positions")
        if runs and runs[-1][0] == c:
            runs[-1] = (c, runs[-1][1], i + 1)
        else:
            runs.append((c, i, i + 1))
    return [(lib.ffv2_pvq_class_items(c), i, j) for c, i, j in runs]


def main() -> int:
    ap = argparse.ArgumentParser()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--root", default=here)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated subset of " + ",".join(CASES))
    args = ap.parse_args()
    todo = args.cases.split(",")
    if not set(todo) <= set(CASES):
        ap.error(f"--cases: unknown {set(todo) - set(CASES)}")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.ffv1 import adapt as ad
    from ffmpeg_ffv2_tpu_torch.ffv1 import expand as ex
    from ffmpeg_ffv2_tpu_torch.ffv1 import host
    from ffmpeg_ffv2_tpu_torch.ffv1 import rac
    from ffmpeg_ffv2_tpu_torch.ffv1 import rice
    from ffmpeg_ffv2_tpu_torch.ffv1 import vlc
    from ffmpeg_ffv2_tpu_torch.ffv1.params import (CODER_GOLOMB, FFV1Config,
                                                   params_from_config)
    from ffmpeg_ffv2_tpu_torch.ffv1.tpu_coder import TPUCoderFFV1Encoder
    from ffmpeg_ffv2_tpu_torch.ops import place as pl
    from ffmpeg_ffv2_tpu_torch.tools import device_profile
    if not os.path.abspath(_build.__file__).startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.load()

    def split(fn):
        """{kernel or op: device ms a call} of one wrapper call."""
        return {name: round(ms, 5) for name, (ms, _) in
                sorted(device_profile(fn, REPS, "cuda").items())}

    class _AtK1(Exception):
        pass

    def stop_at_k1(name, inputs=None):
        if name == "K1 place":
            raise _AtK1

    def layout_k1(enc, frame):
        """The encoder's own front stage on frame 0 (its one bank's),
        stopped by its mark hook right after K1."""
        bank, c = enc.banks[0], enc.banks[0].caps
        dev = [torch.as_tensor(x, dtype=torch.int32, device="cuda")
               for x in frame]
        if bank.golomb:
            ctx, streams = bank.phase_a_rice(dev)
            args = (ctx, streams["payload"], bank.vcanon, True,
                    c.tiles_cap, c.cellrows_cap, stop_at_k1)
            front = bank.rice_front
        else:
            ctx, diff, _ = bank.range_streams(dev, True)
            args = (ctx, diff, bank.canonical_key, True, c.tiles_cap,
                    c.cellrows_cap, c.unsort_words, stop_at_k1)
            front = bank.front

        def run():
            try:
                front(*args)
            except _AtK1:
                pass
        run()
        ms = []
        for _ in range(LAYOUT_REPS):
            ms.append(cs.cuda_ms_once(run)[1])
        ms.sort()
        n = LAYOUT_REPS // 4
        return dict(layout_k1_ms=ms[LAYOUT_REPS // 2],
                    layout_k1_quartiles_ms=[ms[n], ms[-1 - n]],
                    layout_k1_device_ms=sum(split(run).values()))

    def k1_fields(enc, inputs, frame):
        k1 = inputs["k1"]
        return dict(k1_ms=cs.cuda_ms(lambda: pl.place(*k1), REPS),
                    k1_device_ms=device_ms(lambda: pl.place(*k1), REPS),
                    k1_host_ms=host_ms(lambda: pl.place(*k1), REPS),
                    k1_split=split(lambda: pl.place(*k1)),
                    **layout_k1(enc, frame))

    def k5_fields(enc, inputs):
        k5, bits = inputs["k5"], enc.banks[0].code_bits
        ms = cs.cuda_ms(lambda: vlc.vlc_adapt(*k5, bits), REPS)
        rows = cs.chain_rows(k5[1].tolist(), k5[3].tolist())
        return dict(code_bits=bits, k5_ms=ms, chain_rows=rows,
                    k5_ns_a_row=ms * 1e6 / rows)

    def ladder_fields(inputs):
        kl = inputs["kl"]
        n_ev = kl[4]
        sp = split(lambda: rice.run_index_scan(*kl))
        return dict(ladder_ms=cs.cuda_ms(lambda: rice.run_index_scan(*kl),
                                         REPS),
                    ladder_device_ms=sum(sp.values()), ladder_split=sp,
                    ladder_events=int(n_ev.sum()),
                    ladder_max_events=int(n_ev.max()))

    def pack_fields(walk, n_words, fill):
        """The packing of K2's slot words of ``walk`` into ``n_words``
        emission-order words: the kernel, or the checkout's plain repack
        (sign fill) where it has no kernel."""
        ch1c, caps, bases, code_bits = walk[0], walk[1], walk[2], walk[6]
        sv, _ = ad.adapt(*walk)
        if hasattr(ad, "pack_emission"):
            by = f"emission_pack kernel, {fill} fill"
            ms = cs.cuda_ms(lambda: ad.pack_emission(
                sv, ch1c, caps, bases, code_bits, n_words, fill), REPS)
        elif fill == "sign":
            by = "plain repack_emission_order"
            ms = cs.cuda_ms(lambda: ad.repack_emission_order(
                sv, ad.cell_diff(ch1c, code_bits), code_bits, n_words), REPS)
        else:
            return {}
        return dict(pack_ms=ms, pack_by=by, pack_words=n_words)

    yuv = cs.synth_1080p_frames(1)[0]
    cases = [("range", "yuv420p", yuv,
              FFV1Config(level=3, coder=1, slices=30)),
             ("rgb48", "rgb48", cs.synth_rgb48_frames(1)[0],
              FFV1Config(level=3, coder=1, slices=30, slicecrc=1))]
    for case, pix, frame, cfg in cases:
        if case not in todo:
            continue
        enc, inputs = cs.probe(f"kernel_times {pix}", pix, cs.W, cs.H, cfg,
                               frame)
        k = inputs["walk"]
        caps, pred = k[1], k[3]
        rows = cs.chain_rows(caps.tolist(), pred.tolist())
        live = int(inputs["n_ops"].max())
        ev = k + (host.n_ev_words(enc.banks[0].code_bits),)
        k3 = inputs["k3"]
        pack = pack_fields(k, enc.banks[0].caps.unsort_words, "sign")
        t4 = cs.cuda_ms(lambda: rac.rac_render(*inputs["k4"]), REPS)
        t2 = cs.cuda_ms(lambda: ad.adapt(*k), REPS)
        t6 = cs.cuda_ms(lambda: ad.adapt_emission(*ev), REPS)
        t3 = cs.cuda_ms(lambda: ex.expand(*k3), REPS)
        print(json.dumps(dict(
            card=card, root=root, pix=pix, coder="range",
            code_bits=enc.banks[0].code_bits,
            k4_ms=t4, k4_steps=inputs["k4"][1], k4_live_steps=live,
            k4_ns_a_step=t4 * 1e6 / live, k2_ms=t2, k6_ms=t6,
            chain_rows=rows, k2_ns_a_row=t2 * 1e6 / rows,
            k6_ns_a_row=t6 * 1e6 / rows, k3_ms=t3,
            k3_device_ms=device_ms(lambda: ex.expand(*k3), REPS),
            k3_host_ms=host_ms(lambda: ex.expand(*k3), REPS),
            k3_W=int(k3[0].shape[0]), k3_op_cap=int(k3[5]),
            k3_split=split(lambda: ex.expand(*k3)), **pack,
            **k1_fields(enc, inputs, frame))), flush=True)
        del enc, inputs, k, ev, k3
    if "bgr0_v4" in todo:
        rgb = cs.synth_rgb_frames(1)[0]
        enc, inputs = cs.probe("kernel_times bgr0 v4", "bgr0", cs.W, cs.H,
                               FFV1Config(level=4, coder=1, slices=30,
                                          slicecrc=1), rgb, emission=True)
        ev = inputs["walk"]
        k = ev[:7]
        rows = cs.chain_rows(k[1].tolist(), k[3].tolist())
        t6 = cs.cuda_ms(lambda: ad.adapt_emission(*ev), REPS)
        t2 = cs.cuda_ms(lambda: ad.adapt(*k), REPS)
        print(json.dumps(dict(
            card=card, root=root, pix="bgr0 v4", coder="range",
            code_bits=enc.banks[0].code_bits, k6_ms=t6, k6_words=ev[7],
            k2_ms=t2,
            chain_rows=rows, k6_ns_a_row=t6 * 1e6 / rows,
            **pack_fields(k, ev[7], "zero"))), flush=True)
        del enc, inputs, ev, k
    cfg = FFV1Config(level=3, coder=0, slices=30)
    if "rice" in todo:
        enc, inputs = cs.probe("kernel_times rice", "yuv420p", cs.W, cs.H,
                               cfg, yuv)
        print(json.dumps(dict(card=card, root=root, pix="yuv420p",
                              coder="rice", **k5_fields(enc, inputs),
                              **ladder_fields(inputs),
                              **k1_fields(enc, inputs, yuv))), flush=True)
        del enc, inputs
    if "rice16" in todo:
        p16 = dataclasses.replace(
            params_from_config(cfg, "yuv420p16", cs.W, cs.H),
            ac=CODER_GOLOMB)
        deep = [x << 8 | x for x in yuv]
        enc, inputs = cs.probe("kernel_times rice16", "yuv420p16", cs.W,
                               cs.H, cfg, deep, params=p16)
        enc.encode(deep, force_keyframe=True)
        frame_ms = []
        for _ in range(FRAME_REPS):
            t0 = time.perf_counter()
            enc.encode(deep)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps(dict(card=card, root=root, pix="yuv420p16",
                              coder="rice", **k5_fields(enc, inputs),
                              **ladder_fields(inputs),
                              inter_frame_ms=frame_ms,
                              inter_frame_median_ms=sorted(frame_ms)[
                                  FRAME_REPS // 2])), flush=True)
        del enc, inputs
    if "rice_bgr0" in todo:
        rgb = cs.synth_rgb_frames(1)[0]
        enc, inputs = cs.probe("kernel_times rice bgr0", "bgr0", cs.W, cs.H,
                               cfg, rgb)
        print(json.dumps(dict(card=card, root=root, pix="bgr0",
                              coder="rice", **k5_fields(enc, inputs))),
              flush=True)
        del enc, inputs
    if "lanes" in todo:
        enc = TPUCoderFFV1Encoder(cs.W, cs.H, "yuv420p",
                                  FFV1Config(level=3, coder=1, slices=30))
        svs, bits, lens, _ = enc._plan(yuv, True)
        k7 = enc.lane_matrices(svs, bits, lens)
        steps, lanes = k7[0].shape
        ms = cs.cuda_ms(lambda: rac.rac_lanes(*k7), REPS)
        print(json.dumps(dict(card=card, root=root, pix="yuv420p",
                              coder="hybrid range", k7_ms=ms,
                              k7_steps=steps, k7_lanes=lanes,
                              k7_ns_a_step=ms * 1e6 / steps)), flush=True)
    if "ffv2" in todo:
        from ffmpeg_ffv2_tpu_torch.ffv2 import FFV2Config
        from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
        from ffmpeg_ffv2_tpu_torch.ffv2 import dsp
        from ffmpeg_ffv2_tpu_torch.ffv2.native import NativeFFV2Encoder
        n, qp = dsp.SB_SIZE, cs.FFV2_QP
        enc = NativeFFV2Encoder(cs.W, cs.H, "yuv444p", FFV2Config(qp=qp),
                                "cuda")
        x = dv.upload(enc._pad(cs.synth_ffv2_frames(1, 8)[0]), 8, "cuda")
        streams = dv.encode_front_t(x, 8, n, n)
        bands = dsp.band_starts(n)
        sp = split(lambda: dv.quantize_t(streams, qp, bands, n))
        classes = []
        # a checkout whose library cannot name K18's classes (before its
        # class query) is timed as a whole call only
        labelled = hasattr(_build.load(), "ffv2_pvq_class_of")
        for items, i, j in pvq_classes(bands) if labelled else ():
            sub = bands[i:j + 1]
            classes.append(dict(
                bands=list(range(i, j)), positions_a_lane=items,
                ms=cs.cuda_ms(lambda: dv.quantize_t(streams, qp, sub, n),
                              REPS),
                device_ms_by_qp={q: device_ms(lambda: dv.quantize_t(
                    streams, q, sub, n), REPS) for q in QP_SWEEP}))
        print(json.dumps(dict(
            card=card, root=root, pix="yuv444p", coder="ffv2", qp=qp,
            rows=int(streams.shape[0]),
            k18_ms=cs.cuda_ms(lambda: dv.quantize_t(streams, qp, bands, n),
                              REPS),
            k18_device_ms=sum(sp.values()), k18_split=sp,
            k18_classes=classes)), flush=True)
    if "lap" in todo:
        from ffmpeg_ffv2_tpu_torch.ffv2 import FFV2Config
        from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
        from ffmpeg_ffv2_tpu_torch.ffv2 import dsp
        from ffmpeg_ffv2_tpu_torch.ffv2.native import NativeFFV2Encoder
        n = dsp.SB_SIZE
        calls = {}
        for (w, h) in ((cs.W, cs.H), cs.PAR_UHD):
            enc = NativeFFV2Encoder(w, h, "yuv444p", FFV2Config(qp=16),
                                    "cuda")
            x = dv.upload(enc._pad(cs.synth_ffv2_frames(1, 8, w=w, h=h)[0]),
                          8, "cuda")
            q12 = ((x << 4) - 2048).contiguous()
            if (w, h) == (cs.W, cs.H):
                for fwd in (True, False):
                    calls[f"lap_frame {'pre' if fwd else 'post'} "
                          f"{tuple(q12.shape)}"] = (
                        "lap_pre" if fwd else "lap_post", q12.clone(),
                        lambda c, f=fwd: dv.lap_frame(c, n, f))
                continue
            # phase 19's three lap_dir calls of a rank's band (2 ranks)
            band = q12[:, :q12.shape[1] // 2].contiguous()
            halo = torch.cat([band[:, :32], band[:, -32:]]).contiguous()
            for label, c, sb, vert in (("band horizontal", band, n, False),
                                       ("halo slabs", halo, 16, True),
                                       ("band vertical", band, n, True)):
                calls[f"lap_dir {label} {tuple(c.shape)}"] = (
                    "lap_pre", c.clone(),
                    lambda c, s=sb, v=vert: dv.lap_dir(c, s, True, v))
        res = {}
        for label, (kname, c, fn) in calls.items():
            k = _build.KERNELS[kname]
            before = k.launches
            fn(c)
            res[label] = dict(launches_a_call=k.launches - before,
                              ms=cs.cuda_ms(lambda: fn(c), REPS),
                              device_ms=device_ms(lambda: fn(c), REPS),
                              host_ms=host_ms(lambda: fn(c), REPS))
        print(json.dumps(dict(card=card, root=root, case="lap", sb=n,
                              calls=res, ptxas=ptxas_of(
                                  _build.library_path(), "lap"),
                              sass=sass_counts(_build.library_path(), "lap",
                                               ("MUFU.RCP", "IMAD.HI")))),
              flush=True)
    if set(todo) & set(TOOL_CASES):
        floor = empty_kernel(_build)
        x4 = torch.zeros((4, 128), dtype=torch.int32, device="cuda")
        out4 = torch.empty_like(x4)
        fargs = (x4.data_ptr(), 0, x4.data_ptr(), 4, out4.data_ptr(),
                 _build.stream_handle(x4))

        def timed(fn):
            return dict(ms=cs.cuda_ms(fn, TOOL_REPS),
                        device_ms=device_ms(fn, TOOL_REPS),
                        host_ms=host_ms(fn, TOOL_REPS))
        before = floor.launches
        floor.launch(*fargs)
        if floor.launches != before + 1:
            raise AssertionError("the empty kernel's launch was not counted")
        launch_floor = timed(lambda: floor.launch(*fargs))
        # the enqueue's parts, host µs a call
        dev = x4.device
        host_split_us = dict(
            check=loop_us(lambda: floor.check("x", x4, (4, 128), dev)),
            empty_like=loop_us(lambda: torch.empty_like(x4)),
            stream_handle=loop_us(lambda: _build.stream_handle(x4)),
            launch_empty=loop_us(lambda: floor.launch(*fargs)))

        def tool_times(label, K, fn, plain):
            """fn() checked against plain() and for one launch of K, then
            its times and host µs a call."""
            before = K.launches
            got = fn()
            if K.launches != before + 1 or not torch.equal(got, plain()):
                raise AssertionError(f"{label}: wrong result or launches")
            return dict(**timed(fn), call_host_us=loop_us(fn))

        def tool_line(case, res, names, ops=TOOL_SASS):
            lib = _build.library_path()
            print(json.dumps(dict(
                card=card, root=root, case=case, shapes=res,
                launch_floor=launch_floor, host_split_us=host_split_us,
                ptxas={f: d for n in names
                       for f, d in ptxas_of(lib, n).items()},
                sass={f: d for n in names
                      for f, d in sass_counts(lib, n, ops).items()})),
                flush=True)
    if "prefetch" in todo:
        from ffmpeg_ffv2_tpu_torch.tools import probes
        k15 = _build.KERNELS["probe_big_prefetch"]
        res = {}
        for n in PREFETCH_WORDS:
            tab = torch.arange(n * 1024, dtype=torch.int32, device="cuda")
            if int(probes.big_prefetch(tab, x4)[0, 0]) != 120:
                raise AssertionError(f"prefetch {n}K: wrong result")
            res[f"{n}K G=4"] = tool_times(
                f"prefetch {n}K", k15, lambda: probes.big_prefetch(tab, x4),
                lambda: probes.big_prefetch_plain(tab, x4))
        tool_line("prefetch", res, ("big_prefetch",),
                  ("SHFL.BFLY", "BAR.SYNC", "LDG.E", "LDG.E.128", "STG.E",
                   "STG.E.128"))
    for case, prim, shapes, sass_name in (
            ("rowcx", "rowcx", ROWCX_SHAPES, "rowcx_kernel"),
            ("roll", "roll", ROLL_SHAPES, "roll_kernel"),
            ("transpose", "transpose", TRANSPOSE_SHAPES, "transpose_kernel")):
        if case not in todo:
            continue
        from ffmpeg_ffv2_tpu_torch.tools import microbench_prims as mp
        fn, plain, K = mp.PRIMS[prim][:3]
        res = {}
        for R, reps in shapes:
            x = torch.arange(R * mp.LANES, dtype=torch.int32,
                             device="cuda").reshape(R, mp.LANES)
            label = f"({R}, 128) x{reps}"
            res[label] = tool_times(f"{case} {label}", K,
                                    lambda: fn(x, reps),
                                    lambda: plain(x, reps))
        tool_line(case, res, (sass_name,))
    for case, names in (("in_ds", ("probe_scalar_in_ds",)),
                        ("probes", PROBE_KERNELS)):
        if case not in todo:
            continue
        from ffmpeg_ffv2_tpu_torch.tools import probes
        res = {}
        for label, K, fn, plain, a, _, _ in probes.inputs("cuda"):
            if K.name in names:
                res[f"{K.name}: {label}"] = tool_times(
                    label, K, lambda: fn(*a), lambda: plain(*a))
        for R in PROBE_TAIL_ROWS if case == "probes" else ():
            x = torch.arange(R * 128, dtype=torch.int32,
                             device="cuda").reshape(R, 128)
            idx = (torch.arange(128, dtype=torch.int32, device="cuda")
                   * 7 % 128)[None, :]
            for name, fn, plain, xs in (
                    ("probe_scalar_extract", probes.scalar_extract,
                     probes.scalar_extract_plain, (x,)),
                    ("probe_roll_dynamic", probes.roll_dynamic,
                     probes.roll_dynamic_plain, (x % 128,)),
                    ("probe_taa_rows", probes.taa_rows,
                     probes.taa_rows_plain, (x, idx))):
                label = f"{name}: ({R}, 128)"
                res[label] = tool_times(label, _build.KERNELS[name],
                                        lambda: fn(*xs), lambda: plain(*xs))
        tool_line(case, res, [n[len("probe_"):] for n in names])
    return 0


if __name__ == "__main__":
    sys.exit(main())
