#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, ffmpeg_ffv2_tpu_torch's
DeviceFFV1Encoder.encode, at 1920x1080 yuv420p with FFV1Config(level=3,
coder=1, slices=30) on synthetic frames (bench.synth_1080p_frames), in
phases that each print a line:

0. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
1. the build of the four CUDA kernels from csrc/ (nvcc, on first use);
2. each kernel against its plain PyTorch version on the card, on the
   inputs frame 0 gives it (K2 and K4 plain versions on a stated cut),
   with CUDA-event times of both, plus the time of each stage of frame 0;
3. 8 frames (1 key, 7 inter) through encode(): every packet must equal
   NativeFFV1Codec's and decode back to the input exactly, every kernel
   must have launched and no plain version may have run.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero without that line.  Exits non-zero at once when torch sees no
CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

W, H, N_FRAMES = 1920, 1080, 8


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def max_abs_err(got, ref) -> float:
    import torch
    err = 0.0
    for a, b in zip(got, ref):
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a.long() - b.long()).abs().max()))
        if not torch.equal(a, b):
            raise AssertionError("kernel output differs from its plain "
                                 f"version (max abs err {err})")
    return err


def capture(enc, planes):
    """Run frame ``planes`` (a keyframe) through the encoder's stages one
    by one; returns each kernel's inputs and CUDA-event times per
    stage."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1 import device_coder as dc
    from ffmpeg_ffv2_tpu_torch.ffv1.adapt import adapt
    from ffmpeg_ffv2_tpu_torch.ffv1.expand import expand
    from ffmpeg_ffv2_tpu_torch.ffv1.rac import rac_render
    from ffmpeg_ffv2_tpu_torch.ops.place import place

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark("start")
    dev = [torch.as_tensor(pl, dtype=torch.int32, device=enc.device)
           for pl in planes]
    mark("upload")
    ctx, diff = enc.phase_a(dev)
    mark("phase_a")
    plan = enc.layout(ctx, diff, enc.tiles_cap, enc.cellrows_cap)
    mark("layout")
    k1 = (plan["dest"], plan["ch1"], plan["orig"], enc.cellrows_cap)
    ch1c, ch2c = place(*k1)
    mark("K1 place")
    s0 = dc.build_s0_blocks(plan, enc.canonical_key, enc.tiles_cap)
    mark("s0")
    k2 = (ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
          s0, enc.table)
    sv, ends = adapt(*k2, enc.code_bits)
    mark("K2 adapt")
    ev_cells = dc.repack_emission_order(sv, (ch1c & 0xFFF) - 2048,
                                        enc.code_bits, enc.unsort_words)
    mark("repack")
    dc.writeback_canonical(plan, enc.canonical_key, ends, enc.tiles_cap)
    mark("writeback")
    words, maxc = dc.unsort_cells(ev_cells, ch1c, ch2c, enc.S, enc.npix)
    mark("unsort")
    svp, btp, hlen = enc.prefix[True]
    k3 = (words, diff, svp, btp, hlen, enc.op_cap)
    opw, n_ops = expand(*k3)
    mark("K3 expand")
    opmax = int(n_ops.max())
    mark("sizes to host")
    steps = max(512, min(1 << opmax.bit_length(), opw.shape[1]))
    k4 = (opw, steps, enc.render_cap)
    by, ln = rac_render(*k4)
    mark("K4 rac_render")
    by_h, ln_h = by.cpu().numpy(), ln.cpu().numpy()
    mark("bytes to host")
    torch.cuda.synchronize()
    stages = {name: round(marks[i - 1][1].elapsed_time(ev), 4)
              for i, (name, ev) in enumerate(marks) if i}
    t0 = time.perf_counter()
    enc._finish_packet([by_h[s, :ln_h[s]].tobytes() for s in range(enc.S)])
    stages["slice trailers + CRC (host clock)"] = round(
        (time.perf_counter() - t0) * 1e3, 4)
    return dict(k1=k1, k2=k2, k3=k3, k4=k4), stages


def kernel_checks(inputs):
    """Each kernel against its plain version on the card; returns the
    kernel entries of the result line (without the launch counts)."""
    import torch
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.ffv1 import adapt as ad
    from ffmpeg_ffv2_tpu_torch.ffv1 import expand as ex
    from ffmpeg_ffv2_tpu_torch.ffv1 import rac
    from ffmpeg_ffv2_tpu_torch.ops import place as pl

    out = {}

    def entry(name, err, ms, plain_ms, **extra):
        k = _build.KERNELS[name]
        out[name] = dict(name=name, route="cuda", source=k.source,
                         replaces=k.replaces, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, **extra)
        log(f"kernel {name}: equal to plain (tolerance: exact, "
            f"torch.equal), max_abs_err {err}, kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms"
            + "".join(f", {a} {b}" for a, b in extra.items()))

    # K1 place: full main-path shapes
    k1 = inputs["k1"]
    err = max_abs_err(pl.place(*k1), pl.scatter_cells(*k1))
    entry("place", err, cuda_ms(lambda: pl.place(*k1), 5),
          cuda_ms(lambda: pl.scatter_cells(*k1), 5),
          shape=f"N={k1[0].shape[0]} cells={k1[3] * 128}")

    # K2 adapt: kernel on every tile; the plain row scan on a cut of
    # tiles closed under tile_pred (the first two non-empty tiles and the
    # last four), and the kernel again with every other tile emptied
    ch1c, caps, bases, pred, s0, table = inputs["k2"]
    caps_h, pred_h = caps.tolist(), pred.tolist()
    nonempty = [t for t, c in enumerate(caps_h) if c > 0]
    cut = set(nonempty[:2] + nonempty[-4:])
    for t in list(cut):
        while pred_h[t] >= 0:
            t = pred_h[t]
            cut.add(t)
    cut = sorted(cut)
    in_cut = torch.zeros_like(caps, dtype=torch.bool)
    in_cut[cut] = True
    caps_cut = torch.where(in_cut, caps, 0)
    bases_h = bases.tolist()
    rows = torch.cat([torch.arange(bases_h[t], bases_h[t] + caps_h[t],
                                   device=caps.device) for t in cut])
    sv_k, ends_k = ad.adapt(ch1c, caps, bases, pred, s0, table, 8)
    sv_c, ends_c = ad.adapt(ch1c, caps_cut, bases, pred, s0, table, 8)
    sv_p, ends_p = ad.adapt_plain(ch1c, caps, bases, pred, s0, table,
                                  tiles=cut)
    err = max_abs_err([sv_k[rows], ends_k[cut], sv_c[rows], ends_c[cut]],
                      [sv_p[rows], ends_p[cut], sv_p[rows], ends_p[cut]])
    entry("adapt", err, cuda_ms(lambda: ad.adapt(*inputs["k2"], 8), 5),
          cuda_ms(lambda: ad.adapt_plain(ch1c, caps, bases, pred, s0,
                                         table, tiles=cut), 1),
          ms_cut=cuda_ms(lambda: ad.adapt(ch1c, caps_cut, bases, pred, s0,
                                          table, 8), 5),
          cut=f"tiles {cut} ({rows.numel()} of {int(caps.sum())} rows); "
              "plain_ms and ms_cut on the cut, ms on every tile",
          split_tiles=sum(1 for t in pred_h if t >= 0))

    # K3 expand: full main-path shapes
    k3 = inputs["k3"]
    err = max_abs_err(ex.expand(*k3), ex.expand_plain(*k3))
    entry("expand", err, cuda_ms(lambda: ex.expand(*k3), 5),
          cuda_ms(lambda: ex.expand_plain(*k3), 3),
          shape=f"S={k3[1].shape[0]} npix={k3[1].shape[1]} op_cap={k3[5]}")

    # K4 rac_render: kernel on the frame's op streams; kernel and plain on
    # the first 2048 op steps of every slice ending in the tail ops
    opw, steps, buf_cap = inputs["k4"]
    n = 2048
    opw_cut = opw[:, :n].clone()
    opw_cut[:, -3:] = torch.tensor([(1 << 9) | 129, 2 << 9, 3 << 9],
                                   dtype=torch.int32, device=opw.device)
    err = max_abs_err(rac.rac_render(opw_cut, n, 8192),
                      rac.rac_render_plain(opw_cut, n, 8192))
    entry("rac_render", err,
          cuda_ms(lambda: rac.rac_render(opw, steps, buf_cap), 5),
          cuda_ms(lambda: rac.rac_render_plain(opw_cut, n, 8192), 1),
          ms_cut=cuda_ms(lambda: rac.rac_render(opw_cut, n, 8192), 5),
          cut=f"first {n} op steps of each of {opw.shape[0]} slices; "
              f"plain_ms and ms_cut on the cut, ms on {steps} steps")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from bench import synth_1080p_frames
    from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder

    # 0. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"phase 0: device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    _build.load()
    log(f"phase 1: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({_build.library_path()})")
    with open(os.path.join(os.path.dirname(_build.library_path()),
                           "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

    # 2. each kernel against its plain version on frame 0's inputs
    cfg = FFV1Config(level=3, coder=1, slices=30)
    p = params_from_config(cfg, "yuv420p", W, H)
    frames = synth_1080p_frames(N_FRAMES)
    probe = DeviceFFV1Encoder(W, H, "yuv420p", cfg, device="cuda")
    probe.encode(frames[0], force_keyframe=True)     # settles the caps
    capture(probe, frames[0])                        # warm-up
    inputs, stages = capture(probe, frames[0])
    log("phase 2: frame 0 stage times (ms, CUDA events): "
        + json.dumps(stages))
    kernels = kernel_checks(inputs)
    del inputs

    # 3. the main path: 8 frames through encode()
    enc = DeviceFFV1Encoder(W, H, "yuv420p", cfg, device="cuda")
    _build.reset_counts()
    packets, ms = [], []
    for t, frame in enumerate(frames):
        t0 = time.perf_counter()
        packets.append(enc.encode(frame, force_keyframe=t == 0))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in _build.KERNELS.values()}
    plain = {k.name: k.plain_calls for k in _build.KERNELS.values()}
    nat = NativeFFV1Codec(p)
    dec = NativeFFV1Codec(p)
    for t, (frame, pkt) in enumerate(zip(frames, packets)):
        ref = nat.encode(frame, t == 0)
        if pkt != ref:
            raise AssertionError(f"frame {t}: packet differs from "
                                 f"NativeFFV1Codec ({len(pkt)} vs "
                                 f"{len(ref)} bytes)")
        for a, b in zip(dec.decode(pkt), frame):
            if not np.array_equal(a, b):
                raise AssertionError(f"frame {t}: decode is not lossless")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain}")
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    log(f"phase 3: {N_FRAMES} frames 1920x1080 yuv420p (1 key + "
        f"{N_FRAMES - 1} inter, 30 slices, level 3, coder 1) byte-identical "
        f"to NativeFFV1Codec and decoded losslessly; launches {launches}, "
        f"plain calls {plain}")
    log(f"phase 3: ms per frame {[round(x, 2) for x in ms]}; inter-frame "
        f"median {steady:.2f} ms = {W * H / steady / 1e3:.2f} Mpixel/s "
        f"[{card}]; packet bytes {[len(x) for x in packets]}")

    for name, k in kernels.items():
        k["launches"] = launches[name]
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
