#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths through ffmpeg_ffv2_tpu_torch's
DeviceFFV1Encoder.encode at 1920x1080 yuv420p with FFV1Config(level=3,
slices=30): coder=1 (the range coder) and coder=0 (Golomb-Rice, FFV1's
default for 8-bit video), on synthetic frames (``synth_1080p_frames``), in
phases that each print a line:

0. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
1. the build of the CUDA kernels from csrc/ (one nvcc per source, all
   started together) and of the native C++ FFV1 codec, the oracle (g++);
2. range: K1-K4 each against its plain PyTorch version on the card, on the
   inputs frame 0 gives it (K2 and K4 plain versions on a stated cut),
   with CUDA-event times of both, plus the time of each stage of frame 0;
3. range: 8 frames (1 key, 7 inter) through encode(): every packet must
   equal the native codec's and decode back to the input exactly, K1-K4
   must have launched and no plain version may have run;
4. Golomb-Rice: K5 (vlc) against its plain version (on a cut) and the
   ladder kernel against its plain loop (on the frame's events), K1 again
   on the rice cells, all on the inputs the encoder's own stages give
   them, and the stage times of frame 0;
5. Golomb-Rice: 8 frames through encode(), checked as in phase 3, with K1,
   K5 and the ladder kernel launched and no plain version run.

The launch counts of a path are reset just before its 8 frames and read
just after.  The line before the last is a JSON object with one entry per
kernel: its times, its bound on this card (bytes over the memory rate or
operations over the peak rate, whichever is larger, from this run's
inputs; and for a serial kernel the longest dependent chain at one step
per SM clock) and the time of one PyTorch call computing the same function
where there is one.  The last line is {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero without those lines.  Exits non-zero at
once when torch sees no CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

W, H, N_FRAMES = 1920, 1080, 8
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
# no int32 rate is published; the float32 non-tensor peak (67 TFLOP/s) is
# no lower than the int32 rate, so ops over it are a lower bound on time
OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def synth_1080p_frames(n, w=W, h=H):
    """bench.py:synth_1080p_frames: a gradient plus 2-bit noise (luma) and
    a moving ramp (chroma), frame t shifted by t."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((xx * 3 + yy * 2) % 256 // 8 * 8).astype(np.int32)
    cyy, cxx = np.mgrid[0:h // 2, 0:w // 2]
    cb = ((cxx + cyy) % 256).astype(np.int32)
    rng = np.random.RandomState(0)
    noise = rng.randint(0, 4, (h, w)).astype(np.int32)
    return [[(base + t * 5 + noise) & 0xFF, (cb + t * 3) & 0xFF,
             (cb * 2 + t) & 0xFF] for t in range(n)]


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


def bound(nbytes: int, ops: int, chain_steps: int | None = None,
          clock_mhz: float | None = None) -> dict:
    """The least time of the work on this card: bytes (each input read
    once, each output written once) over the memory rate, or operations
    over the peak rate, whichever is larger; for a serial kernel also its
    longest dependent chain at one step per SM clock cycle.  The callers
    count what this run's data needs (valid cells, tiles in use, events,
    op words), never the padded capacities."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / OPS_PER_S * 1e3
    out = dict(bound_ms=max(b_ms, o_ms),
               bound_by="bytes" if b_ms >= o_ms else "operations",
               bound_bytes=int(nbytes), bound_ops=int(ops))
    if chain_steps is not None:
        out["chain_steps"] = int(chain_steps)
        out["chain_bound_ms"] = chain_steps / (clock_mhz * 1e3)
    return out


def chain_rows(caps_h, pred_h) -> int:
    """Rows on the longest successor chain of tiles (a lane's serial
    walk)."""
    total = list(caps_h)
    for t, p in enumerate(pred_h):      # predecessors come first
        if p >= 0:
            total[t] += total[p]
    return max([max(c, 0) for c in total] or [0])


def cut_tiles(caps, pred):
    """The first two non-empty tiles and the last four, closed under
    tile_pred; returns (tiles, caps with every other tile emptied, the
    cut's rows)."""
    import torch
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
    return cut, torch.where(in_cut, caps, 0)


class Marks:
    """CUDA events between the stages of one frame, and the inputs of each
    kernel stage (the encoder's ``mark`` hook, see ``rice.no_mark``)."""

    def __init__(self):
        import torch
        self.torch = torch
        self.marks = []
        self.inputs = {}
        self("start")

    def __call__(self, name, inputs=None):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))
        if inputs is not None:
            self.inputs[name] = inputs

    def stages(self) -> dict:
        self.torch.cuda.synchronize()
        return {name: round(self.marks[i - 1][1].elapsed_time(ev), 4)
                for i, (name, ev) in enumerate(self.marks) if i}


def capture_range(enc, planes):
    """Run range frame ``planes`` (a keyframe) through the encoder's stages
    one by one; returns each kernel's inputs and the stage times."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1 import device_coder as dc
    from ffmpeg_ffv2_tpu_torch.ffv1.adapt import adapt
    from ffmpeg_ffv2_tpu_torch.ffv1.expand import expand
    from ffmpeg_ffv2_tpu_torch.ffv1.rac import rac_render
    from ffmpeg_ffv2_tpu_torch.ops.place import place

    mark = Marks()
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
    stages = mark.stages()
    t0 = time.perf_counter()
    enc._finish_packet([by_h[s, :ln_h[s]].tobytes() for s in range(enc.S)])
    stages["slice trailers + CRC (host clock)"] = round(
        (time.perf_counter() - t0) * 1e3, 4)
    return dict(k1=k1, k2=k2, k3=k3, k4=k4, n_ops=n_ops,
                rendered=int(ln_h.sum())), stages


def capture_rice(enc, planes):
    """Run Golomb-Rice frame ``planes`` (a keyframe) through the encoder's
    own stages (``rice_front``, ``rice_bits``) with a CUDA event after
    each; returns each kernel's inputs and the stage times."""
    import torch
    mark = Marks()
    dev = [torch.as_tensor(pl, dtype=torch.int32, device=enc.device)
           for pl in planes]
    mark("upload")
    ctx, streams = enc.phase_a_rice(dev)
    mark("phase_a + run planning")
    codes, _, _ = enc.rice_front(ctx, streams["payload"], enc.vcanon, True,
                                 enc.tiles_cap, enc.cellrows_cap, mark)
    by, nbits, _ = enc.rice_bits(streams, codes, enc.ev_cap, enc.nwords,
                                 mark)
    nb = nbits.tolist()
    mark("sizes to host")
    by_h = by.cpu().numpy()
    mark("bytes to host")
    stages = mark.stages()
    t0 = time.perf_counter()
    enc._finish_packet(enc.rice_slices(by_h, nb, True))
    stages["slice headers + trailers + CRC (host clock)"] = round(
        (time.perf_counter() - t0) * 1e3, 4)
    return dict(k1=mark.inputs["K1 place"], k5=mark.inputs["K5 vlc"],
                kl=mark.inputs["ladder kernel"]), stages


def entry(out, name, err, ms, plain_ms, library_ms, bnd, **extra):
    from ffmpeg_ffv2_tpu_torch import _build
    k = _build.KERNELS[name]
    out[name] = dict(name=name, route="cuda", source=k.source,
                     replaces=k.replaces, max_abs_err=err, ms=ms,
                     plain_ms=plain_ms, library_ms=library_ms, **bnd,
                     **extra)
    log(f"kernel {name}: equal to plain (tolerance: exact, torch.equal), "
        f"max_abs_err {err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms} ms, bound {bnd['bound_ms']:.5f} ms "
        f"({bnd['bound_by']})"
        + (f", chain bound {bnd['chain_bound_ms']:.4f} ms"
           if "chain_bound_ms" in bnd else "")
        + "".join(f", {a} {b}" for a, b in extra.items()))


def used_tiles(caps) -> int:
    return int((caps > 0).sum())


def live_cells(ch1c) -> tuple:
    """(cells with the valid flag, of them the ones not silent)."""
    valid = (ch1c >> 13) & 1
    return int(valid.sum()), int((valid & (1 - ((ch1c >> 12) & 1))).sum())


def place_checks(out, k1, rice_k1):
    """K1 on the range cells and on the rice cells; library call: one
    scatter_ of both channels.  Bound: each element read (dest and two
    channels) and both channels written up to the last row in use."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ops import place as pl
    dest, ch1, orig, cellrows = k1
    err = max(max_abs_err(pl.place(*a), pl.scatter_cells(*a))
              for a in (k1, rice_k1))
    cells = cellrows * 128
    rows_used = int(torch.where(dest < cells, dest, -1).max()) // 128 + 1
    idx = torch.where((dest >= 0) & (dest < cells), dest, cells).long()
    idx2 = idx.expand(2, -1).contiguous()
    vals2 = torch.stack([ch1, orig])
    out2 = torch.empty((2, cells + 1), dtype=torch.int32, device=dest.device)
    n = dest.shape[0]
    entry(out, "place", err, cuda_ms(lambda: pl.place(*k1), 5),
          cuda_ms(lambda: pl.scatter_cells(*k1), 5),
          cuda_ms(lambda: out2.scatter_(1, idx2, vals2), 5),
          bound(n * 12 + rows_used * 128 * 8, n),
          ms_rice=cuda_ms(lambda: pl.place(*rice_k1), 5),
          shape=f"N={n} cells={cells} ({rows_used} rows in use) (range); "
                f"rice N="
                f"{rice_k1[0].shape[0]} cells={rice_k1[3] * 128}")


def range_checks(out, inputs, clock_mhz):
    """K2-K4 against their plain versions on range frame 0's inputs."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1 import adapt as ad
    from ffmpeg_ffv2_tpu_torch.ffv1 import expand as ex
    from ffmpeg_ffv2_tpu_torch.ffv1 import rac

    # K2 adapt: kernel on every tile; the plain row scan on a cut of
    # tiles closed under tile_pred, and the kernel again on the cut
    ch1c, caps, bases, pred, s0, table = inputs["k2"]
    cut, caps_cut = cut_tiles(caps, pred)
    bases_h, caps_h = bases.tolist(), caps.tolist()
    rows = torch.cat([torch.arange(bases_h[t], bases_h[t] + caps_h[t],
                                   device=caps.device) for t in cut])
    sv_k, ends_k = ad.adapt(*inputs["k2"], 8)
    sv_c, ends_c = ad.adapt(ch1c, caps_cut, bases, pred, s0, table, 8)
    sv_p, ends_p = ad.adapt_plain(*inputs["k2"], tiles=cut)
    err = max_abs_err([sv_k[rows], ends_k[cut], sv_c[rows], ends_c[cut]],
                      [sv_p[rows], ends_p[cut], sv_p[rows], ends_p[cut]])
    # bound: each valid cell read and its 8 sv words written, the start
    # and end blocks and the tile words of the tiles in use, the table
    n_rows = sum(c for c in caps_h if c > 0)
    tiles = used_tiles(caps)
    valid, _ = live_cells(ch1c)
    entry(out, "adapt", err, cuda_ms(lambda: ad.adapt(*inputs["k2"], 8), 5),
          cuda_ms(lambda: ad.adapt_plain(*inputs["k2"], tiles=cut), 1),
          None,
          bound(valid * (4 + 32) + tiles * ((33 + 32) * 128 * 4 + 12)
                + 512, valid * 32, chain_rows(caps_h, pred.tolist()),
                clock_mhz),
          ms_cut=cuda_ms(lambda: ad.adapt(ch1c, caps_cut, bases, pred, s0,
                                          table, 8), 5),
          cut=f"tiles {cut} ({rows.numel()} of {n_rows} rows); plain_ms "
              "and ms_cut on the cut, ms on every tile",
          split_tiles=sum(1 for t in pred.tolist() if t >= 0))

    # K3 expand: full main-path shapes; bound: the inputs read, the op
    # words the slices hold written (not the op_cap capacity)
    k3 = inputs["k3"]
    words, diff, svp, btp, hlen, op_cap = k3
    err = max_abs_err(ex.expand(*k3), ex.expand_plain(*k3))
    n_ops = int(inputs["n_ops"].sum())
    entry(out, "expand", err, cuda_ms(lambda: ex.expand(*k3), 5),
          cuda_ms(lambda: ex.expand_plain(*k3), 3), None,
          bound(4 * (words.numel() + diff.numel() + svp.numel()
                     + btp.numel() + hlen.numel() + n_ops
                     + diff.shape[0]), n_ops),
          shape=f"S={diff.shape[0]} npix={diff.shape[1]} op_cap={op_cap}")

    # K4 rac_render: kernel on the frame's op streams; kernel and plain on
    # the first 2048 op steps of every slice ending in the tail ops
    opw, steps, buf_cap = inputs["k4"]
    n = 2048
    opw_cut = opw[:, :n].clone()
    opw_cut[:, -3:] = torch.tensor([(1 << 9) | 129, 2 << 9, 3 << 9],
                                   dtype=torch.int32, device=opw.device)
    err = max_abs_err(rac.rac_render(opw_cut, n, 8192),
                      rac.rac_render_plain(opw_cut, n, 8192))
    S = opw.shape[0]
    entry(out, "rac_render", err,
          cuda_ms(lambda: rac.rac_render(opw, steps, buf_cap), 5),
          cuda_ms(lambda: rac.rac_render_plain(opw_cut, n, 8192), 1), None,
          bound(n_ops * 4 + inputs["rendered"] + S * 4, n_ops,
                int(inputs["n_ops"].max()), clock_mhz),
          ms_cut=cuda_ms(lambda: rac.rac_render(opw_cut, n, 8192), 5),
          cut=f"first {n} op steps of each of {S} slices; plain_ms and "
              f"ms_cut on the cut, ms on {steps} steps")


def rice_checks(out, inputs, clock_mhz):
    """K5 and the ladder kernel against their plain versions on rice frame
    0's inputs."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1 import rice
    from ffmpeg_ffv2_tpu_torch.ffv1 import vlc

    k5 = inputs["k5"]
    ch1c, caps, bases, pred, s0 = k5
    cut, caps_cut = cut_tiles(caps, pred)
    bases_h, caps_h = bases.tolist(), caps.tolist()
    rows = torch.cat([torch.arange(bases_h[t], bases_h[t] + caps_h[t],
                                   device=caps.device) for t in cut])
    code_k, ends_k = vlc.vlc_adapt(*k5, 8)
    code_c, ends_c = vlc.vlc_adapt(ch1c, caps_cut, bases, pred, s0, 8)
    code_p, ends_p = vlc.vlc_adapt_plain(*k5, 8, tiles=cut)
    err = max_abs_err(
        [code_k[rows], ends_k[cut], code_c[rows], ends_c[cut]],
        [code_p[rows], ends_p[cut], code_p[rows], ends_p[cut]])
    # bound: each valid cell read and its code written, the start and end
    # blocks and the tile words of the tiles in use
    n_rows = sum(c for c in caps_h if c > 0)
    tiles = used_tiles(caps)
    valid, live = live_cells(ch1c)
    entry(out, "vlc", err, cuda_ms(lambda: vlc.vlc_adapt(*k5, 8), 5),
          cuda_ms(lambda: vlc.vlc_adapt_plain(*k5, 8, tiles=cut), 1), None,
          bound(valid * 8 + tiles * ((5 + 4) * 128 * 4 + 12), live * 40,
                chain_rows(caps_h, pred.tolist()), clock_mhz),
          ms_cut=cuda_ms(lambda: vlc.vlc_adapt(ch1c, caps_cut, bases, pred,
                                               s0, 8), 5),
          cut=f"tiles {cut} ({rows.numel()} of {n_rows} rows); plain_ms "
              "and ms_cut on the cut, ms on every tile",
          split_tiles=sum(1 for t in pred.tolist() if t >= 0),
          valid_cells=valid, live_cells=live)

    # the ladder: kernel and plain loop on frame 0's events, each lane
    # walked as far as its event count; bound: per event its count and
    # three flags read and its index written, plus the counts
    kl = inputs["kl"]
    n_ev = kl[4]
    L, E = kl[0].shape
    live_ev = torch.arange(E, device=n_ev.device)[None, :] < n_ev[:, None]
    err = max_abs_err([rice.run_index_scan(*kl)[live_ev]],
                      [rice.run_index_scan_plain(*kl)[live_ev]])
    events = int(n_ev.sum())
    entry(out, "ladder", err, cuda_ms(lambda: rice.run_index_scan(*kl), 5),
          cuda_ms(lambda: rice.run_index_scan_plain(*kl), 1), None,
          bound(events * (4 + 3 + 4) + L * 4, events * 10, int(n_ev.max()),
                clock_mhz),
          shape=f"{L} slices, ev_cap {E} slots",
          events=events, max_events=int(n_ev.max()))


def drive(enc, frames, nat, dec, card, label, phase):
    """The main path of one coder: frames through encode() with the launch
    counts reset just before; every packet against the native codec and
    its lossless decode.  Returns the launch counts."""
    from ffmpeg_ffv2_tpu_torch import _build
    _build.reset_counts()
    packets, ms = [], []
    for t, frame in enumerate(frames):
        t0 = time.perf_counter()
        packets.append(enc.encode(frame, force_keyframe=t == 0))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.name: k.launches for k in _build.KERNELS.values()}
    plain = {k.name: k.plain_calls for k in _build.KERNELS.values()}
    for t, (frame, pkt) in enumerate(zip(frames, packets)):
        ref = nat.encode(frame, t == 0)
        if pkt != ref:
            raise AssertionError(f"{label} frame {t}: packet differs from "
                                 f"the native codec ({len(pkt)} vs "
                                 f"{len(ref)} bytes)")
        for a, b in zip(dec.decode(pkt), frame):
            if not np.array_equal(a, b):
                raise AssertionError(f"{label} frame {t}: decode is not "
                                     "lossless")
    for name in enc.kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{label} path")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the {label} path: "
                             f"{plain}")
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    log(f"phase {phase}: {label}: {len(frames)} frames 1920x1080 yuv420p "
        f"(1 key + "
        f"{len(frames) - 1} inter, 30 slices, level 3) byte-identical to "
        f"the native codec and decoded losslessly; launches {launches}, "
        f"plain calls {plain}")
    log(f"phase {phase}: {label}: ms per frame "
        f"{[round(x, 2) for x in ms]}; inter-frame "
        f"median {steady:.2f} ms = {W * H / steady / 1e3:.2f} Mpixel/s "
        f"[{card}]; packet bytes {[len(x) for x in packets]}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.ffv1 import native
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config, params_from_config

    # 0. device
    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0].strip()

    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    log(card)
    log(f"phase 0: device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}, max SM "
        f"clock {clock_mhz} MHz")

    # 1. build: the native oracle (g++) beside the kernels (nvcc)
    t0 = time.perf_counter()
    nat_err = []

    def build_native():
        try:
            native.build()
        except Exception as e:            # re-raised below, after the join
            nat_err.append(e)

    th = threading.Thread(target=build_native)
    th.start()
    _build.load()
    t_kern = time.perf_counter() - t0
    th.join()
    if nat_err:
        raise nat_err[0]
    log(f"phase 1: kernels built and loaded in {t_kern:.1f} s "
        f"({_build.library_path()}); native codec built by "
        f"{time.perf_counter() - t0:.1f} s")
    with open(_build.library_path().rsplit("/", 1)[0] + "/build.log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

    frames = synth_1080p_frames(N_FRAMES)
    kernels, launches = {}, {}
    cfgs = {"range": FFV1Config(level=3, coder=1, slices=30),
            "rice": FFV1Config(level=3, coder=0, slices=30)}
    inputs, encs = {}, {}
    for label, cfg in cfgs.items():
        probe = DeviceFFV1Encoder(W, H, "yuv420p", cfg, device="cuda")
        probe.encode(frames[0], force_keyframe=True)     # settles the caps
        capture = capture_range if label == "range" else capture_rice
        capture(probe, frames[0])                        # warm-up
        inputs[label], stages = capture(probe, frames[0])
        phase = 2 if label == "range" else 4
        log(f"phase {phase}: {label} frame 0 stage times (ms, CUDA events): "
            + json.dumps(stages))
        encs[label] = probe
        if label == "range":
            range_checks(kernels, inputs[label], clock_mhz)
        else:
            place_checks(kernels, inputs["range"]["k1"], inputs[label]["k1"])
            rice_checks(kernels, inputs[label], clock_mhz)
    del inputs, encs

    # 3. and 5. the main paths: 8 frames each through encode()
    for phase, (label, cfg) in zip((3, 5), cfgs.items()):
        p = params_from_config(cfg, "yuv420p", W, H)
        enc = DeviceFFV1Encoder(W, H, "yuv420p", cfg, device="cuda")
        launches[label] = drive(enc, frames, NativeFFV1Codec(p),
                                NativeFFV1Codec(p), card, label, phase)

    for name, k in kernels.items():
        by_path = {label: launches[label][name] for label in launches}
        k["launches"] = by_path["rice" if name in ("vlc", "ladder")
                                else "range"]
        k["launches_by_path"] = by_path
    order = ["place", "adapt", "expand", "rac_render", "vlc", "ladder"]
    print(json.dumps({"kernels": [kernels[n] for n in order]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
