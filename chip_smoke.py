#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the encode() of ffmpeg_ffv2_tpu_torch's
DeviceFFV1Encoder, TPUCoderFFV1Encoder, TPUFFV1Encoder and the FFV2
sessions on synthetic frames, in phases that each print a line, their ms
per frame and their wall seconds:

0. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
1. the build of the CUDA kernels from csrc/ (one nvcc per source, all
   started together), of the native C++ FFV1 codec, the oracle (g++), and
   of tools/latency.cu, whose chains give the SM cycles a link of K4's
   (and K7's) coder step, of K2's table lookup, of K5's row, of the
   ladder's climb and of a level of K18's argmax on this card;
2. phase A (the phase_a kernel) at the benchmark's two 1080p yuv420p
   sessions, range (context 1, 24 slices) and Golomb-Rice (context 0,
   16 slices), on frame 0 against its plain PyTorch version on the card:
   its CUDA-event and device times, the host's microseconds a call and
   the plain version's time; then range, 1920x1080 yuv420p,
   FFV1Config(level=3, coder=1, slices=30): K1-K4
   and emission_pack each against its plain PyTorch version on the card, on
   the inputs frame 0 gives it (K2 and K4 plain versions on a stated cut:
   K4's first 3080 steps, across seven stages of its 512-op ring;
   emission_pack against repack_emission_order on every row of the
   frame's cells), with CUDA-event times of both, K4's ns a step and K2's
   ns a row of the longest chain, plus the time of each stage of frame 0;
3. range: 8 frames (1 key, 7 inter) through encode(): every packet must
   equal the native codec's and decode back to the input exactly, K1-K4
   and emission_pack must have launched and no plain version may have run;
4. Golomb-Rice, the same frames with coder=0: K5 (vlc) against its plain
   version (on a cut) and the ladder kernels (chunk maps, carries,
   replay: one launcher call) against their plain loop (on the frame's
   events), with their device time and their chain beside the serial
   walk's, K1 again on the rice cells, and the stage times;
5. Golomb-Rice: 8 frames through encode(), checked as in phase 3, with K1,
   K5 and the ladder kernel launched and no plain version run;
6. rgb48 1920x1080 (16-bit RGB film scans), FFV1Config(level=3, coder=1,
   slices=30, slicecrc=1), coding depth 17: K2 with its R = 7 repeat
   sub-steps and K6 against their plain versions (on a cut), emission_pack
   against repack_emission_order on every row, then 3 frames through
   encode() on the default route (K1-K4, emission_pack), checked as in
   phase 3;
7. bgr0 1920x1080, FFV1Config(level=4, coder=1, slices=30, slicecrc=1)
   with emission_order=True: the per-slice RCT search on the card (the
   histogram of its picks), K6 against its plain version (on a cut), and
   on every row against emission_pack (the zero fill) of K2's slot words,
   as is the emission_pack kernel with the zero fill, 3 frames checked as
   in phase 3 with K1, K6, K3 and K4 launched and K2 and emission_pack
   not;
8. bgr0 1920x1080, FFV1Config(level=3, coder=0, slices=30): FATE's RGB
   Golomb-Rice configuration: K5 at coding depth 9 against its plain
   version (on a cut) on frame 0's inputs (entry vlc_bgr0), then 3 frames
   with K1, K5 and the ladder kernel;
9. yuv422p10 720x486 (SD tape transfers), FFV1Config(level=3, coder=1,
   slices=24, slicecrc=1): slice rects of 120x121 and 120x122, so the
   session splits into two shape banks; 3 frames checked as in phase 3;
10. the hybrid lane-coder encoder TPUCoderFFV1Encoder, 1080p yuv420p with
   phase 2's config: K7 (rac_lanes) against its plain version on the first
   2048 steps of frame 0's lanes, frame 0's stage times, then 3 frames
   with pass-1 statistics on, checked as in phase 3, K7 launched once a
   frame, and the statistics equal to a native session's;
11. TPUCoderFFV1Encoder with phase 4's Golomb-Rice config: K7 codes the
   slice headers (against its plain version on frame 0's, entry
   rac_lanes_rice), bit_pack_lanes packs the Rice bits on the card, 3
   frames;
12. TPUFFV1Encoder (phase A on the card, the native entropy coder): 3
   frames of 1080p yuv420p coder=1, then 2 of bgr0 coder=0 (fixed RCT);
13. the 2-pass flow: twopass.apply_pass2 on phase 10's statistics, then
   DeviceFFV1Encoder(params=p2) for 2 frames (K1-K4, with the custom
   initial states and transition table), checked against
   NativeFFV1Codec(p2), and its extradata against write_extradata(p2);
14. the sort op and the tools: ops.sort_rows through tools.microbench_sort
   at the sort microbenches' shapes (layout (30, 131072) x 2, class
   (1, 65536) x 4, unsort (1, 2^22) x {7, 10}, the unsort candidates
   (30, 131072) x {6, 9} per slice and padded to (1, 2^22) in one row,
   with their duplicate keys, and sort2's (30, 131072) x {2, 4}): K8 on
   the long single rows, K9 on the rest, every output equal to the plain
   network on every element and to torch.sort + gather where the keys are
   duplicate-free (the keys elsewhere), each case's mode (index: the keys
   and the column ride the network, then a gather; direct: the operands
   ride), words, chunk, merge group and device kernels, and its device
   time alone (torch.profiler, whose count of kernels must equal the
   launcher's) beside its CUDA-event time; then K10-K12
   (tools.microbench_prims) and K13-K17 (tools.probes, with their device
   time alone too) against their plain versions at the JAX tools' shapes,
   each kernel launched;
15. Golomb-Rice at coding depth 16 (the 16-bit rice cell payload):
   1920x1080 yuv420p16, phase 4's config with the params forced to
   Golomb-Rice, phase 4's frames scaled to 16 bits (x << 8 | x): K1, K5 at
   pb = 16 (on a cut) and the ladder kernel against their plain versions
   on frame 0's inputs (entries place_pb16, vlc_pb16, ladder_pb16), then
   2 frames checked as in phase 3, with K1, K5 and the ladder kernel
   launched;
16. the all-intra batch, phase 2's config: a key frame through encode(),
   then encode_batch of phase 3's frames at B = 1, 4 and 8 (up to 240
   slices in one pass), every packet equal to the native codec's key
   packet and decoded losslessly, K1-K4 and emission_pack launched and no
   plain version run, then an inter frame through encode() equal to a
   native session's (the batch left the session alone); K4 against its
   plain version on the first 3080 steps of the B = 8 batch's 240 rows
   (entry rac_render_batch), and through tools.bench_batch_scale the
   batch's ms a frame and K4's ms a launch and a frame at each B, beside
   encode() of the same frames as key frames, and each B's stage times;
17. the device conversions at 1080p (convert/device.py): each of the five
   on the card equal to the port's numpy model (yuv420p -> rgb48 on an
   input whose int32 sums wrap), fused_bgr0_phase_a equal to the staged
   conversion + plane_context_diff, their CUDA-event times beside the
   models' host times; then the capture path: phase 7's bgr0 frames
   through bgr0_to_yuv420p on the card, handed as tensors to
   encode_batch at B = 3, every packet equal to the native codec's on
   the numpy model's planes;
18. FFV2 (ffv2/native.py): K18 (pvq) against its plain version on every
   (row, band) of a 1920x1080 yuv444p frame 0 at FFV2Config(qp=16), with
   its device time and each class of band lengths timed alone (one
   launch a class), K19
   (lap_pre, lap_post) against theirs on the whole frame, with its
   device time alone and its launches a call, the float64
   transforms timed, the encode and decode stage times (CUDA events);
   then, counts reset: 3 frames of 1080p yuv444p qp 16 (moving ramps and
   seeded noise), 1 of gbrp10 (the 16-bit upload), 1 of yuv444p with
   block_size=0 (the split tree: mixed leaf sizes through K19 and the
   transforms), every packet decoded on the card, and the 3 frames again
   through PipelinedFFV2Encoder(depth=2); K18 once a frame, K19 once an
   encode and once a decode (one launch over its tile table a call);
   every packet byte-identical to the port's host path (encode_host) of
   the same frame, every card decode equal to decode_host, the pipelined
   packets equal to the sequential ones;
19. the multi-device encoders (parallel/) as worlds of ranks that share
   the card (parallel.world.spawn_world): a gloo world of 4 ranks on a
   (2, 2) mesh, two lanes (lane 1's frames phase 3's rolled 7 columns):
   1080p yuv420p range, FFV1Config(level=3, coder=1, slices=30,
   gop_size=3), 3 frames (15 slices a rank), rice 2 frames, and 720x486
   yuv422p10 at 24 slices (two shape banks of 12, 6 a rank) 2 frames;
   then a 1-rank NCCL world on the range frames; every packet of every
   lane equal to the single-device port's (timed on one rank) and the
   native codec's and decoded losslessly, each rank's path kernels
   launched and no plain version run; then a gloo world of 2 ranks:
   the SB-banded FFV2 front of a 3840x2160 yuv444p qp-16 frame (34 SB
   rows padded, 17 a rank) equal to encode_front_q, and its packet
   through encode(front_q=) equal to encode() and encode_host(), K18 and
   K19 launched on each rank.  Each world's transport, step ms by rank
   (host clock) beside encode() on one rank, and the gathers' ms.
20. the CLI on the card (python -m ffmpeg_ffv2_tpu_torch.cli, called in
   process): phase 3's first CLI_FRAMES frames written to a raw file,
   encoded at -level 3 -slices 30 -g 2 on the default backend (device),
   first with
   -coder ac (K1-K4, emission_pack) and then with -coder rice (K1, K5,
   the ladder), the launch counts reset before the two and read after
   them (path "cli"); each AVI equal to --backend native's and to
   --backend tpu's byte for byte, decoded with and without -workers 4 to
   the raw input, the device encode round-tripped through .mkv and .nut,
   info reporting version 3, psnr printing PSNR:999.99; the CLI's wall
   ms a frame (host clock: reading the raw file, the encoder's set-up,
   the frames, the muxer).  Then FFV2: CLI_FRAMES frames of 1080p
   yuv444p through -c ffv2 -qp 16 on the default device, at -block_size
   64 with -workers 1 and 4 (PipelinedFFV2Encoder) and at -block_size 0
   (the split tree), and each AVI's CLI decode, the counts reset before
   the five commands and read after them (path "cli ffv2": K18, K19 pre
   and post); every packet equal to NativeFFV2Encoder.encode_host's,
   every decode to decode_host's.  Then --mesh 2x2 on the yuv420p frames,
   -coder ac and rice: a world of 4 ranks sharing the card (gloo, named
   on the CLI's stderr), each AVI equal to the single-device CLI's, every
   rank launching its path's kernels (K1-K4 and emission_pack; K1, K5,
   the ladder) with no plain version, by the counts each rank resets
   before its frames and reads after them (paths "cli mesh ac", "cli
   mesh rice": the ranks' sums).  Each command's wall ms a frame.
21. the graft twin (ffmpeg_ffv2_tpu_torch/graft_entry.py): entry()'s
   step on seeded int32 planes of its example's shape (4, 540, 960) on
   the card, equal as integers to its CPU run, with its ms; then
   dryrun_multichip(4), the JAX dry run's matrix on a gloo world of 4
   ranks sharing the card, every config passing its checks (FFV1 packets
   equal to the host FFV1Encoder's and decoded losslessly, the FFV2
   sharded front equal to encode_front_q), every rank launching its
   configs' kernels with no plain version (path "graft dryrun": the
   ranks' sums over the configs).

The launch counts of a path are reset just before its frames and read just
after (in phase 14, around each case's one call of its op). The line
before the last is a JSON object with one entry per kernel (and K2 again
at rgb48; K6's entry carries its rgb48 numbers too, and emission_pack's
its rgb48 and bgr0 v4 numbers): its times, its bound
on this card (bytes over the memory rate or operations over the peak rate,
whichever is larger, from this run's inputs; and for a serial kernel the
longest dependent chain at one step per SM clock, and for K2, K4-K7
the work's longest chain of dependent links (K4: the longest slice's
steps; K7: the lanes' steps; K2, K6: the lookups a slot's hits need;
K5: the live cells a lane walks) at the cycles a link measured in phase
1; for the ladder and K18 also the device time of their kernels alone,
which a sleep kernel ahead of the timed call keeps free of host work) and
the time of one
PyTorch call computing the same function where there is one; beside the
kernels, ``batch`` (phase 16's rows), ``conversions`` (phase 17's
times), ``ffv2`` (phase 18's stage times, frame times, transforms),
``parallel`` (phase 19's worlds: transports, step, gather and stage ms
by rank, launches by rank), ``cli`` (phase 20's AVI bytes and wall ms
a frame by coder, its ``ffv2`` commands and its ``mesh`` worlds; their
launches ride in each kernel's ``launches_by_path`` under ``cli``, ``cli
ffv2``, ``cli mesh ac`` and ``cli mesh rice``) and ``graft`` (phase 21's
times; ``graft dryrun`` in ``launches_by_path``).
The last line is {"ok": true, "device": {...}}. Any failure raises and
exits non-zero without those lines. Exits non-zero at once
when torch sees no CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

W, H, N_FRAMES = 1920, 1080, 8
N_NEW = 3                   # frames of each of phases 6-9 (1 key, 2 inter)
SD = (720, 486)             # phase 9's frame size
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


def synth_rgb_frames(n, w=W, h=H, seed=1):
    """Channel-correlated 8-bit RGB (g, b, r planes): a gradient g, and
    per slice-sized region one of four relations, so that the v4 RCT
    search picks different pairs per slice: b = 2g + noise and r = g + x +
    noise; a grainy g beside a smooth b and r; b following g; r following
    g (sample values wrap at 256)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    region = (xx * 6 // w + yy * 5 // h) % 4
    frames = []
    for t in range(n):
        ramp = xx * 3 + yy * 2 + 11 * t
        grain = rng.randint(0, 8, (3, h, w))
        g = np.where(region == 0, ramp, ramp + grain[0])
        b = np.select([region == 0, region == 2], [2 * g + grain[1], g + 7],
                      ramp * 2)
        r = np.select([region == 0, region == 3], [g + xx + grain[2] % 3,
                                                   g + 5], ramp * 2 + xx)
        frames.append([(x % 256).astype(np.int32) for x in (g, b, r)])
    return frames


def synth_rgb48_frames(n, w=W, h=H, seed=2):
    """16-bit RGB film-scan stand-in (g, b, r planes): 16-bit gradients
    with 4-bit grain; at 1080 rows, rows 400..463 carry 12-bit noise and
    rows 800..807 full 16-bit noise, so that coded residuals reach
    exponents 10..16 and the walk's repeat sub-steps run."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    b12 = slice(h * 10 // 27, h * 10 // 27 + max(2, h * 64 // 1080))
    b16 = slice(h * 20 // 27, h * 20 // 27 + max(1, h // 135))
    base = xx * 29 + yy * 13
    bases = (base, base * 2 // 3 + 3000, base // 2 + 9000)
    frames = []
    for t in range(n):
        planes = []
        for c in range(3):
            x = bases[c] + 7 * t + rng.randint(0, 16, (h, w))
            x[b12] += rng.randint(0, 4096, (b12.stop - b12.start, w))
            x[b16] = rng.randint(0, 65536, (b16.stop - b16.start, w))
            planes.append((x & 0xFFFF).astype(np.int32))
        frames.append(planes)
    return frames


def synth_sd_frames(n, w, h, seed=3):
    """10-bit 4:2:2 SD: a luma gradient with 2-bit noise, chroma ramps."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cyy, cxx = np.mgrid[0:h, 0:w // 2]
    out = []
    for t in range(n):
        y = (xx * 5 + yy * 3 + 4 * t + rng.randint(0, 4, (h, w))) % 1024
        u = (cxx * 3 + cyy + 2 * t) % 1024
        v = (cxx + cyy * 2 + 512 + t) % 1024
        out.append([a.astype(np.int32) for a in (y, u, v)])
    return out


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


def cuda_ms_once(fn):
    """fn()'s result and its CUDA-event time of one run: a plain version's
    Python loop needs no warm-up, and its comparison run is its timed run."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


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
          clock_mhz: float | None = None, chain_links: int | None = None,
          link_cycles: float | None = None) -> dict:
    """The least time of the work on this card: bytes (each input read
    once, each output written once) over the memory rate, or operations
    over the peak rate, whichever is larger; for a serial kernel also its
    longest dependent chain at one step per SM clock cycle and, where
    ``chain_links`` is given, the work's longest chain of dependent links
    at ``link_cycles``, the cycles a link that ``tools/latency.py``
    measured in this run.  The callers count what this run's data needs
    (valid cells, tiles in use, events, op words, the lookups the hits
    need), never the padded capacities."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / OPS_PER_S * 1e3
    out = dict(bound_ms=max(b_ms, o_ms),
               bound_by="bytes" if b_ms >= o_ms else "operations",
               bound_bytes=int(nbytes), bound_ops=int(ops))
    if chain_steps is not None:
        out["chain_steps"] = int(chain_steps)
        out["chain_bound_ms"] = chain_steps / (clock_mhz * 1e3)
    if chain_links is not None:
        out["chain_links"] = int(chain_links)
        out["link_cycles"] = link_cycles
        out["chain_latency_bound_ms"] = (chain_links * link_cycles
                                         / (clock_mhz * 1e3))
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
    tile_pred; returns (tiles, caps with every other tile emptied)."""
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
    kernel stage (the encoder's ``mark`` hook, see ``utils.metrics``)."""

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
    """Run range frame ``planes`` (a keyframe) through the encoder's own
    one bank's stages (``range_streams``, ``ops_from_streams``; then K4
    as ``Bank.render_fit`` calls it) with a CUDA event after each;
    returns each kernel's inputs and the stage times."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import finish_packet
    from ffmpeg_ffv2_tpu_torch.ffv1.rac import rac_render

    mark = Marks()
    bank, c = enc.banks[0], enc.banks[0].caps
    dev = [torch.as_tensor(pl, dtype=torch.int32, device=enc.device)
           for pl in planes]
    mark("upload")
    ctx, diff, (svp, btp, hlen) = bank.range_streams(dev, True)
    mark("RCT search + phase_a" if bank.v4rgb else "phase_a")
    opw, n_ops, _, _ = bank.ops_from_streams(
        ctx, diff, bank.canonical_key, svp, btp, hlen, True,
        (c.tiles_cap, c.cellrows_cap, c.op_cap), c.unsort_words, mark)
    opmax = int(n_ops.max())
    mark("sizes to host")
    steps = max(512, min(1 << opmax.bit_length(), opw.shape[1]))
    k4 = (opw, steps, c.render_cap)
    by, ln = rac_render(*k4)
    mark("K4 rac_render")
    by_h, ln_h = by.cpu().numpy(), ln.cpu().numpy()
    mark("bytes to host")
    stages = mark.stages()
    t0 = time.perf_counter()
    finish_packet(enc.p, range(bank.S), [by_h[s, :ln_h[s]].tobytes()
                                         for s in range(bank.S)])
    stages["slice trailers + CRC (host clock)"] = round(
        (time.perf_counter() - t0) * 1e3, 4)
    walk = "K6 adapt_emission" if bank.emission_order else "K2 adapt"
    return dict(k1=mark.inputs["K1 place"], walk=mark.inputs[walk],
                pack=mark.inputs.get("emission_pack"),
                k3=mark.inputs["K3 expand"], k4=k4, n_ops=n_ops,
                rendered=int(ln_h.sum())), stages


def capture_rice(enc, planes):
    """Run Golomb-Rice frame ``planes`` (a keyframe) through the encoder's
    one bank's stages (``rice_front``, ``rice_bits``) with a CUDA event
    after each; returns each kernel's inputs and the stage times."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import finish_packet
    mark = Marks()
    bank, c = enc.banks[0], enc.banks[0].caps
    dev = [torch.as_tensor(pl, dtype=torch.int32, device=enc.device)
           for pl in planes]
    mark("upload")
    ctx, streams = bank.phase_a_rice(dev)
    mark("phase_a + run planning")
    codes, _, _ = bank.rice_front(ctx, streams["payload"], bank.vcanon, True,
                                  c.tiles_cap, c.cellrows_cap, mark)
    by, nbits, _ = bank.rice_bits(streams, codes, c.ev_cap, c.nwords, mark)
    nb = nbits.tolist()
    mark("sizes to host")
    by_h = by.cpu().numpy()
    mark("bytes to host")
    stages = mark.stages()
    t0 = time.perf_counter()
    finish_packet(enc.p, range(bank.S), bank.rice_slices(by_h, nb, True))
    stages["slice headers + trailers + CRC (host clock)"] = round(
        (time.perf_counter() - t0) * 1e3, 4)
    return dict(k1=mark.inputs["K1 place"], k5=mark.inputs["K5 vlc"],
                kl=mark.inputs["ladder kernel"]), stages


def entry(out, name, path, err, ms, plain_ms, library_ms, bnd, key=None,
          **extra):
    """One kernel's entry of the ``kernels`` line, under ``key`` (the
    kernel's name unless it is measured twice); ``path`` names the main
    path whose launches it reports."""
    from ffmpeg_ffv2_tpu_torch import _build
    k = _build.KERNELS[name]
    key = key or name
    out[key] = dict(name=key, kernel=name, route="cuda", source=k.source,
                    replaces=k.replaces, path=path, max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, library_ms=library_ms, **bnd, **extra)
    log(f"kernel {key}: equal to plain (tolerance: exact, torch.equal), "
        f"max_abs_err {err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library {library_ms} ms, bound {bnd['bound_ms']:.5f} ms "
        f"({bnd['bound_by']})"
        + (f", chain bound {bnd['chain_bound_ms']:.4f} ms"
           if "chain_bound_ms" in bnd else "")
        + (f", latency bound {bnd['chain_latency_bound_ms']:.4f} ms "
           f"({bnd['chain_links']} dependent links at "
           f"{bnd['link_cycles']:.2f} measured cycles a link)"
           if "chain_latency_bound_ms" in bnd else "")
        + "".join(f", {a} {b}" for a, b in extra.items()))


def used_tiles(caps) -> int:
    return int((caps > 0).sum())


def valid_cells(ch1c, vbit: int = 13) -> int:
    return int(((ch1c >> vbit) & 1).sum())


def live_cells(ch1c, pb: int = 12) -> tuple:
    """Rice cells of payload width ``pb``: (cells with the valid flag, of
    them the ones not silent)."""
    valid = (ch1c >> (pb + 1)) & 1
    return int(valid.sum()), int((valid & (1 - ((ch1c >> pb) & 1))).sum())


def place_checks(out, k1, path, key=None, also=(), **extra):
    """K1 on the plan and cell rows ``k1`` (and on each input of
    ``also``) against its plain version, scatter_cells of the plan's
    dest; library call: one scatter_ of both channels.  Bound: each
    element read (dest and two channels) and both channels written up to
    the last row in use."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ops import place as pl

    def plain(a):
        p, rows = a
        return pl.scatter_cells(p["dest"], p["ch1"], p["orig"], rows)

    plan, cellrows = k1
    dest, ch1, orig = plan["dest"], plan["ch1"], plan["orig"]
    err = max(max_abs_err(pl.place(*a), plain(a)) for a in (k1, *also))
    cells = cellrows * 128
    rows_used = int(torch.where(dest < cells, dest, -1).max()) // 128 + 1
    idx = torch.where((dest >= 0) & (dest < cells), dest, cells).long()
    idx2 = idx.expand(2, -1).contiguous()
    vals2 = torch.stack([ch1, orig])
    out2 = torch.empty((2, cells + 1), dtype=torch.int32, device=dest.device)
    n = dest.shape[0]
    entry(out, "place", path, err, cuda_ms(lambda: pl.place(*k1), 5),
          cuda_ms(lambda: plain(k1), 5),
          cuda_ms(lambda: out2.scatter_(1, idx2, vals2), 5),
          bound(n * 12 + rows_used * 128 * 8, n), key=key,
          shape=f"N={n} cells={cells} ({rows_used} rows in use) ({path})",
          **extra)


def walk_links(ch1c, caps, bases, pred, s0, code_bits: int) -> int:
    """The most table lookups that one slot state of one lane takes one
    after the other in K2's walk: a lookup for each row whose cell hits
    the slot, and for slots 10 and 31 one for each repeat sub-step the
    cell's exponent reaches (``adapt_plain``'s v10, v31); a tile adds to
    its predecessor's count in the lanes whose continuation flag is set,
    and an empty tile ends the chain (its state is zeroed)."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1 import host
    from ffmpeg_ffv2_tpu_torch.ffv1.symbols import exponent, slot_bit_grid
    mask, bias, vbit = host.payload_field(code_bits)
    R = max(0, code_bits - 10)
    caps_h, bases_h, pred_h = caps.tolist(), bases.tolist(), pred.tolist()
    T, dev = len(caps_h), ch1c.device
    tile_of = torch.full((ch1c.shape[0],), T, dtype=torch.long, device=dev)
    for t, (c, b) in enumerate(zip(caps_h, bases_h)):
        if c > 0:
            tile_of[b:b + c] = t
    counts = torch.zeros((T + 1, 128, 32), dtype=torch.int32, device=dev)
    for lo in range(0, ch1c.shape[0], 2048):
        r = ch1c[lo:lo + 2048]
        v = (r & mask) - bias
        ok = ((r >> vbit) & 1) == 1
        hits = (slot_bit_grid(v)[0] & ok[..., None]).to(torch.int32)
        if R:
            e = torch.where(ok, exponent(v.abs()), 0)
            hits[..., 10] += torch.clamp(e - 9, 0, R)
            hits[..., 31] += torch.clamp(e - 10, 0, R)
        counts.index_add_(0, tile_of[lo:lo + 2048], hits)
    total = counts[:T].clone()
    for t, p in enumerate(pred_h):      # predecessors come first
        if caps_h[t] <= 0:
            total[t] = 0
        elif p >= 0:
            cont = (s0[t, 32] > 0)[:, None]
            total[t] += torch.where(cont, total[p], 0)
    return int(total.max()) if T else 0


def walk_check(out, inputs, clock_mhz, cycles, key, path, emission: bool):
    """K2 (or K6) on every tile of a frame's cells, and against its plain
    row scan on a cut of tiles closed under tile_pred (the kernel again on
    the cut, every other tile emptied).  Bound: each valid cell read and
    its output words written, the start and end blocks and the tile words
    of the tiles in use, the table; chain: the longest successor chain's
    rows, and its latency bound the longest chain of lookups the hits
    need (``walk_links``) at the measured cycles of a lookup (``cycles``,
    ``tools/latency.py``).  Returns the count of valid cells with e > 9 in
    the cut."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1 import adapt as ad
    from ffmpeg_ffv2_tpu_torch.ffv1 import host
    from ffmpeg_ffv2_tpu_torch.tools import latency
    k = inputs["walk"]
    ch1c, caps, bases, pred, s0, table, code_bits = k[:7]
    rest = k[7:]                                  # K6: ev_words
    kern = ad.adapt_emission if emission else ad.adapt
    plain = ad.adapt_emission_plain if emission else ad.adapt_plain
    cut, caps_cut = cut_tiles(caps, pred)
    bases_h, caps_h = bases.tolist(), caps.tolist()
    rows = torch.cat([torch.arange(bases_h[t], bases_h[t] + caps_h[t],
                                   device=caps.device) for t in cut])
    kc = (ch1c, caps_cut, bases, pred, s0, table, code_bits, *rest)
    out_k, ends_k = kern(*k)
    out_c, ends_c = kern(*kc)
    (out_p, ends_p), plain_ms = cuda_ms_once(lambda: plain(*k, tiles=cut))
    err = max_abs_err([out_k[rows], ends_k[cut], out_c[rows], ends_c[cut]],
                      [out_p[rows], ends_p[cut], out_p[rows], ends_p[cut]])
    vbit = host.payload_field(code_bits)[2]
    valid = valid_cells(ch1c, vbit)
    big = ((ad.cell_diff(ch1c, code_bits).abs() >= 1 << 10)
           & (((ch1c >> vbit) & 1) == 1))
    big_cut = int(big[rows].sum())
    n_rows = sum(c for c in caps_h if c > 0)
    tiles = used_tiles(caps)
    words = out_k.shape[1]
    ms = cuda_ms(lambda: kern(*k), 5)
    rows_chain = chain_rows(caps_h, pred.tolist())
    name = "adapt_emission" if emission else "adapt"
    links = walk_links(ch1c, caps, bases, pred, s0, code_bits)
    log(f"kernel {key or name}: {ms * 1e6 / rows_chain:.1f} ns a chain row "
        f"({ms:.4f} ms over the longest chain's {rows_chain} rows; the "
        f"longest chain of lookups a slot's hits need: {links})")
    entry(out, name, path, err, ms, plain_ms, None,
          bound(valid * (4 + 4 * words)
                + tiles * ((33 + 32) * 128 * 4 + 12) + 512,
                valid * (32 + 2 * max(0, code_bits - 10)),
                rows_chain, clock_mhz, links, cycles[latency.LOOKUP]),
          key=key, ms_cut=cuda_ms(lambda: kern(*kc), 5),
          ns_a_chain_row=ms * 1e6 / rows_chain,
          cut=f"tiles {cut} ({rows.numel()} of {n_rows} rows); plain_ms "
              "and ms_cut on the cut, ms on every tile",
          code_bits=code_bits, out_words=words,
          split_tiles=sum(1 for t in pred.tolist() if t >= 0),
          valid_cells=valid, cells_e_over_9=int(big.sum()),
          cells_e_over_9_in_cut=big_cut)
    return big_cut


def pack_check(out, kp, path, key=None, fill="sign", **extra):
    """emission_pack on K2's slot words of a whole frame (``kp``: the
    wrapper's arguments) against its plain version on every row of the
    cells: ``repack_emission_order`` (fill "sign", the JAX encoder's XLA
    repack) or ``emission_pack`` (fill "zero").  Bound: each cell of the
    walked rows reads its payload and writes its emission words, each
    valid cell reads its slot words."""
    from ffmpeg_ffv2_tpu_torch.ffv1 import adapt as ad
    from ffmpeg_ffv2_tpu_torch.ffv1 import host
    sv, ch1c, caps, bases, code_bits, n_words = kp
    plain_fn = (ad.repack_emission_order if fill == "sign" else
                ad.emission_pack)

    def plain():
        return plain_fn(sv, ad.cell_diff(ch1c, code_bits), code_bits,
                        n_words)

    err = max_abs_err([ad.pack_emission(*kp, fill)], [plain()])
    n = ad.walked_rows(caps, bases)
    valid = valid_cells(ch1c[:n], host.payload_field(code_bits)[2])
    nsv = sv.shape[1]
    entry(out, "emission_pack", path, err,
          cuda_ms(lambda: ad.pack_emission(*kp, fill), 5),
          cuda_ms(plain, 3), None,
          bound(n * 128 * 4 * (1 + n_words) + valid * 4 * nsv,
                n * 128 * 4 * n_words), key=key,
          shape=f"cellrows={ch1c.shape[0]} ({n} walked) sv_words={nsv} "
                f"n_words={n_words} code_bits={code_bits} fill={fill}",
          valid_cells=valid,
          compared="every row of the cells against the plain version",
          **extra)


def k6_pack_check(out, k):
    """K6 on the inputs ``k`` of a whole frame against K2's walk followed
    by the plain ``emission_pack`` on every row of the cells (the packing
    inside K6, held whole; its walk is K2's), and the emission_pack kernel
    with the zero fill on the same slot words (entry
    ``emission_pack_bgr0_v4``)."""
    from ffmpeg_ffv2_tpu_torch.ffv1 import adapt as ad
    walk, ev_words = k[:7], k[7]
    ch1c, caps, bases, code_bits = walk[0], walk[1], walk[2], walk[6]
    sv, _ = ad.adapt(*walk)
    ref = ad.emission_pack(sv, ad.cell_diff(ch1c, code_bits), code_bits,
                           ev_words)
    err = max_abs_err([ad.adapt_emission(*k)[0]], [ref])
    log(f"kernel adapt_emission: equal on every row to K2's walk and the "
        f"plain emission_pack (max_abs_err {err})")
    out["adapt_emission"]["whole_frame_pack_err"] = err
    pack_check(out, (sv, ch1c, caps, bases, code_bits, ev_words), "bgr0 v4",
               key="emission_pack_bgr0_v4", fill="zero")


def phase_a_checks(out, frames):
    """Phase 2's first part: the phase_a kernel at the benchmark's 1080p
    sessions (range: context 1, 24 slices, entry ``phase_a``; rice:
    context 0, 16 slices, ``phase_a_rice``) on frame 0 against its plain
    version (``pa_plan.plain``: the torch chain it replaced) on every
    sample; its CUDA-event time (the host's enqueue included), its device
    time alone (``kernel_times.device_ms``) and the host's microseconds a
    call (200 calls, no synchronisation between them).  Bound: each
    sample read once, each context and residual written once (int32)."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
    from ffmpeg_ffv2_tpu_torch.tools.kernel_times import device_ms

    for key, cfg in (("phase_a", FFV1Config(level=3, coder=1, context=1,
                                            slices=24, slicecrc=1)),
                     ("phase_a_rice", FFV1Config(level=3, coder=0, context=0,
                                                 slices=16, slicecrc=1))):
        enc = DeviceFFV1Encoder(W, H, "yuv420p", cfg, device="cuda")
        dev = enc.upload(frames[0])
        bank = enc.banks[0]
        plan = bank.pa_plan

        def call():
            return bank.phase_a(dev)

        err = max_abs_err(call(), plan.plain(dev))
        ms, dev_ms = cuda_ms(call, 20), device_ms(call, 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        samples = sum(pl.numel() for pl in dev)
        outs = 2 * bank.S * bank.npix
        entry(out, "phase_a", "range" if key == "phase_a" else "rice", err,
              ms, cuda_ms(lambda: plan.plain(dev), 3), None,
              bound(4 * (samples + outs), 0), key=key,
              shape=f"S={bank.S} npix={bank.npix} jobs={len(plan.jobs)} "
                    f"blocks={plan.n_blocks} five={plan.five}",
              device_ms=dev_ms, host_us_a_call=round(host_us, 2),
              compared="every sample against the plain version")


def range_checks(out, inputs, clock_mhz, cycles):
    """K2-K4 against their plain versions on range frame 0's inputs;
    ``cycles``: the chains' measured cycles a link (``tools/latency.py``)."""
    from ffmpeg_ffv2_tpu_torch.ffv1 import expand as ex

    walk_check(out, inputs, clock_mhz, cycles, "adapt", "range", False)
    pack_check(out, inputs["pack"], "range")

    # K3 expand: full main-path shapes; bound: the inputs read, the op
    # words the slices hold written (not the op_cap capacity, whose NOP
    # fill the kernel writes too)
    k3 = inputs["k3"]
    words, diff, svp, btp, hlen, op_cap = k3
    err = max_abs_err(ex.expand(*k3), ex.expand_plain(*k3))
    n_ops = int(inputs["n_ops"].sum())
    S = diff.shape[0]
    entry(out, "expand", "range", err, cuda_ms(lambda: ex.expand(*k3), 5),
          cuda_ms(lambda: ex.expand_plain(*k3), 3), None,
          bound(4 * (words.numel() + diff.numel() + svp.numel()
                     + btp.numel() + hlen.numel() + n_ops + S), n_ops),
          shape=f"S={S} npix={diff.shape[1]} W={words.shape[0]} "
                f"op_cap={op_cap}",
          writes=f"{S * op_cap} op words (the bound counts the {n_ops} "
                 "of the slices' ops; the rest is the NOP fill to op_cap)")

    render_check(out, inputs["k4"], inputs["n_ops"], inputs["rendered"],
                 clock_mhz, cycles, "range")


def render_check(out, k4, n_ops, rendered, clock_mhz, cycles, path,
                 key=None, **extra):
    """K4 rac_render: the kernel on the op streams ``k4`` (opw, steps,
    buf_cap) whose slices hold ``n_ops`` ops and render ``rendered``
    bytes; kernel and plain on the first 3080 op steps of every slice
    (six stages of the kernel's 512-op ring and 8 steps of a seventh)
    ending in the tail ops."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1 import rac
    from ffmpeg_ffv2_tpu_torch.tools import latency
    opw, steps, buf_cap = k4
    n = 3 * 1024 + 8
    opw_cut = opw[:, :n].clone()
    opw_cut[:, -3:] = torch.tensor([(1 << 9) | 129, 2 << 9, 3 << 9],
                                   dtype=torch.int32, device=opw.device)
    err = max_abs_err(rac.rac_render(opw_cut, n, 8192),
                      rac.rac_render_plain(opw_cut, n, 8192))
    S = opw.shape[0]
    ms = cuda_ms(lambda: rac.rac_render(*k4), 5)
    live = int(n_ops.max())
    total = int(n_ops.sum())
    log(f"kernel {key or 'rac_render'}: {ms * 1e6 / live:.2f} ns a step "
        f"({ms:.4f} ms over the longest slice's {live} live steps of "
        f"{steps}, {S} slices)")
    entry(out, "rac_render", path, err, ms,
          cuda_ms(lambda: rac.rac_render_plain(opw_cut, n, 8192), 1), None,
          bound(total * 4 + rendered + S * 4, total, live,
                clock_mhz, live, cycles[latency.K4_STEP]), key=key,
          ms_cut=cuda_ms(lambda: rac.rac_render(opw_cut, n, 8192), 5),
          ns_a_step=ms * 1e6 / live,
          cut=f"first {n} op steps of each of {S} slices; plain_ms and "
              f"ms_cut on the cut, ms on {steps} steps", **extra)


def vlc_links(ch1c, caps, bases, pred, s0, pb: int) -> int:
    """The most live cells that one lane of K5's walk takes one after the
    other: a lane's live cells in a tile, added to its predecessor's in
    the lanes whose continuation flag is set; an empty tile ends the chain
    (its state is zeroed)."""
    import torch
    caps_h, bases_h, pred_h = caps.tolist(), bases.tolist(), pred.tolist()
    live = (((ch1c >> (pb + 1)) & 1) & (1 - ((ch1c >> pb) & 1)))
    total = torch.zeros((len(caps_h), 128), dtype=torch.int64,
                        device=ch1c.device)
    for t, (c, b, p) in enumerate(zip(caps_h, bases_h, pred_h)):
        if c <= 0:
            continue
        total[t] = live[b:b + c].sum(0)
        if p >= 0:
            total[t] += torch.where(s0[t, 4] > 0, total[p], 0)
    return int(total.max()) if caps_h else 0


def rice_checks(out, inputs, clock_mhz, cycles, bits=8, suffix="",
                path="rice", ladder=True):
    """K5 (coding depth ``bits``) and (with ``ladder``) the ladder kernel
    against their plain versions on rice frame 0's inputs; their entries
    are ``vlc`` and ``ladder`` with ``suffix``.  K5's latency bound: the
    most live cells a lane walks one after the other (``vlc_links``) at
    the measured cycles of K5's row (``cycles``, ``tools/latency.py``)."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1 import rice
    from ffmpeg_ffv2_tpu_torch.ffv1 import vlc
    from ffmpeg_ffv2_tpu_torch.tools import latency
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.tools.kernel_times import device_ms
    pb = rice.rice_pb(bits)

    k5 = inputs["k5"]
    ch1c, caps, bases, pred, s0 = k5
    cut, caps_cut = cut_tiles(caps, pred)
    bases_h, caps_h = bases.tolist(), caps.tolist()
    rows = torch.cat([torch.arange(bases_h[t], bases_h[t] + caps_h[t],
                                   device=caps.device) for t in cut])
    code_k, ends_k = vlc.vlc_adapt(*k5, bits)
    code_c, ends_c = vlc.vlc_adapt(ch1c, caps_cut, bases, pred, s0, bits)
    (code_p, ends_p), plain_ms = cuda_ms_once(
        lambda: vlc.vlc_adapt_plain(*k5, bits, tiles=cut))
    err = max_abs_err(
        [code_k[rows], ends_k[cut], code_c[rows], ends_c[cut]],
        [code_p[rows], ends_p[cut], code_p[rows], ends_p[cut]])
    # bound: each valid cell read and its code written, the start and end
    # blocks and the tile words of the tiles in use
    n_rows = sum(c for c in caps_h if c > 0)
    tiles = used_tiles(caps)
    valid, live = live_cells(ch1c, pb)
    ms = cuda_ms(lambda: vlc.vlc_adapt(*k5, bits), 5)
    rows_chain = chain_rows(caps_h, pred.tolist())
    links = vlc_links(ch1c, caps, bases, pred, s0, pb)
    log(f"kernel vlc{suffix}: {ms * 1e6 / rows_chain:.1f} ns a chain row "
        f"({ms:.4f} ms over the longest chain's {rows_chain} rows; the most "
        f"live cells a lane walks: {links})")
    entry(out, "vlc", path, err, ms, plain_ms, None,
          bound(valid * 8 + tiles * ((5 + 4) * 128 * 4 + 12), live * 40,
                rows_chain, clock_mhz, links, cycles[latency.K5_ROW]),
          key="vlc" + suffix,
          ms_cut=cuda_ms(lambda: vlc.vlc_adapt(ch1c, caps_cut, bases, pred,
                                               s0, bits), 5),
          ns_a_chain_row=ms * 1e6 / rows_chain,
          cut=f"tiles {cut} ({rows.numel()} of {n_rows} rows); plain_ms "
              "and ms_cut on the cut, ms on every tile",
          split_tiles=sum(1 for t in pred.tolist() if t >= 0),
          valid_cells=valid, live_cells=live, payload_bits=pb)
    if not ladder:
        return

    # the ladder: kernel and plain loop on frame 0's events, each lane
    # walked as far as its event count; bound: per event its count and
    # three flags read and its index written, plus the counts; chains: a
    # lane's events one after the other (the serial walk), and the chunked
    # kernels' (a chunk's climbs in its map, the lookups of the carries,
    # a chunk's climbs in the replay) at the measured cycles of a climb
    # and of a lookup
    kl = inputs["kl"]
    n_ev = kl[4]
    L, E = kl[0].shape
    live_ev = torch.arange(E, device=n_ev.device)[None, :] < n_ev[:, None]
    got = rice.run_index_scan(*kl)
    ref, plain_ms = cuda_ms_once(lambda: rice.run_index_scan_plain(*kl))
    err = max_abs_err([got[live_ev]], [ref[live_ev]])
    events, longest = int(n_ev.sum()), int(n_ev.max())
    C = _build.load().ffv2_ladder_chunk()
    carries = max(-(-longest // C) - 1, 0)
    walk = min(C, longest)
    climb, lookup = cycles[latency.LADDER_CLIMB], cycles[latency.LOOKUP]
    entry(out, "ladder", path, err,
          cuda_ms(lambda: rice.run_index_scan(*kl), 5), plain_ms, None,
          bound(events * (4 + 3 + 4) + L * 4, events * 10, longest,
                clock_mhz), key="ladder" + suffix,
          device_ms=device_ms(lambda: rice.run_index_scan(*kl), 5),
          device_launches_a_call=_build.device_launches(
              lambda: rice.run_index_scan(*kl)),
          shape=f"{L} slices, ev_cap {E} slots",
          events=events, max_events=longest, chunk=C,
          climb_cycles=climb, lookup_cycles=lookup,
          serial_chain_latency_ms=longest * climb / (clock_mhz * 1e3),
          chunked_chain=dict(maps=walk, carries=carries, replay=walk),
          chunked_chain_latency_ms=((2 * walk * climb + carries * lookup)
                                    / (clock_mhz * 1e3)))


def lanes_checks(out, enc, frame, clock_mhz, cycles):
    """K7 on the lane matrices of ``frame`` planned as a keyframe by
    ``enc`` (a TPUCoderFFV1Encoder session of its own), timed after a
    warm-up; kernel and plain version on the first 2048 steps of every
    lane ending in the two flush steps.  Bound: each used step of each
    lane reads 3 int32 and writes 3 int32; chain: the lanes' steps, and
    its latency bound those steps at the measured cycles of K4's coder
    step (``cycles``, ``tools/latency.py``), which K7's coder runs.  Also
    times frame 0's host and device stages."""
    import torch
    from ffmpeg_ffv2_tpu_torch.ffv1 import rac
    from ffmpeg_ffv2_tpu_torch.ffv1 import tpu_coder as tc
    from ffmpeg_ffv2_tpu_torch.tools import latency
    stages = {}
    t0 = time.perf_counter()
    svs, bits, lens, _ = enc._plan(frame, True)
    stages["plan (native planner, host)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k7 = enc.lane_matrices(svs, bits, lens)
    torch.cuda.synchronize()
    stages["ops up + lane matrices"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = torch.stack(rac.rac_lanes(*k7)).cpu().numpy()
    stages["K7 + staged events down"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tc.compact_lanes(*staged)
    stages["compaction (host)"] = time.perf_counter() - t0
    log("phase 10: hybrid range frame 0 stage times (ms, host clock): "
        + json.dumps({k: round(v * 1e3, 4) for k, v in stages.items()}))
    steps, lanes = k7[0].shape
    n = min(2048, steps)
    cut = [a[:n].clone() for a in k7]
    cut[2][n - 2] = tc.MODE_FLUSH1
    cut[2][n - 1] = tc.MODE_FLUSH2
    got = rac.rac_lanes(*cut)
    ref, plain_ms = cuda_ms_once(lambda: rac.rac_scan_lanes(*cut))
    err = max_abs_err(got, ref)
    ms = cuda_ms(lambda: rac.rac_lanes(*k7), 5)
    log(f"kernel rac_lanes: {ms * 1e6 / steps:.2f} ns a step ({ms:.4f} ms "
        f"over {steps} steps of {lanes} lanes)")
    entry(out, "rac_lanes", "hybrid range", err, ms, plain_ms, None,
          bound(steps * lanes * 6 * 4, steps * lanes, steps, clock_mhz,
                steps, cycles[latency.K4_STEP]),
          ms_cut=cuda_ms(lambda: rac.rac_lanes(*cut), 5),
          ns_a_step=ms * 1e6 / steps,
          cut=f"first {n} steps of each of {lanes} lanes; plain_ms and "
              f"ms_cut on the cut, ms on {steps} steps",
          ops_per_lane_max=max(lens), ops_per_lane_min=min(lens))


def rice_lanes_checks(out, enc, frame, clock_mhz, cycles):
    """K7 on the slice headers of rice ``frame`` as a keyframe of ``enc``
    (a TPUCoderFFV1Encoder session of its own, whose ``lane_matrices`` it
    records while the frame encodes), against its plain version in full;
    bound and latency bound as ``lanes_checks``."""
    from ffmpeg_ffv2_tpu_torch.ffv1 import rac
    from ffmpeg_ffv2_tpu_torch.tools import latency
    seen = []
    lane_matrices = enc.lane_matrices
    enc.lane_matrices = lambda *a: seen.append(lane_matrices(*a)) or seen[-1]
    enc.encode(frame, force_keyframe=True)
    if len(seen) != 1:
        raise AssertionError(f"hybrid rice: {len(seen)} lane codings in a "
                             "frame, not one")
    k7 = seen[0]
    steps, lanes = k7[0].shape
    got = rac.rac_lanes(*k7)
    ref, plain_ms = cuda_ms_once(lambda: rac.rac_scan_lanes(*k7))
    err = max_abs_err(got, ref)
    ms = cuda_ms(lambda: rac.rac_lanes(*k7), 5)
    entry(out, "rac_lanes", "hybrid rice", err, ms, plain_ms, None,
          bound(steps * lanes * 6 * 4, steps * lanes, steps, clock_mhz,
                steps, cycles[latency.K4_STEP]),
          key="rac_lanes_rice", ns_a_step=ms * 1e6 / steps,
          shape=f"{steps} steps x {lanes} lanes (the slice headers); "
                "kernel and plain on every step")


def sort_tools_checks(out, card) -> dict:
    """Phase 14: the port's row sort through ``tools.microbench_sort`` at
    the sort microbenches' shapes (K8 on one long row, K9 on batched or
    short rows), then K10-K12 (``tools.microbench_prims``) and K13-K17
    (``tools.probes``) at the JAX tools' shapes.  Each case calls its op
    once with its launches counted (the path), then holds the result
    against the plain version on every element (and the sort against
    torch.sort + gather: whole where the keys are duplicate-free, else the
    keys), then times kernel, plain and library; then holds K13, K16 and
    K17 against their plain versions at the row counts (and K17's idx
    patterns) of ``probes.edge_inputs`` (launches not counted).  Returns
    the path's launch counts."""
    import torch
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.tools import microbench_prims, microbench_sort
    from ffmpeg_ffv2_tpu_torch.tools import probes
    path = "sort op / tools"
    counts = {k: 0 for k in _build.KERNELS}
    _build.reset_counts()
    results = {}
    for r in microbench_sort.run():
        log(f"phase 14: {microbench_sort.line(r)} [{card}]")
        if not (r["exact_plain"] and r["exact_library"]):
            raise AssertionError(f"sort {r['name']}: kernel differs from "
                                 f"its plain version or the library")
        results.setdefault(r["kernel"], []).append(r)
    for r in microbench_prims.run():
        log(f"phase 14: {microbench_prims.line(r)} [{card}]")
        if not r["exact_plain"]:
            raise AssertionError(f"{r['name']}: kernel differs from plain")
        results.setdefault(r["kernel"], []).append(r)
    for r in probes.run():
        prof = ("not measured" if r["profiled_ms"] is None
                else f"{r['profiled_ms']:.4f} ms")
        log(f"phase 14: probe {r['name']}: {r['result']} (expected "
            f"{r['expected']}), kernel {r['ms']:.4f} ms (device alone "
            f"{prof}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"equal to plain {r['exact_plain']} [{card}]")
        if not r["exact_plain"] or r["result"] != r["expected"]:
            raise AssertionError(f"probe {r['name']}: {r['result']}")
        del r["output"]
        results.setdefault(r["kernel"], []).append(r)
    # K13 and K16 beside the tool's 8 rows, on hostile words, and K17 at
    # 1, 9, 10 and 4096 rows with five idx patterns (not counted as the
    # path's launches)
    edges = {}
    for label, K, fn, plain, args in probes.edge_inputs("cuda"):
        same = torch.equal(fn(*args), plain(*args))
        log(f"phase 14: {K.name} {label}: equal to plain {same} [{card}]")
        if not same:
            raise AssertionError(f"{K.name} {label}: kernel differs from "
                                 "plain")
        edges.setdefault(K.name, []).append(label)
    # the entry's shape: K8 at unsort x10, K9 at layout, the largest tool
    # case; every shape rides in the entry
    main_case = {"sort": "unsort (1,4194304)x10",
                 "rowsort": "layout (30,131072)x2",
                 "roll": "roll lanes (2048,128) x64",
                 "rowcx": "row cmpex (2048,128) x64",
                 "transpose": "transpose (512,128) x32 (64 transposes)",
                 "probe_big_prefetch": "prefetch 128K"}
    for name in ("sort", "rowsort", "roll", "rowcx", "transpose",
                 "probe_scalar_extract", "probe_scalar_in_ds",
                 "probe_big_prefetch", "probe_roll_dynamic",
                 "probe_taa_rows"):
        rs = results.get(name, [])
        counts[name] = sum(r["launches"] for r in rs)
        if not counts[name]:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{path} path")
        r = next((x for x in rs if x["name"] == main_case.get(name)), rs[0])
        # bytes: each operand read and written once; operations: the
        # compare-exchanges, or an add / min-max per element and pass
        bnd = bound(r["bound_bytes"], r["bound_ops"])
        extra = {k: r[k] for k in (
            "compare_exchanges", "network_substages", "ms_per_pass",
            "library_ms_per_pass", "mode", "W", "Lc", "R", "kernels",
            "profiled_ms", "profiled_kernels", "device_ms") if k in r}
        if name in edges:
            extra["equal_to_plain_at"] = edges[name]
        entry(out, name, path, max(x["max_abs_err"] for x in rs), r["ms"],
              r["plain_ms"], r["library_ms"], bnd, shape=r["name"], **extra)
        out[name]["shapes"] = [
            {k: x[k] for k in ("name", "launches", "ms", "profiled_ms",
                               "device_ms", "plain_ms", "library_ms",
                               "bound_ms",
                               "max_abs_err", "mode", "W", "Lc", "R",
                               "kernels", "profiled_kernels") if k in x}
            for x in rs]
    if set(counts) != set(_build.KERNELS):
        raise AssertionError("launch counts do not cover every kernel")
    return counts


def deep_rice_checks(out, frames, cfg, clock_mhz, cycles, card) -> dict:
    """Phase 15: ``frames`` (8-bit yuv420p) scaled to 16 bits (x << 8 |
    x) on Golomb-Rice at ``cfg`` with the params forced to it (the
    config takes the range coder past 8 bits): K1, K5 at pb = 16 (on a
    cut) and the ladder kernel against their plain versions on frame 0's
    inputs, then the frames through encode().  Returns the path's launch
    counts."""
    import dataclasses
    from ffmpeg_ffv2_tpu_torch.ffv1.params import (CODER_GOLOMB,
                                                   params_from_config)
    h, w = frames[0][0].shape
    deep = [[x << 8 | x for x in fr] for fr in frames]
    p16 = dataclasses.replace(params_from_config(cfg, "yuv420p16", w, h),
                              ac=CODER_GOLOMB)
    enc, inputs = probe("phase 15: rice 16-bit", "yuv420p16", w, h, cfg,
                        deep[0], params=p16)
    if enc.banks[0].rice_pb != 16:
        raise AssertionError(f"yuv420p16 rice: payload "
                             f"{enc.banks[0].rice_pb}")
    place_checks(out, inputs["k1"], "rice16", key="place_pb16")
    rice_checks(out, inputs, clock_mhz, cycles, bits=16, suffix="_pb16",
                path="rice16")
    del enc, inputs
    return drive("rice16", device_encoder("yuv420p16", w, h, cfg,
                                          params=p16), deep, card, 15)


def probe(label, pix, w, h, cfg, frame, emission=False, params=None):
    """An encoder whose caps the frame settles, and the captured kernel
    inputs and stage times of that frame, run twice (the first warms)."""
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
    enc = DeviceFFV1Encoder(w, h, pix, cfg, device="cuda",
                            emission_order=emission, params=params)
    enc.encode(frame, force_keyframe=True)
    capture = capture_rice if enc.banks[0].golomb else capture_range
    capture(enc, frame)
    inputs, stages = capture(enc, frame)
    log(f"{label} frame 0 stage times (ms, CUDA events): "
        + json.dumps(stages))
    return enc, inputs


def device_encoder(pix, w, h, cfg, emission=False, params=None):
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
    return DeviceFFV1Encoder(w, h, pix, cfg, device="cuda",
                             emission_order=emission, params=params)


def drive(label, enc, frames, card, phase, not_launched=(), check=None,
          nat=None):
    """The main path of one configuration: frames through ``enc.encode()``
    with the launch counts reset just before; every packet against the
    native codec (``nat``, or a new session of the encoder's params) and
    the lossless decode of a second session.  ``check(enc)`` runs on the
    session before the frames.  Returns the launch counts."""
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
    p = enc.p
    w, h, pix = p.width, p.height, p.pix_fmt.name
    nat, dec = nat or NativeFFV1Codec(p), NativeFFV1Codec(p)
    if check is not None:
        check(enc)
    kernels = enc.kernels
    _build.reset_counts()
    packets, ms = [], []
    for t, frame in enumerate(frames):
        t0 = time.perf_counter()
        packets.append(enc.encode(frame, force_keyframe=t == 0))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches, plain = path_counts(label, kernels, not_launched)
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
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    log(f"phase {phase}: {label}: {type(enc).__name__}, {len(frames)} "
        f"frames {w}x{h} {pix} (1 key + {len(frames) - 1} inter, "
        f"{p.slice_count} slices, level {p.version}, coder {enc.cfg.coder})"
        f" byte-identical to the native codec and decoded losslessly; "
        f"launches {launches}, plain calls {plain}")
    log(f"phase {phase}: {label}: ms per frame "
        f"{[round(x, 2) for x in ms]}; inter-frame median {steady:.2f} ms "
        f"= {w * h / steady / 1e3:.2f} Mpixel/s [{card}]; packet bytes "
        f"{[len(x) for x in packets]}")
    return launches


def path_counts(label, kernels, not_launched=()) -> tuple:
    """The launch and plain-call counts since the last reset, read just
    after a path ran: each of ``kernels`` launched, none of
    ``not_launched``, and no plain version."""
    from ffmpeg_ffv2_tpu_torch import _build
    launches = {k.name: k.launches for k in _build.KERNELS.values()}
    plain = {k.name: k.plain_calls for k in _build.KERNELS.values()}
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{label} path")
    for name in not_launched:
        if launches[name]:
            raise AssertionError(f"kernel {name} launched on the {label} "
                                 "path")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the {label} path: "
                             f"{plain}")
    return launches, plain


BATCH_SIZES = (1, 4, 8)


def batch_checks(out, frames, cfg, clock_mhz, cycles, card) -> tuple:
    """Phase 16: a session encodes frame 0 as a key frame; then, with the
    launch counts reset, ``tools.bench_batch_scale.gate`` runs
    encode_batch of ``frames[:B]`` at each B of BATCH_SIZES (every packet
    against the native codec's key packet and its lossless decode); the
    counts are read; the session's next inter frame must equal a native
    session's.  Then K4 against its plain version on the B = 8 batch's
    rows (entry ``rac_render_batch``), the tool's times and each B's
    stage times.  Returns the path's launch counts and the rows."""
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu_torch.ffv1.rac import rac_render
    from ffmpeg_ffv2_tpu_torch.tools import bench_batch_scale as bbs
    enc = device_encoder("yuv420p", W, H, cfg)
    sess = NativeFFV1Codec(enc.p)
    if enc.encode(frames[0], force_keyframe=True) != sess.encode(frames[0],
                                                                 True):
        raise AssertionError("batch session: key frame differs")
    state = enc.state()
    _build.reset_counts()
    t0 = time.perf_counter()
    bbs.gate(enc, frames, BATCH_SIZES)
    wall = time.perf_counter() - t0
    launches, plain = path_counts("batch", enc.kernels)
    caps = {B: [c.tiles_cap, c.cellrows_cap]
            for B, c in enc.banks[0].batch_caps.items()}
    log(f"phase 16: encode_batch at B = {list(BATCH_SIZES)} ({W}x{H} "
        f"yuv420p, up to {max(BATCH_SIZES) * enc.banks[0].S} slices a "
        f"pass) "
        f"byte-identical to the native codec's key packets and decoded "
        f"losslessly ({wall:.1f} s with the first calls' cap retries); "
        f"launches {launches}, plain calls {plain}; batch caps "
        f"{json.dumps(caps)}")
    if not np.array_equal(enc.state(), state) or enc.picture_number != 1:
        raise AssertionError("encode_batch changed the session's state")
    if enc.encode(frames[1], force_keyframe=False) != sess.encode(frames[1],
                                                                  False):
        raise AssertionError("batch session: the inter frame after the "
                             "batches differs from the native session's")
    log("phase 16: the session's inter frame after the batches equals the "
        "native session's")
    staged = [enc.upload(f) for f in frames]
    rows, k4s = [], {}
    for B in BATCH_SIZES:
        row, k4s[B] = bbs.time_batch(enc, staged, B, 3)
        rows.append(row)
    rows.append(bbs.time_encode(enc, staged, 3))
    for B in BATCH_SIZES:
        mark = Marks()
        enc.encode_batch(staged[:B], mark)
        log(f"phase 16: B = {B} stage times (ms, CUDA events; frames "
            f"staged on the card): {json.dumps(mark.stages())}")
    k4, n_ops = k4s[max(BATCH_SIZES)]
    _, ln = rac_render(*k4)
    b1 = out["rac_render"]["ms"]
    render_check(out, k4, n_ops, int(ln.sum()), clock_mhz, cycles, "batch",
                 key="rac_render_batch", B=max(BATCH_SIZES),
                 per_B=[{k: r[k] for k in ("B", "slices", "k4_ms",
                                           "k4_ms_per_frame", "k4_steps",
                                           "k4_live_steps")}
                        for r in rows[:-1]],
                 encode_path_ms=b1)
    for r in rows[:-1]:
        log(f"phase 16: B = {r['B']} ({r['slices']} slices): batch "
            f"{r['ms_per_frame']:.2f} ms a frame ({r['mpixel_s']:.1f} "
            f"Mpixel/s); K4 {r['k4_ms']:.3f} ms a launch, "
            f"{r['k4_ms_per_frame']:.3f} ms a frame, {r['k4_live_steps']} "
            f"live steps of {r['k4_steps']} (phase 2's K4 on frame 0 "
            f"through encode(): {b1:.3f} ms) [{card}]")
    e = rows[-1]
    log(f"phase 16: encode() of the same {e['frames']} frames as key "
        f"frames: {e['ms_per_frame']:.2f} ms a frame (median; each "
        f"{[round(x, 2) for x in e['ms_per_frame_each']]}) [{card}]")
    return launches, rows


def conversion_checks(frames, cfg, card, device="cuda") -> tuple:
    """Phase 17: the five device conversions and fused_bgr0_phase_a at
    1080p against the numpy models (exact), timed (CUDA events on inputs
    already on the card; the models on the host clock); then the capture
    path, bgr0 frames converted on the card and handed as tensors to
    encode_batch at B = 3, checked against the native codec on the
    model's planes with the launch counts reset just before.  Returns the
    path's launch counts and the times.  ``device`` is the card's, or
    "cpu" in a rehearsal of the phase with the plain versions."""
    import torch
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.convert import device as conv
    from ffmpeg_ffv2_tpu_torch.convert import yuv_rgb
    from ffmpeg_ffv2_tpu_torch.ffv1 import phase_a as pa
    from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu_torch.ffv1.params import params_from_config
    # frame 0 with a bright, saturated band on top (luma 232..255, u and
    # v 255), where the rgb48 writer's int32 sums wrap
    yuv = [x.astype(np.uint8) for x in frames[0]]
    yuv[0][:16] = 255 - np.arange(yuv[0].shape[1]) % 24
    yuv[1][:8] = yuv[2][:8] = 255
    g, b, r = synth_rgb48_frames(1, W, H)[0]
    rgb = [np.stack([b8, g8, r8, np.zeros_like(g8)], -1).astype(np.uint8)
           for g8, b8, r8 in synth_rgb_frames(N_NEW, W, H)]
    img48 = np.stack([r, g, b], -1).astype(np.uint16)
    g16, b16, r16 = (x.astype(np.uint16) for x in (g, b, r))
    # the yuv420p -> rgb48 sums that pass 2^31 - 1 before the int32 wrap
    y64 = yuv[0].astype(np.int64)
    u64 = np.repeat(np.repeat(yuv[1].astype(np.int64), 2, 0), 2, 1)
    Y1 = ((y64 << 9) - yuv_rgb._YO) * yuv_rgb._YC + (1 << 13)
    wraps = int(((((u64 - 128) << 9) * yuv_rgb._U2B + Y1)
                 > 2 ** 31 - 1).sum())
    dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    qt = pa.lut_for(params_from_config(cfg, "yuv420p", W, H), 0)
    cases = [("yuv420p_to_bgr0", yuv, [dev(x) for x in yuv]),
             ("yuv420p_to_rgb48", yuv, [dev(x) for x in yuv]),
             ("bgr0_to_yuv420p", [rgb[0]], [dev(rgb[0])]),
             ("rgb48_to_yuv420p", [img48], [dev(img48.astype(np.int32))]),
             ("gbrp16_to_yuv420p", [g16, b16, r16],
              [dev(x.astype(np.int32)) for x in (g16, b16, r16)])]
    times = {}
    for name, host_args, dev_args in cases:
        fn = getattr(conv, name)
        got = fn(*dev_args, device=device)
        t0 = time.perf_counter()
        ref = getattr(yuv_rgb, name)(*host_args)
        model_ms = (time.perf_counter() - t0) * 1e3
        for a, o in zip([got] if torch.is_tensor(got) else got,
                        [ref] if isinstance(ref, np.ndarray) else ref):
            if not np.array_equal(a.cpu().numpy(), o):
                raise AssertionError(f"{name}: differs from the numpy "
                                     "model")
        times[name] = dict(ms=cuda_ms(lambda: fn(*dev_args, device=device),
                                      5),
                           model_host_ms=model_ms)
    times["yuv420p_to_rgb48"]["wrapped_sums"] = wraps
    if not wraps:
        raise AssertionError("yuv420p_to_rgb48: no sum wrapped int32")
    fused = conv.fused_bgr0_phase_a(dev(rgb[0]), qt, 8, False, device)
    for (fc, fd), pl in zip(fused, yuv_rgb.bgr0_to_yuv420p(rgb[0])):
        sc, sd = pa.plane_context_diff(pa._wrap16(dev(pl.astype(np.int32))),
                                       qt, 8, False)
        if not (torch.equal(fc, sc) and torch.equal(fd, sd)):
            raise AssertionError("fused_bgr0_phase_a differs from the "
                                 "staged conversion + plane_context_diff")
    times["fused_bgr0_phase_a"] = dict(ms=cuda_ms(
        lambda: conv.fused_bgr0_phase_a(dev(rgb[0]), qt, 8, False, device),
        5))
    log(f"phase 17: the five conversions and fused_bgr0_phase_a at {W}x{H} "
        f"on the card equal the numpy models ({wraps} rgb48 sums wrapped "
        f"int32); ms: {json.dumps(times)} [{card}]")
    enc = device_encoder("yuv420p", W, H, cfg)
    nat, dec = NativeFFV1Codec(enc.p), NativeFFV1Codec(enc.p)
    _build.reset_counts()
    planes = [conv.bgr0_to_yuv420p(dev(img), device) for img in rgb]
    pkts = enc.encode_batch(planes)
    launches, plain = path_counts("capture", enc.kernels)
    for t, (img, pkt) in enumerate(zip(rgb, pkts)):
        model = [x.astype(np.int32) for x in yuv_rgb.bgr0_to_yuv420p(img)]
        if pkt != nat.encode(model, True):
            raise AssertionError(f"capture frame {t}: packet differs from "
                                 "the native codec's")
        for a, b in zip(dec.decode(pkt), model):
            if not np.array_equal(a, b):
                raise AssertionError(f"capture frame {t}: decode is not "
                                     "lossless")
    log(f"phase 17: capture path: {len(rgb)} bgr0 frames -> "
        f"bgr0_to_yuv420p on the card -> encode_batch (B = {len(rgb)}, "
        "tensors handed over) byte-identical to the native codec on the "
        f"numpy model's planes; launches {launches}, plain calls {plain}")
    return launches, times


FFV2_FRAMES = 3
FFV2_QP = 16                # bench.py's FFV2 qp
FP64_FLOPS = 67e12          # H100 SXM FP64 tensor-core peak, data sheet


def synth_ffv2_frames(n, depth, planes=3, seed=4, w=None, h=None):
    """Moving sawtooth ramps (a plane's slope its own) plus seeded noise
    whose amplitude grows across four column bands (0 at the left), so a
    frame codes a mix of smooth and busy superblocks; W x H unless given."""
    w, h = w or W, h or H
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    mx = (1 << depth) - 1
    amp = (xx * 4 // w) * ((mx + 1) >> 5)
    frames = []
    for t in range(n):
        frames.append([
            np.clip(((xx + 8 * t) * (p + 2) + (yy + 4 * t) * 3)
                    * (mx + 1) // 1024 % (mx + 1)
                    + (rng.randint(-128, 129, (h, w)) * amp >> 7), 0, mx)
            .astype(np.int32) for p in range(planes)])
    return frames


def ffv2_checks(out, card, device="cuda", clock_mhz=None,
                cycles=None) -> tuple:
    """Phase 18: FFV2 through ffv2/native.py at 1080p.  K18 and K19
    against their plain versions on frame 0 (on the card), the transforms
    and the stage times; then the main path with the launch counts reset
    (3 yuv444p frames, 1 gbrp10, 1 yuv444p split tree, each decoded on the
    card, the 3 frames again pipelined), checked against the host paths.
    Returns the path's launch counts and the phase's numbers.  ``device``
    is the card's, or "cpu" in a rehearsal with the plain versions;
    ``clock_mhz`` and ``cycles`` (phase 1's) give K18's chain bound."""
    import torch
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.ffv2 import FFV2Config
    from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
    from ffmpeg_ffv2_tpu_torch.ffv2 import dsp
    from ffmpeg_ffv2_tpu_torch.ffv2.native import (NativeFFV2Decoder,
                                                   NativeFFV2Encoder,
                                                   PipelinedFFV2Encoder)
    from ffmpeg_ffv2_tpu_torch.tools import latency
    from ffmpeg_ffv2_tpu_torch.tools.kernel_times import (device_ms,
                                                          pvq_classes)
    n, qp = dsp.SB_SIZE, FFV2_QP
    cfg = FFV2Config(qp=qp)
    frames = synth_ffv2_frames(FFV2_FRAMES, 8)
    enc = NativeFFV2Encoder(W, H, "yuv444p", cfg, device)
    dec = NativeFFV2Decoder(W, H, device=device)
    dec.decode(enc.encode(frames[0]))                 # warm-up

    # K19 and K18 against their plain versions on frame 0's inputs
    x = dv.upload(enc._pad(frames[0]), 8, device)
    q12 = ((x << 4) - 2048).contiguous()
    P, ph, pw = q12.shape
    nbx, nby = (pw - 1) // n, (ph - 1) // n
    rad = dv.LAP_RADIUS
    touched = P * (nbx * rad * ph + nby * rad * pw - nbx * rad * nby * rad)
    lines = P * (nbx * ph + nby * pw)
    lap_bound = bound(touched * 8, lines * rad * 8)

    def plain_lap(c, forward):
        for vertical in ((False, True) if forward else (True, False)):
            dv.lap_dir_plain(c, n, forward, vertical)
        return c

    pre = dv.lap_frame(q12.clone(), n, True)
    post_in = pre.clone()
    for key, forward, src in (("lap_pre", True, q12), ("lap_post", False,
                                                       post_in)):
        got = dv.lap_frame(src.clone(), n, forward)
        ref, plain_ms = cuda_ms_once(lambda: plain_lap(src.clone(), forward))
        scratch = src.clone()
        ms = cuda_ms(lambda: dv.lap_frame(scratch, n, forward), 5)
        k = _build.KERNELS[key]
        before = k.launches
        dv.lap_frame(scratch, n, forward)
        entry(out, key, "ffv2", max_abs_err([got], [ref]), ms, plain_ms,
              None, lap_bound, launches_a_call=k.launches - before,
              lines=lines, tiles=len(dv.lap_tiles(ph, pw, n, "frame")) * P,
              device_ms=(device_ms(lambda: dv.lap_frame(scratch, n,
                                                        forward), 5)
                         if device != "cpu" else None))
    streams = dv.encode_front_t(x, 8, n, n)
    bands = dsp.band_starts(n)
    NB = streams.shape[0]
    got = dv.quantize_t(streams, qp, bands, n)
    ref, plain_ms = cuda_ms_once(
        lambda: dv.quantize_plain(streams, qp, bands, n))
    ms = cuda_ms(lambda: dv.quantize_t(streams, qp, bands, n), 5)
    nbands, plen = len(bands) - 1, bands[-1] - bands[0]
    # every (row, band) runs its qp steps (a band of 2 or more positions
    # never runs out of candidates below the qp - 1 cap), about 8 integer
    # operations a position a step; the chain: qp steps of a warp's
    # argmax, 5 butterfly levels at the measured cycles of a level (the
    # positions' scores not counted); the classes as the launcher assigns
    # them, each timed alone
    on_card = device != "cpu"
    level = cycles[latency.K18_LEVEL] if cycles else None
    by_class = []
    for items, i, j in (pvq_classes(bands) if on_card else ()):
        sub = bands[i:j + 1]
        by_class.append(dict(
            bands=list(range(i, j)),
            lengths=[b - a for a, b in zip(sub, sub[1:])],
            positions_a_lane=items,
            ms=cuda_ms(lambda: dv.quantize_t(streams, qp, sub, n), 5),
            bound_ms=bound(0, NB * (sub[-1] - sub[0]) * qp * 8)["bound_ms"]))
    entry(out, "pvq", "ffv2", max_abs_err(got, ref), ms, plain_ms, None,
          bound(NB * (n * n * 4 + plen + 4 + nbands * 12),
                NB * plen * qp * 8),
          rows=NB, bands=nbands, qp=qp,
          device_ms=(device_ms(lambda: dv.quantize_t(streams, qp, bands, n),
                               5) if on_card else None),
          device_launches_a_call=(_build.device_launches(
              lambda: dv.quantize_t(streams, qp, bands, n))
              if on_card else None),
          argmax_level_cycles=level,
          chain_latency_ms=(qp * 5 * level / (clock_mhz * 1e3)
                            if level else None),
          classes=by_class)
    blocks = dv.blocks_of(pre, n)
    coeffs = dv.tx_batch_t(blocks, dsp.TX_DCT, False)
    tx = {}
    for name, arg, inverse in (("forward", blocks, False),
                               ("inverse", coeffs, True)):
        flops = 2 * 2 * NB * n ** 3          # two passes of n MACs an output
        b_ms = NB * n * n * 8 / HBM_BYTES_PER_S * 1e3
        f_ms = flops / FP64_FLOPS * 1e3
        tx[name] = dict(
            ms=cuda_ms(lambda: dv.tx_batch_t(arg, dsp.TX_DCT, inverse), 5),
            bound_ms=max(b_ms, f_ms),
            bound_by="bytes" if b_ms >= f_ms else "operations",
            blocks=NB, flops=flops)
    log(f"phase 18: the float64 transforms of {NB} 64x64 blocks (ms, CUDA "
        f"events; bound: FP64 tensor-core peak or bytes): "
        f"{json.dumps(tx)} [{card}]")
    del x, q12, pre, post_in, streams, got, ref, blocks, coeffs

    # the stage times of frame 0 (a warm session)
    marks = Marks()
    pkt0 = enc.encode(frames[0], mark=marks)
    enc_stages = marks.stages()
    marks = Marks()
    dec.decode(pkt0, mark=marks)
    dec_stages = marks.stages()
    log("phase 18: yuv444p frame 0 encode stage times (ms, CUDA events): "
        + json.dumps(enc_stages))
    log("phase 18: yuv444p frame 0 decode stage times (ms, CUDA events): "
        + json.dumps(dec_stages))

    # the main path, counts reset
    gbr = synth_ffv2_frames(1, 10, seed=5)[0]
    enc10 = NativeFFV2Encoder(W, H, "gbrp10", cfg, device)
    enc_split = NativeFFV2Encoder(W, H, "yuv444p",
                                  FFV2Config(qp=qp, block_size=0), device)
    enc10.encode(gbr)
    enc_split.encode(frames[0])
    pipe = PipelinedFFV2Encoder(W, H, "yuv444p", cfg, depth=2,
                                device=device)
    try:
        _build.reset_counts()
        cases, enc_ms, dec_ms = [], [], []
        for label, e, f in ([(f"yuv444p {t}", enc, fr)
                             for t, fr in enumerate(frames)]
                            + [("gbrp10", enc10, gbr),
                               ("yuv444p block_size=0", enc_split,
                                frames[0])]):
            t0 = time.perf_counter()
            pkt = e.encode(f)
            enc_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            planes = dec.decode(pkt)
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            cases.append((label, e, f, pkt, planes))
        piped = pipe.encode_stream(frames)
        launches, plain = path_counts("ffv2", ("pvq", "lap_pre", "lap_post"))
    finally:
        pipe.close()
    n_q = FFV2_FRAMES * 2 + 1              # the q-path frames, pipelined too
    want = dict(pvq=n_q, lap_pre=n_q + 1, lap_post=len(cases))
    got_counts = {k: launches[k] for k in want}
    if got_counts != want:
        raise AssertionError(f"ffv2: launches {got_counts}, expected {want}")
    if piped != [c[3] for c in cases[:FFV2_FRAMES]]:
        raise AssertionError("ffv2: the pipelined packets differ from the "
                             "sequential ones")
    psnr = {}
    for label, e, f, pkt, planes in cases:
        if pkt != e.encode_host(f):
            raise AssertionError(f"ffv2 {label}: packet differs from "
                                 "encode_host's")
        for a, b in zip(planes, dec.decode_host(pkt)):
            if not np.array_equal(a, b):
                raise AssertionError(f"ffv2 {label}: the card decode "
                                     "differs from decode_host")
        mx = (1 << e.fmt.bits) - 1
        err = np.mean([np.mean((a.astype(np.float64) - b) ** 2)
                       for a, b in zip(planes, f)])
        psnr[label] = round(10 * np.log10(mx * mx / max(err, 1e-12)), 3)
        if not 10 < psnr[label] < 99:        # finite, not noise
            raise AssertionError(f"ffv2 {label}: PSNR {psnr[label]} dB")
    sizes = {c[0]: len(c[3]) for c in cases}
    log(f"phase 18: ffv2 {W}x{H} qp {qp}: {json.dumps(sizes)} bytes, every "
        "packet byte-identical to encode_host and every card decode equal "
        f"to decode_host; PSNR (dB) {json.dumps(psnr)}; pipelined (depth 2) "
        f"packets equal the sequential ones; launches {got_counts}, plain "
        f"calls {sum(plain.values())}")
    log(f"phase 18: whole frames (ms, host clock): encode "
        f"{[round(v, 2) for v in enc_ms]}, decode "
        f"{[round(v, 2) for v in dec_ms]} ({[c[0] for c in cases]}) "
        f"[{card}]")
    return launches, dict(encode_stages=enc_stages, decode_stages=dec_stages,
                          encode_ms=enc_ms, decode_ms=dec_ms,
                          cases=[c[0] for c in cases], packet_bytes=sizes,
                          psnr_db=psnr, transforms=tx)


PAR_UHD = (3840, 2160)       # phase 19's FFV2 frame: 34 SB rows padded
PAR_REPS = 4                 # its front's calls, the first cold


def _compact(frame, bits=8):
    """Planes in their sample width (uint8 / uint16): what a world's ranks
    are sent."""
    dt = np.uint8 if bits <= 8 else np.uint16
    return [np.ascontiguousarray(pl, dtype=dt) for pl in frame]


def _shifted(frames, dx=7):
    """Lane 1's frames: lane 0's, every plane rolled dx columns."""
    return [[np.roll(pl, dx, axis=1) for pl in fr] for fr in frames]


def _rank_counts(label, results, kernels):
    """Each rank's launch counts after its part of the main path: every
    kernel of ``kernels`` launched, no plain version run."""
    for r in results:
        if r is None:
            continue
        missing = [k for k in kernels if r["launches"][k] <= 0]
        if missing or any(r["plain"].values()):
            raise AssertionError(
                f"{label}: rank {r['rank']} launched {r['launches']} with "
                f"plain calls {r['plain']} (kernels {list(kernels)})")
    return [{k: r["launches"][k] for k in kernels} for r in results if r]


def world_start(started) -> dict:
    """A world's start by rank, in s, from each rank's ``started`` marks
    (parallel.world.run_cases, on the host's wall clock): interpreter
    (the parent starting the ranks to a rank's body: its interpreter, the
    spawn bootstrap and its imports), group (the process group joined),
    device (the card set and its CUDA context made)."""
    spans = dict(interpreter=("spawn", "main"), group=("main", "group"),
                 device=("group", "ready"))
    return {k: [round(st[b] - st[a], 2) for st in started]
            for k, (a, b) in spans.items()}


def _world_ffv1_checks(label, results, case, card, device):
    """One FFV1 case of a world against the single-device port (timed on
    this process, one rank's worth: encode() of the same frames) and the
    native codec, and its lossless decode; returns the case's numbers."""
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
    r0 = results[0]
    for r in results:
        if r["digests"] != r0["digests"]:
            raise AssertionError(f"{label}: rank {r['rank']}'s packets "
                                 "differ from rank 0's")
    lanes = case["lanes"]
    one_ms = []
    for b, frames in enumerate(lanes):
        frames = [[pl.astype(np.int32) for pl in fr] for fr in frames]
        enc = DeviceFFV1Encoder(case["width"], case["height"],
                                case["pix_fmt"], case["cfg"], device=device)
        nat, dec = NativeFFV1Codec(enc.p), NativeFFV1Codec(enc.p)
        gop = case["cfg"].gop_size
        for t, fr in enumerate(frames):
            key = gop == 0 or t % gop == 0
            t0 = time.perf_counter()
            pkt = enc.encode(fr)
            one_ms.append((time.perf_counter() - t0) * 1e3)
            got = r0["packets"][t][b]
            if got != pkt or got != nat.encode(fr, key):
                raise AssertionError(f"{label} lane {b} frame {t}: the "
                                     "sharded packet differs from the "
                                     "single-device port's or the native "
                                     "codec's")
            for a, x in zip(dec.decode(got), fr):
                if not np.array_equal(a, x):
                    raise AssertionError(f"{label} lane {b} frame {t}: "
                                         "decode is not lossless")
    counts = _rank_counts(label, results, r0["kernels"])
    frame_ms = [[round(x, 2) for x in r["frame_ms"]] for r in results]
    gather_ms = [[round(st["gather"], 2) for st in r["stage_ms"]]
                 for r in results]
    log(f"phase 19: {label}: {len(results)} rank(s) "
        f"({results[0]['transport']}"
        f", mesh ({len(lanes)}, {len(results) // len(lanes)})), "
        f"{len(lanes)} lanes x {len(r0['packets'])} frames "
        f"{case['width']}x{case['height']} {case['pix_fmt']} "
        f"({case['cfg'].slices} slices, coder {case['cfg'].coder}, "
        f"{r0['units']} shape bank(s)): every packet equal to the "
        f"single-device port's and the native codec's, decoded losslessly; "
        f"launches by rank {counts}, plain calls 0")
    log(f"phase 19: {label}: step ms by rank (host clock; every lane's "
        f"frame a step) {frame_ms}, of which the gathers {gather_ms}; "
        f"encode() of the same frames on one rank "
        f"{[round(x, 2) for x in one_ms]} [{card}]")
    return dict(ranks=len(results), lanes=len(lanes),
                transport=results[0]["transport"], frame_ms=frame_ms,
                gather_ms=gather_ms, stage_ms=[r["stage_ms"] for r in
                                               results],
                single_device_ms=one_ms, launches=counts)


def parallel_checks(frames, card, device="cuda", nccl="nccl") -> tuple:
    """Phase 19: the sharded encoders (parallel/) as worlds of ranks that
    share this card (parallel.world.spawn_world; ``device`` "cpu" and
    ``nccl`` "gloo" in a CPU rehearsal).  FFV1: a gloo world of 4 ranks on
    a (2, 2) mesh (1080p yuv420p range 3 frames and rice 2 on two lanes,
    lane 1 shifted; 720x486 yuv422p10 in two shape banks, 2 frames), then
    a 1-rank NCCL world on the range frames; FFV2: a gloo world of 2
    ranks, the SB-banded front of a 3840x2160 yuv444p frame and its packet
    through encode(front_q=).  Returns (the path's launches summed over
    the ranks, by path; the phase's numbers)."""
    from functools import reduce
    from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
    from ffmpeg_ffv2_tpu_torch.ffv2 import FFV2Config, dsp
    from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
    from ffmpeg_ffv2_tpu_torch.ffv2.native import NativeFFV2Encoder
    from ffmpeg_ffv2_tpu_torch.parallel.world import run_cases, spawn_world
    w, h = frames[0][0].shape[::-1]
    lane0 = [_compact(fr) for fr in frames[:3]]
    lanes = [lane0, _shifted(lane0)]
    sd = [_compact(fr, 10) for fr in synth_sd_frames(2, *SD)]
    base = dict(kind="ffv1", mesh=(2, 2), pix_fmt="yuv420p", width=w,
                height=h)
    ffv1 = {
        "range": dict(base, lanes=lanes,
                      cfg=FFV1Config(level=3, coder=1, slices=30,
                                     gop_size=3)),
        "rice": dict(base, lanes=[x[:2] for x in lanes],
                     cfg=FFV1Config(level=3, coder=0, slices=30,
                                    gop_size=3)),
        "sd banks": dict(base, width=SD[0], height=SD[1],
                         pix_fmt="yuv422p10", lanes=[sd, _shifted(sd)],
                         cfg=FFV1Config(level=3, coder=1, slices=24,
                                        slicecrc=1, gop_size=3)),
    }
    cases = [dict(c, name=k) for k, c in ffv1.items()]
    out, launches = {}, {}

    def total(results):
        return reduce(lambda a, r: {k: a.get(k, 0) + v for k, v in
                                    r["launches"].items()},
                      [r for r in results if r], {})

    t0 = time.perf_counter()
    res = spawn_world(run_cases, 4, "gloo", 600, cases, device)
    world_s = time.perf_counter() - t0
    for i, c in enumerate(cases):
        rs = [r[i] for r in res]
        out[c["name"]] = _world_ffv1_checks(f"parallel {c['name']}", rs, c,
                                            card, device)
        launches[f"parallel {c['name']}"] = total(rs)
    out["gloo_world_s"] = world_s
    out["gloo_world_start_s"] = world_start(
        [next(x for x in r if x)["started"] for r in res])
    log(f"phase 19: the 4-rank gloo world: {world_s:.1f} s wall, spawn "
        f"and process-group start included; its start by rank, s (host "
        f"clock) {out['gloo_world_start_s']} [{card}]")

    one = dict(ffv1["range"], name="range nccl", mesh=(1, 1),
               lanes=lanes[:1])
    t0 = time.perf_counter()
    rs = [r[0] for r in spawn_world(run_cases, 1, nccl, 300, [one], device)]
    out["range nccl"] = _world_ffv1_checks("parallel range nccl", rs, one,
                                           card, device)
    out["range nccl"]["world_s"] = time.perf_counter() - t0
    launches["parallel range nccl"] = total(rs)

    # FFV2: the 3840x2160 front banded over 2 ranks (17 SB rows each)
    uw, uh = PAR_UHD
    qp = FFV2_QP
    frame = _compact(synth_ffv2_frames(1, 8, w=uw, h=uh)[0])
    enc = NativeFFV2Encoder(uw, uh, "yuv444p", FFV2Config(qp=qp), device)
    padded = enc._pad(frame).astype(np.uint8)
    bands = list(dsp.band_starts(dsp.SB_SIZE))
    fcases = [dict(kind="ffv2", name="front", mesh=(1, 2), planes=padded,
                   depth=8, qp=qp, reps=PAR_REPS),
              dict(kind="ffv2", name="packet", mesh=(1, 2), packet=True,
                   width=uw, height=uh, pix_fmt="yuv444p", qp=qp,
                   planes=frame, reps=2)]
    t0 = time.perf_counter()
    res = spawn_world(run_cases, 2, "gloo", 300, fcases, device)
    world_s = time.perf_counter() - t0
    one_ms = []
    for _ in range(PAR_REPS):
        t0 = time.perf_counter()
        ref = dv.encode_front_q(padded, 8, qp, bands, device=device)
        one_ms.append((time.perf_counter() - t0) * 1e3)
    front, packet = ([r[i] for r in res] for i in range(2))
    for rs in (front, packet):
        if any(r["digest"] != rs[0]["digest"] for r in rs):
            raise AssertionError(f"ffv2 {rs[0]['name']}: the ranks' results "
                                 "differ")
    if not all(np.array_equal(a, b) for a, b in zip(front[0]["result"],
                                                     ref)):
        raise AssertionError("ffv2: the sharded front differs from "
                             "encode_front_q")
    enc_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        pkt = enc.encode(frame)
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    if packet[0]["result"] != pkt or pkt != enc.encode_host(frame):
        raise AssertionError("ffv2: the packet through the sharded front "
                             "differs from encode() or encode_host()")
    counts = _rank_counts("parallel ffv2", front + packet,
                          ("pvq", "lap_pre"))
    launches["parallel ffv2"] = total(front + packet)
    stages = [{k: round(v, 2) for k, v in r["stage_ms"].items()}
              for r in front]
    log(f"phase 19: parallel ffv2: 2 ranks ({front[0]['transport']}), "
        f"{uw}x{uh} yuv444p qp {qp} ({padded.shape[1] // dsp.SB_SIZE} SB "
        f"rows, {padded.shape[1] // dsp.SB_SIZE // 2} a rank): the sharded "
        "front equals encode_front_q on every array, its packet equals "
        f"encode() and encode_host() ({len(pkt)} bytes); launches by rank "
        f"{counts}, plain calls 0")
    log(f"phase 19: parallel ffv2: the sharded front's ms by rank (host "
        f"clock, {PAR_REPS} calls, the first cold) "
        f"{[[round(x, 2) for x in r['ms']] for r in front]}, the last's "
        f"stages {stages}; encode_front_q on one rank "
        f"{[round(x, 2) for x in one_ms]}; the packet through the sharded "
        f"front {[[round(x, 2) for x in r['ms']] for r in packet]}, "
        f"encode() {[round(x, 2) for x in enc_ms]}; world {world_s:.1f} s "
        f"wall [{card}]")
    out["ffv2"] = dict(ranks=2, transport=front[0]["transport"],
                       front_ms=[r["ms"] for r in front],
                       front_stage_ms=[r["stage_ms"] for r in front],
                       single_device_front_ms=one_ms,
                       packet_ms=[r["ms"] for r in packet],
                       encode_ms=enc_ms, launches=counts,
                       world_s=world_s)
    return launches, out


CLI_FRAMES = 4               # phase 20's frames: 2 key, 2 inter at -g 2


def _cli_run(cli, *argv) -> tuple:
    """``main`` of the port's CLI in process: (stdout, stderr)."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli([str(a) for a in argv])
    return out.getvalue(), err.getvalue()


def _launch_counts() -> dict:
    from ffmpeg_ffv2_tpu_torch import _build
    return {k.name: k.launches for k in _build.KERNELS.values()}


def cli_checks(frames, card, device="cuda") -> tuple:
    """Phase 20: the port's CLI on the card, as a user runs it (``main``
    of ``ffmpeg_ffv2_tpu_torch.cli.main``, in process, its encodes on the
    default backend, device; ``-device`` of the tpu and device backends
    is ``device``).  Returns the launch counts of
    its two device encodes and the CLI's times."""
    import os
    import tempfile
    from ffmpeg_ffv2_tpu_torch.cli.main import main as cli
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import (RANGE_KERNELS,
                                                          RICE_KERNELS)

    def run(*argv):
        return _cli_run(cli, *argv)[0]

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    with tempfile.TemporaryDirectory(prefix="ffv_cli_") as td:
        raw = os.path.join(td, "in.yuv")
        with open(raw, "wb") as f:
            for planes in frames[:CLI_FRAMES]:
                for pl in planes:
                    f.write(np.asarray(pl, np.uint8).tobytes())
        src = read(raw)
        enc = ["encode", "-i", raw, "-s", f"{W}x{H}", "-level", 3,
               "-slices", 30, "-g", 2]
        # the path: the default backend (device) on both coders
        from ffmpeg_ffv2_tpu_torch import _build
        _build.reset_counts()
        ms = {}
        for coder in ("ac", "rice"):
            t0 = time.perf_counter()
            run(*enc, "-coder", coder, "-device", device,
                "-o", os.path.join(td, f"device_{coder}.avi"))
            ms[coder] = (time.perf_counter() - t0) * 1e3 / CLI_FRAMES
        launches, plain = path_counts("cli", RANGE_KERNELS + RICE_KERNELS)
        results = {}
        for coder in ("ac", "rice"):
            dev = read(os.path.join(td, f"device_{coder}.avi"))
            for backend in ("native", "tpu"):
                name = os.path.join(td, f"{backend}_{coder}.avi")
                run(*enc, "-coder", coder, "--backend", backend, "-device",
                    device, "-o", name)
                if read(name) != dev:
                    raise AssertionError(f"cli -coder {coder}: --backend "
                                         f"device's AVI differs from "
                                         f"--backend {backend}'s")
            for workers in (1, 4):
                out = os.path.join(td, f"dec_{coder}_{workers}.yuv")
                run("decode", "-workers", workers, "-i",
                    os.path.join(td, f"device_{coder}.avi"), "-o", out)
                if read(out) != src:
                    raise AssertionError(f"cli -coder {coder}: decode "
                                         f"-workers {workers} differs from "
                                         "the input")
            results[coder] = dict(avi_bytes=len(dev),
                                  wall_ms_a_frame=ms[coder])
        for ext in ("mkv", "nut"):
            name = os.path.join(td, f"device.{ext}")
            run(*enc, "-coder", "ac", "-device", device, "-o", name)
            out = os.path.join(td, f"dec_{ext}.yuv")
            run("decode", "-i", name, "-o", out)
            if read(out) != src:
                raise AssertionError(f"cli .{ext}: decode differs from the "
                                     "input")
        info = run("info", "-i", os.path.join(td, "device_ac.avi"))
        if "ffv1: version 3" not in info:
            raise AssertionError(f"cli info: {info!r}")
        line = run("psnr", raw, os.path.join(td, "dec_ac_4.yuv")).strip()
        if "PSNR:999.99" not in line:
            raise AssertionError(f"cli psnr: {line!r}")
    log(f"phase 20: cli: {CLI_FRAMES} frames {W}x{H} yuv420p -level 3 "
        f"-slices 30 -g 2, the default --backend device equal to native "
        f"and tpu for "
        f"-coder ac and rice, decoded with and without -workers 4, .mkv "
        f"and .nut round trips; {info.strip().splitlines()[-1]}; {line}")
    log(f"phase 20: cli: wall ms a frame (host clock: read, set-up, "
        f"encode, mux) ac {ms['ac']:.1f}, rice {ms['rice']:.1f}; launches "
        f"{ {k: v for k, v in launches.items() if v} } [{card}]")
    return launches, results


def cli_ffv2_checks(card, device="cuda") -> tuple:
    """Phase 20, FFV2: CLI_FRAMES frames of 1080p yuv444p through ``-c
    ffv2 -qp FFV2_QP`` on ``device`` (the default), at -block_size 64 with
    -workers 1 (NativeFFV2Encoder) and 4 (PipelinedFFV2Encoder) and at
    -block_size 0 (the split tree), then each AVI's CLI decode; the
    launch counts reset before the five commands and read after them
    (path "cli ffv2": K18, K19 pre and post, no plain version).  Every
    packet equals NativeFFV2Encoder.encode_host's, every decode
    decode_host's.  Returns (the launches, the numbers)."""
    import os
    import tempfile
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.cli.main import main as cli
    from ffmpeg_ffv2_tpu_torch.container.avi import AviReader
    from ffmpeg_ffv2_tpu_torch.ffv2 import FFV2Config
    from ffmpeg_ffv2_tpu_torch.ffv2.native import (NativeFFV2Decoder,
                                                   NativeFFV2Encoder)
    frames = synth_ffv2_frames(CLI_FRAMES, 8)
    runs = [("64", "1"), ("64", "4"), ("0", "1")]
    res = {}
    with tempfile.TemporaryDirectory(prefix="ffv_cli_ffv2_") as td:
        raw = os.path.join(td, "in444.yuv")
        with open(raw, "wb") as f:
            for fr in frames:
                for pl in fr:
                    f.write(pl.astype(np.uint8).tobytes())
        # the default -device (cuda); "cpu" in a rehearsal of the phase
        dev = [] if device == "cuda" else ["-device", device]
        enc = ["encode", "-i", raw, "-s", f"{W}x{H}", "-pix_fmt", "yuv444p",
               "-c", "ffv2", "-qp", FFV2_QP, *dev]
        def timed(name, *argv):
            """One command: its wall ms a frame and its own launches."""
            before = _launch_counts()
            t0 = time.perf_counter()
            _cli_run(cli, *argv)
            res[name] = dict(
                wall_ms_a_frame=(time.perf_counter() - t0) * 1e3 / CLI_FRAMES,
                launches={k: v - before[k] for k, v in
                          _launch_counts().items() if v - before[k]})

        _build.reset_counts()
        for bs, workers in runs:
            timed(f"encode bs{bs} w{workers}", *enc, "-block_size", bs,
                  "-workers", workers, "-o",
                  os.path.join(td, f"bs{bs}_w{workers}.avi"))
        decoded = {}
        for bs in ("64", "0"):
            out = os.path.join(td, f"dec_bs{bs}.yuv")
            timed(f"decode bs{bs}", "decode", *dev, "-i",
                  os.path.join(td, f"bs{bs}_w1.avi"), "-o", out)
            with open(out, "rb") as f:
                decoded[bs] = f.read()
        launches, _ = path_counts("cli ffv2", ("pvq", "lap_pre", "lap_post"))
        avis = {}
        for bs, workers in runs:
            with open(os.path.join(td, f"bs{bs}_w{workers}.avi"), "rb") as f:
                avis[bs, workers] = AviReader(f.read()).video.packets
    sizes = {}
    for bs in ("64", "0"):
        e = NativeFFV2Encoder(W, H, "yuv444p",
                              FFV2Config(qp=FFV2_QP, block_size=int(bs)),
                              device)
        want = [e.encode_host(fr) for fr in frames]
        for (b, workers), pkts in avis.items():
            if b == bs and pkts != want:
                raise AssertionError(f"cli ffv2 -block_size {bs} -workers "
                                     f"{workers}: a packet differs from "
                                     "encode_host's")
        dec = NativeFFV2Decoder(W, H, device=device)
        ref = b"".join(np.asarray(pl).astype(np.uint8).tobytes()
                       for pkt in want for pl in dec.decode_host(pkt))
        if decoded[bs] != ref:
            raise AssertionError(f"cli ffv2 -block_size {bs}: decode differs "
                                 "from decode_host")
        sizes[bs] = [len(x) for x in want]
    # each command's own kernels (the split tree codes its leaves on the
    # host: K19 only)
    for name, kernels in [(f"encode bs{bs} w{w}", ("pvq", "lap_pre") if
                           bs == "64" else ("lap_pre",)) for bs, w in runs] \
            + [(f"decode bs{bs}", ("lap_post",)) for bs in ("64", "0")]:
        if any(k not in res[name]["launches"] for k in kernels):
            raise AssertionError(f"cli ffv2 {name}: launched "
                                 f"{res[name]['launches']}, not {kernels}")
    log(f"phase 20: cli ffv2: {CLI_FRAMES} frames {W}x{H} yuv444p -qp "
        f"{FFV2_QP}, -block_size 64 (-workers 1 and 4) and 0: every packet "
        f"equal to encode_host's (bytes {json.dumps(sizes)}), each CLI "
        f"decode equal to decode_host's; launches {launches}, plain calls 0")
    log("phase 20: cli ffv2: wall ms a frame (host clock: read, set-up, "
        "frames, mux; decode: demux, frames, write) and each command's "
        "launches " + json.dumps(res) + f" [{card}]")
    return launches, dict(runs=res, packet_bytes=sizes)


def cli_mesh_checks(frames, card, device="cuda") -> tuple:
    """Phase 20, --mesh 2x2: phase 20's CLI_FRAMES frames of 1080p yuv420p
    at -level 3 -slices 30 -g 2, -coder ac and rice, through the CLI's
    --mesh 2x2 on ``device`` (a world of 4 ranks; gloo, as one card has
    fewer cards than ranks): each AVI equal to the single-device CLI's
    (--backend device), every rank launching its path's kernels with no
    plain version (the counts each rank reads around its frames, from the
    CLI's stderr).  Returns (the launches summed over the ranks, by path;
    the numbers)."""
    import os
    import tempfile
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.cli.main import main as cli
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import (RANGE_KERNELS,
                                                          RICE_KERNELS)
    launches, out = {}, {}
    with tempfile.TemporaryDirectory(prefix="ffv_cli_mesh_") as td:
        raw = os.path.join(td, "in.yuv")
        with open(raw, "wb") as f:
            for planes in frames[:CLI_FRAMES]:
                for pl in planes:
                    f.write(np.asarray(pl, np.uint8).tobytes())
        dev = [] if device == "cuda" else ["-device", device]
        enc = ["encode", "-i", raw, "-s", f"{W}x{H}", "-level", 3,
               "-slices", 30, "-g", 2, *dev]
        for coder, kernels in (("ac", RANGE_KERNELS), ("rice", RICE_KERNELS)):
            one = os.path.join(td, f"one_{coder}.avi")
            _cli_run(cli, *enc, "-coder", coder, "-o", one)
            mesh = os.path.join(td, f"mesh_{coder}.avi")
            t0 = time.perf_counter()
            _, err = _cli_run(cli, *enc, "-coder", coder, "--mesh", "2x2",
                              "-o", mesh)
            wall = (time.perf_counter() - t0) * 1e3 / CLI_FRAMES
            with open(one, "rb") as f1, open(mesh, "rb") as f2:
                if f1.read() != f2.read():
                    raise AssertionError(f"cli --mesh 2x2 -coder {coder}: "
                                         "the AVI differs from the "
                                         "single-device CLI's")
            line = [x for x in err.splitlines()
                    if x.startswith("--mesh 2x2: ")][0]
            ranks = json.loads(err.split("--mesh ranks: ")[1].splitlines()[0])
            for r in ranks:
                if any(r["launches"].get(k, 0) <= 0 for k in kernels) or \
                        r["plain_calls"]:
                    raise AssertionError(f"cli --mesh 2x2 -coder {coder}: "
                                         f"rank {r['rank']} launched "
                                         f"{r['launches']}, plain calls "
                                         f"{r['plain_calls']}")
            label = f"cli mesh {coder}"
            launches[label] = {k: sum(r["launches"].get(k, 0) for r in ranks)
                               for k in _build.KERNELS}
            start = {k: [round(r["start_s"][k], 2) for r in ranks]
                     for k in ranks[0]["start_s"]}
            setup = [round(r["setup_ms"], 1) for r in ranks]
            out[coder] = dict(transport=ranks[0]["transport"],
                              wall_ms_a_frame=wall,
                              rank_ms_a_frame=[r["ms"] / CLI_FRAMES
                                               for r in ranks],
                              start_s=start, setup_ms=setup,
                              launches=[r["launches"] for r in ranks])
            log(f"phase 20: cli {line.strip()}: -coder {coder}, the AVI "
                f"equal to the single-device CLI's; launches by rank "
                f"{[r['launches'] for r in ranks]}, plain calls 0")
            log(f"phase 20: cli --mesh 2x2 -coder {coder}: wall ms a frame "
                f"(host clock: read, world start, frames, mux) {wall:.1f}, "
                f"ms a frame by rank (its encode steps) "
                f"{[round(r['ms'] / CLI_FRAMES, 1) for r in ranks]}; the "
                f"world's start by rank, s {start}, the encoder's set-up ms "
                f"{setup} [{card}]")
    return launches, out


def graft_checks(card) -> tuple:
    """Phase 21: the graft twin (graft_entry.py) on the card: entry()'s
    step on seeded planes of its example's shape, equal as integers to its
    own CPU run; then dryrun_multichip(4), a gloo world of 4 ranks sharing
    the card, every config passing its own checks, each rank launching
    its configs' kernels with no plain version.  Returns (the launches
    summed over the ranks and configs, the numbers)."""
    import torch
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch import graft_entry as ge
    fn, (ex,) = ge.entry()
    cfn, (cex,) = ge.entry("cpu")
    if ex.device.type != "cuda" or ex.shape != cex.shape:
        raise AssertionError(f"graft entry: example on {ex.device}, "
                             f"{tuple(ex.shape)}")
    x = np.random.RandomState(21).randint(-70000, 70000, tuple(ex.shape))
    xc = torch.as_tensor(x, dtype=torch.int32)
    xg = xc.to("cuda")
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(xg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    want = cfn(xc)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    for g, w in zip(got, want):
        if g.dtype != torch.int32 or not torch.equal(g.cpu(), w):
            raise AssertionError("graft entry: the card's (ctx, diff) "
                                 "differ from the CPU run's")
    log(f"phase 21: graft entry: the step on {tuple(ex.shape)} int32 planes "
        f"equal to its CPU run; ms on the card (host clock, synchronized) "
        f"{[round(v, 2) for v in ms]}, on the CPU {cpu_ms:.1f} [{card}]")
    t0 = time.perf_counter()
    res = ge.dryrun_multichip(4)
    world_s = time.perf_counter() - t0
    launches = {k: 0 for k in _build.KERNELS}
    for name, rec in res.items():
        kernels = (("pvq", "lap_pre") if name.startswith("ffv2") else
                   ("place", "vlc", "ladder") if "/coder0/" in name else
                   ("place", "adapt", "emission_pack", "expand",
                    "rac_render"))
        for r, (ln, pc) in enumerate(zip(rec["launches"],
                                         rec["plain_calls"])):
            if any(ln[k] <= 0 for k in kernels) or any(pc.values()):
                raise AssertionError(f"graft dryrun {name}: rank {r} "
                                     f"launched {ln}, plain calls {pc}")
            for k, v in ln.items():
                launches[k] += v
    start = world_start(next(iter(res.values()))["started"])
    log(f"phase 21: graft dryrun_multichip(4): {len(res)} configs passed "
        f"on a gloo world of 4 ranks sharing the card in {world_s:.1f} s "
        f"wall (spawn and process-group start included; its start by rank, "
        f"s {start}); launches summed "
        f"{ {k: v for k, v in launches.items() if v} }, plain calls 0; ms "
        "by rank (rank 0's frames or calls) "
        + json.dumps({n: [round(x, 1) for x in r["ms"][0]]
                      for n, r in res.items()}) + f" [{card}]")
    return launches, dict(entry_ms=ms, entry_cpu_ms=cpu_ms,
                          dryrun_world_s=world_s, dryrun_start_s=start,
                          dryrun_ms={n: r["ms"] for n, r in res.items()})


class Phase:
    """Logs a phase's wall seconds when its block ends."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"phase {self.n}: wall {time.perf_counter() - self.t0:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.ffv1 import native
    from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
    from ffmpeg_ffv2_tpu_torch.ops.place import place
    from ffmpeg_ffv2_tpu_torch.tools import latency

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

    # 1. build: the native oracle (g++) and the latency chains (nvcc)
    # beside the kernels (nvcc); then the chains' cycles a link
    with Phase(1):
        t0 = time.perf_counter()
        nat_err = []

        def build_native():
            try:
                native.build()
                latency.build()
            except Exception as e:        # re-raised below, after the join
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
        with open(_build.library_path().rsplit("/", 1)[0]
                  + "/build.log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log("  ptxas:", line.strip())
        cycles = latency.measure()
        log("phase 1: SM cycles a link of the serial kernels' chains "
            "(tools/latency.cu, one warp): " + ", ".join(
                f"{k} {v:.2f}" for k, v in cycles.items()))

    frames = synth_1080p_frames(N_FRAMES, W, H)
    kernels, launches = {}, {}
    range_cfg = FFV1Config(level=3, coder=1, slices=30)
    rice_cfg = FFV1Config(level=3, coder=0, slices=30)

    # 2.-5. yuv420p 1080p: the range and the Golomb-Rice coder
    with Phase(2):
        phase_a_checks(kernels, frames)
        _, inputs = probe("phase 2: range", "yuv420p", W, H, range_cfg,
                          frames[0])
        range_checks(kernels, inputs, clock_mhz, cycles)
        range_k1 = inputs["k1"]
        del inputs
    with Phase(3):
        launches["range"] = drive(
            "range", device_encoder("yuv420p", W, H, range_cfg), frames,
            card, 3)
    with Phase(4):
        _, inputs = probe("phase 4: rice", "yuv420p", W, H, rice_cfg,
                          frames[0])
        rk1 = inputs["k1"]
        place_checks(kernels, range_k1, "range", also=(rk1,),
                     ms_rice=cuda_ms(lambda: place(*rk1), 5),
                     rice=f"N={rk1[0]['dest'].shape[0]} "
                          f"cells={rk1[1] * 128}")
        rice_checks(kernels, inputs, clock_mhz, cycles)
        del inputs, range_k1, rk1
    with Phase(5):
        launches["rice"] = drive(
            "rice", device_encoder("yuv420p", W, H, rice_cfg), frames, card,
            5)

    # 6. rgb48: K2 with R = 7 and K6 on the same cells, then the frames
    with Phase(6):
        rgb48 = synth_rgb48_frames(N_NEW, W, H)
        cfg = FFV1Config(level=3, coder=1, slices=30, slicecrc=1)
        enc, inputs = probe("phase 6: rgb48", "rgb48", W, H, cfg, rgb48[0])
        big = walk_check(kernels, inputs, clock_mhz, cycles, "adapt_rgb48",
                         "rgb48", False)
        k = inputs["walk"]
        from ffmpeg_ffv2_tpu_torch.ffv1 import host
        ev_in = dict(walk=k + (host.n_ev_words(enc.banks[0].code_bits),))
        walk_check(kernels, ev_in, clock_mhz, cycles,
                   "adapt_emission_rgb48", "rgb48", True)
        pack_check(kernels, inputs["pack"], "rgb48",
                   key="emission_pack_rgb48")
        e = kernels["adapt_rgb48"]
        log(f"phase 6: rgb48: {e['cells_e_over_9']} of {e['valid_cells']} "
            f"valid cells have e > 9 ({big} in the cut), so the repeat "
            "sub-steps run")
        if not big:
            raise AssertionError("rgb48: no cell with e > 9 in the cut")
        del enc, inputs, ev_in, k
        launches["rgb48"] = drive(
            "rgb48", device_encoder("rgb48", W, H, cfg), rgb48, card, 6,
            not_launched=("adapt_emission",))
        del rgb48

    # 7. bgr0 v4: the per-slice RCT search, emission order (K6)
    rgb = synth_rgb_frames(N_NEW, W, H)
    with Phase(7):
        cfg = FFV1Config(level=4, coder=1, slices=30, slicecrc=1)
        enc, inputs = probe("phase 7: bgr0 v4", "bgr0", W, H, cfg, rgb[0],
                            emission=True)
        walk_check(kernels, inputs, clock_mhz, cycles, None, "bgr0 v4",
                   True)
        k6_pack_check(kernels, inputs["walk"])
        # K6 on phase 6's rgb48 cells (a path that runs K2) rides in K6's
        # entry, which reports the launches of its own path
        kernels["adapt_emission"]["at_rgb48"] = kernels.pop(
            "adapt_emission_rgb48")
        for at in ("rgb48", "bgr0_v4"):
            kernels["emission_pack"][f"at_{at}"] = kernels.pop(
                f"emission_pack_{at}")
        hist = {}
        for fr in rgb:
            dev = [torch.as_tensor(x, device=enc.device) for x in fr]
            for pair in enc.banks[0].pick_rct(dev):
                hist[str(pair)] = hist.get(str(pair), 0) + 1
        log(f"phase 7: bgr0 v4: chosen (by, ry) over {N_NEW} frames x "
            f"{enc.banks[0].S} slices: {json.dumps(hist, sort_keys=True)}")
        del enc, inputs
        launches["bgr0 v4"] = drive(
            "bgr0 v4", device_encoder("bgr0", W, H, cfg, emission=True), rgb,
            card, 7, not_launched=("adapt", "emission_pack"))

    # 8. bgr0 Golomb-Rice (FATE's RGB configuration)
    with Phase(8):
        enc, inputs = probe("phase 8: bgr0 rice", "bgr0", W, H, rice_cfg,
                            rgb[0])
        rice_checks(kernels, inputs, clock_mhz, cycles,
                    bits=enc.banks[0].code_bits,
                    suffix="_bgr0", path="bgr0 rice", ladder=False)
        del enc, inputs
        launches["bgr0 rice"] = drive(
            "bgr0 rice", device_encoder("bgr0", W, H, rice_cfg), rgb, card, 8)
    del rgb

    # 9. yuv422p10 SD: two shape banks
    with Phase(9):
        cfg = FFV1Config(level=3, coder=1, slices=24, slicecrc=1)

        def two_banks(enc):
            shapes = sorted((b.crop_plan[0][0][2], b.crop_plan[0][0][3])
                            for b in enc.banks)
            log(f"phase 9: yuv422p10 {SD[0]}x{SD[1]}: {len(shapes)} shape "
                f"banks, luma slice rects {shapes}")
            if len(shapes) != 2:
                raise AssertionError(f"expected two banks, got {shapes}")

        launches["sd banks"] = drive(
            "sd banks", device_encoder("yuv422p10", *SD, cfg),
            synth_sd_frames(N_NEW, *SD), card, 9, check=two_banks)

    # 10.-11. the hybrid lane-coder encoder: range (with pass-1
    # statistics) and Golomb-Rice
    from ffmpeg_ffv2_tpu_torch.ffv1 import headers, twopass
    from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu_torch.ffv1.params import params_from_config
    from ffmpeg_ffv2_tpu_torch.ffv1.tpu_coder import TPUCoderFFV1Encoder
    from ffmpeg_ffv2_tpu_torch.ffv1.tpu_encoder import TPUFFV1Encoder

    def once_a_frame(label, n):
        if launches[label]["rac_lanes"] != n:
            raise AssertionError(f"{label}: K7 launched "
                                 f"{launches[label]['rac_lanes']} times over "
                                 f"{n} frames, not once a frame")

    with Phase(10):
        lanes_checks(kernels, TPUCoderFFV1Encoder(W, H, "yuv420p", range_cfg),
                     frames[0], clock_mhz, cycles)
        enc = TPUCoderFFV1Encoder(W, H, "yuv420p", range_cfg)
        enc.set_stats_mode(True)
        nat = NativeFFV1Codec(enc.p)
        nat.enable_stats()
        launches["hybrid range"] = drive("hybrid range", enc, frames[:N_NEW],
                                         card, 10, nat=nat)
        once_a_frame("hybrid range", N_NEW)
        stats = twopass.collect_stats(enc.native)
        ref = twopass.collect_stats(nat)
        if stats[2] != ref[2] or not all(np.array_equal(a, b) for a, b in
                                         zip(stats[:2], ref[:2])):
            raise AssertionError("hybrid range: pass-1 statistics differ "
                                 "from the native session's")
        log(f"phase 10: pass-1 statistics equal the native session's: "
            f"{int(stats[0].sum())} state tallies, gob count {stats[2]}")
        stats_text = twopass.stats_to_text(enc.p, *stats)
        del enc, nat
    with Phase(11):
        rice_lanes_checks(kernels,
                          TPUCoderFFV1Encoder(W, H, "yuv420p", rice_cfg),
                          frames[0], clock_mhz, cycles)
        launches["hybrid rice"] = drive(
            "hybrid rice", TPUCoderFFV1Encoder(W, H, "yuv420p", rice_cfg),
            frames[:N_NEW], card, 11)
        once_a_frame("hybrid rice", N_NEW)

    # 12. the hybrid phase-A encoder: yuv420p range, bgr0 rice (fixed RCT)
    with Phase(12):
        launches["phase-A yuv"] = drive(
            "phase-A yuv", TPUFFV1Encoder(W, H, "yuv420p", range_cfg),
            frames[:N_NEW], card, 12)
        launches["phase-A bgr0"] = drive(
            "phase-A bgr0", TPUFFV1Encoder(W, H, "bgr0", rice_cfg),
            synth_rgb_frames(2, W, H), card, 12)

    # 13. the 2-pass flow: pass-2 parameters from phase 10's statistics
    # through the device encoder (K1-K4)
    with Phase(13):
        p2 = twopass.apply_pass2(params_from_config(range_cfg, "yuv420p",
                                                    W, H), stats_text)
        enc = device_encoder("yuv420p", W, H, range_cfg, params=p2)
        if enc.extradata != headers.write_extradata(p2):
            raise AssertionError("2-pass: extradata differs")
        moved = int((p2.initial_states[p2.context_model] != 128).sum())
        p1 = params_from_config(range_cfg, "yuv420p", W, H)
        sorted_ = int((p2.state_transition != p1.state_transition).sum())
        log(f"phase 13: pass 2: {moved} initial states differ from 128, "
            f"{sorted_} transition-table entries moved by the sort")
        if not moved:
            raise AssertionError("2-pass: no initial state moved")
        launches["2-pass"] = drive("2-pass", enc, frames[:2], card, 13)
        del enc

    # 14. the sort op (K8, K9) and the tool kernels (K10-K17)
    with Phase(14):
        launches["sort op / tools"] = sort_tools_checks(kernels, card)

    # 15. Golomb-Rice at coding depth 16: phase 4's frames in 16 bits
    with Phase(15):
        launches["rice16"] = deep_rice_checks(kernels, frames[:2], rice_cfg,
                                              clock_mhz, cycles, card)

    # 16. the all-intra batch at B = 1, 4, 8 (K1-K4 on up to 240 slices)
    with Phase(16):
        launches["batch"], batch = batch_checks(kernels, frames, range_cfg,
                                                clock_mhz, cycles, card)

    # 17. the device conversions, then the capture path into encode_batch
    with Phase(17):
        launches["capture"], conversions = conversion_checks(
            frames, range_cfg, card)

    # 18. FFV2: K18, K19, the transforms, then its main path
    with Phase(18):
        launches["ffv2"], ffv2 = ffv2_checks(kernels, card,
                                             clock_mhz=clock_mhz,
                                             cycles=cycles)

    # 19. the sharded encoders: worlds of ranks sharing this card
    with Phase(19):
        by_path, parallel = parallel_checks(frames, card)
        launches.update(by_path)

    # 20. the CLI on the card: FFV1, FFV2 and --mesh 2x2
    with Phase(20):
        launches["cli"], cli = cli_checks(frames, card)
        launches["cli ffv2"], cli["ffv2"] = cli_ffv2_checks(card)
        by_path, cli["mesh"] = cli_mesh_checks(frames, card)
        launches.update(by_path)

    # 21. the graft twin: entry() and dryrun_multichip(4)
    with Phase(21):
        launches["graft dryrun"], graft = graft_checks(card)

    for k in kernels.values():
        k["launches"] = launches[k["path"]][k["kernel"]]
        k["launches_by_path"] = {label: launches[label][k["kernel"]]
                                 for label in launches}
    kernels["phase_a"]["at_rice"] = kernels.pop("phase_a_rice")
    order = ["phase_a", "place", "place_pb16", "adapt", "adapt_rgb48",
             "adapt_emission", "emission_pack", "expand", "rac_render",
             "rac_render_batch", "vlc", "vlc_pb16", "vlc_bgr0", "ladder",
             "ladder_pb16", "rac_lanes",
             "rac_lanes_rice", "sort",
             "rowsort", "roll", "rowcx", "transpose", "probe_scalar_extract",
             "probe_scalar_in_ds", "probe_big_prefetch", "probe_roll_dynamic",
             "probe_taa_rows", "pvq", "lap_pre", "lap_post"]
    print(json.dumps({"kernels": [kernels[n] for n in order],
                      "batch": batch, "conversions": conversions,
                      "ffv2": ffv2, "parallel": parallel, "cli": cli,
                      "graft": graft}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
