"""Copy of ``ffmpeg_ffv2_tpu/cli/main.py`` on the port's modules.
``encode``, ``decode`` and ``transcode`` run on the card by default
(``-device cuda``): FFV1 on ``--backend device`` (``DeviceFFV1Encoder``),
FFV2 on ``NativeFFV2Encoder`` and ``NativeFFV2Decoder`` (and, with
``-workers N > 1``, ``PipelinedFFV2Encoder``), ``--mesh DxS`` on a world of
D x S ranks (``cli/mesh.py``).  The ``tpu`` backend (``TPUFFV1Encoder``)
also takes ``-device``; ``-device cpu`` runs all of them on their plain
versions, the counterpart of the original honouring
``JAX_PLATFORMS=cpu``, and there is no fallback from one device to the
other.  ``native`` (the C++ codec on the host) and ``python`` stay for
what the device path refuses.  The default backend is ``device`` (the
original's is ``native``); the original's compile-cache set-up has no
counterpart.

ffv — the framework CLI (the fftools/ffmpeg counterpart).

Subcommands:
  encode     raw video -> FFV1/FFV2 in AVI/Matroska/NUT (by extension)
  decode     AVI/Matroska/NUT (FFV1/FFV2) -> raw video (by magic)
  transcode  raw -> encode -> decode -> raw (sanity pipeline)
  psnr       compare two raw files (tiny_psnr-compatible line)
  info       show container/codec parameters

Option names mirror the ffmpeg CLI where they exist there (-s, -pix_fmt,
-level, -slices, -coder, -context, -slicecrc, -g, -global_quality;
ffv1enc.c:1291-1307, ffv2enc.c:583).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..core.pixfmt import get_pix_fmt
from ..container.avi import AviReader, AviWriter
from ..utils.metrics import FrameStats, StageTrace, packet_slice_sizes
from ..utils.psnr import tiny_psnr_line


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def _plane_shapes(fmt, w, h):
    shapes = []
    if fmt.colorspace == 0:
        shapes.append((h, w))
        if fmt.chroma_planes:
            cw = -(-w >> fmt.chroma_h_shift)
            ch = -(-h >> fmt.chroma_v_shift)
            shapes += [(ch, cw), (ch, cw)]
        if fmt.transparency:
            shapes.append((h, w))
    else:
        shapes = [(h, w)] * (3 + fmt.transparency)
    return shapes


def read_raw_frames(path, fmt, w, h):
    dt = np.dtype(np.uint8 if fmt.bits <= 8 else "<u2")
    if fmt.name == "ya8":   # rawvideo ya8 is Y/A interleaved
        data = open(path, "rb").read()
        n = len(data) // (2 * w * h)
        arr = np.frombuffer(data, np.uint8, 2 * w * h * n).reshape(
            n, h, w, 2).astype(np.int64)
        return [[arr[i, :, :, 0], arr[i, :, :, 1]] for i in range(n)]
    shapes = _plane_shapes(fmt, w, h)
    frame_bytes = sum(s[0] * s[1] for s in shapes) * dt.itemsize
    data = open(path, "rb").read()
    n = len(data) // frame_bytes
    frames = []
    off = 0
    for _ in range(n):
        planes = []
        for s in shapes:
            cnt = s[0] * s[1]
            planes.append(np.frombuffer(data, dt, cnt, off)
                          .reshape(s).astype(np.int64))
            off += cnt * dt.itemsize
        frames.append(planes)
    return frames


def write_raw_frames(path, frames, bits, fmt=None):
    dt = np.uint8 if bits <= 8 else np.dtype("<u2")
    with open(path, "wb") as f:
        for planes in frames:
            if fmt is not None and fmt.name == "ya8":
                ya = np.stack([np.asarray(p) for p in planes], axis=-1)
                f.write(ya.astype(np.uint8).tobytes())
                continue
            for p in planes:
                f.write(np.asarray(p).astype(dt).tobytes())


def _coder_value(name):
    return {"rice": 0, "range_def": -2, "range_tab": 2, "ac": 1,
            "0": 0, "1": 1, "2": 2, "-2": -2}[name]


def make_ffv1_encoder(args, w, h, backend):
    from ..ffv1.params import FFV1Config
    cfg = FFV1Config(level=args.level, coder=_coder_value(args.coder),
                     context=args.context, slices=args.slices,
                     slicecrc=args.slicecrc, gop_size=args.g)
    if backend == "python":
        from ..ffv1 import FFV1Encoder
        return FFV1Encoder(w, h, args.pix_fmt, cfg)
    if backend == "tpu":
        from ..ffv1.tpu_encoder import TPUFFV1Encoder
        return TPUFFV1Encoder(w, h, args.pix_fmt, cfg, device=args.device)
    if backend == "device":
        # the fully on-device pipeline (phase A + adaptation + arithmetic
        # coding on the card); constraints raise with clear messages
        from ..ffv1.device_coder import DeviceFFV1Encoder
        return DeviceFFV1Encoder(w, h, args.pix_fmt, cfg,
                                 device=args.device)
    from ..ffv1.params import params_from_config
    from ..ffv1.native import NativeFFV1Codec
    from ..ffv1 import headers as H

    class _NativeSession:
        def __init__(self):
            self.p = params_from_config(cfg, args.pix_fmt, w, h)
            self.cfg = cfg
            self.native = NativeFFV1Codec(self.p)
            self.extradata = (H.write_extradata(self.p)
                              if self.p.version > 1 else b"")
            self.n = 0

        def encode(self, planes):
            key = cfg.gop_size == 0 or self.n % cfg.gop_size == 0
            self.n += 1
            return self.native.encode(planes, key)

    return _NativeSession()


def _encode_stream_mesh(args, w, h, frames):
    """GOP-parallel sharded encode over a ("data", "slice") mesh of ranks
    (--mesh DxS, ``mesh.encode_mesh``); packets come back in stream order,
    byte-identical to the single-session encoder.  Returns (packets, a
    stand-in for the encoder with its ``p`` and ``extradata``).  Exits
    non-zero for a mesh the frame's slices do not allow.  The transport
    and the ranks' launch counts go to stderr."""
    from types import SimpleNamespace
    from ..ffv1.params import FFV1Config
    from .mesh import encode_mesh
    cfg = FFV1Config(level=args.level, coder=_coder_value(args.coder),
                     context=args.context, slices=args.slices,
                     slicecrc=args.slicecrc, gop_size=args.g)
    try:
        pkts, extradata, p, transport, ranks = encode_mesh(
            args.mesh, cfg, args.pix_fmt, w, h, frames, args.device)
    except ValueError as e:
        sys.exit(f"--mesh {args.mesh}: {e}")
    print(f"--mesh {args.mesh}: {len(ranks)} ranks on {transport} "
          f"(-device {args.device})", file=sys.stderr)
    # each rank's steps' ms, its set-up and start, its kernels' launch and
    # plain-call counts
    print("--mesh ranks: " + json.dumps(ranks), file=sys.stderr)
    return pkts, SimpleNamespace(p=p, extradata=extradata)


def cmd_encode_twopass(args, w, h, frames):
    """-pass 1 collects stats to the log file; -pass 2 reads them and
    encodes with optimized initial states (ffv1enc.c 2-pass flow)."""
    from ..ffv1.params import FFV1Config, params_from_config
    from ..ffv1.native import NativeFFV1Codec
    from ..ffv1 import twopass, headers as Hdr
    cfg = FFV1Config(level=max(args.level, 2) if args.level >= 0 else 3,
                     coder=_coder_value(args.coder), context=args.context,
                     slices=args.slices, slicecrc=args.slicecrc,
                     gop_size=args.g)
    p = params_from_config(cfg, args.pix_fmt, w, h)
    log = args.passlogfile + "-0.log"
    if args.pass_num == 2:
        p = twopass.apply_pass2(p, open(log).read())
    enc = NativeFFV1Codec(p)
    if args.pass_num == 1:
        enc.enable_stats()
    extradata = Hdr.write_extradata(p)
    avi = AviWriter(w, h, "FFV1", (25, 1), extradata)
    for t, planes in enumerate(frames):
        key = args.g == 0 or t % args.g == 0
        avi.write_packet(enc.encode(planes, key), key)
    avi.save(args.output)
    if args.pass_num == 1:
        rc, rc2, gob = twopass.collect_stats(enc)
        with open(log, "w") as f:
            f.write(twopass.stats_to_text(p, rc, rc2, gob))
        print(f"pass 1: stats -> {log}")
    print(f"encoded {len(frames)} frames -> {args.output}")


def cmd_encode(args):
    w, h = _parse_size(args.s)
    fmt = get_pix_fmt(args.pix_fmt)
    frames = read_raw_frames(args.input, fmt, w, h)
    if not frames:
        sys.exit("no frames read")

    pre = None
    if args.c == "ffv1":
        if args.pass_num:
            cmd_encode_twopass(args, w, h, frames)
            return
        if getattr(args, "mesh", ""):
            pre, enc = _encode_stream_mesh(args, w, h, frames)
        else:
            enc = make_ffv1_encoder(args, w, h, args.backend)
        fourcc = "FFV1"
    elif args.c == "ffv2":
        from ..ffv2 import FFV2Encoder, FFV2Config
        cfg2 = FFV2Config(qp=args.global_quality,
                          block_size=args.block_size)
        if args.backend == "python":
            enc = FFV2Encoder(w, h, args.pix_fmt, cfg2)
        else:
            from ..ffv2.native import NativeFFV2Encoder
            enc = NativeFFV2Encoder(w, h, args.pix_fmt, cfg2,
                                    device=args.device)
        fourcc = "FFV2"
    else:
        sys.exit(f"unknown codec {args.c}")

    extradata = getattr(enc, "extradata", b"")
    if args.output.lower().endswith((".mkv", ".webm")):
        from ..container import MatroskaWriter
        out = MatroskaWriter(w, h, "V_" + fourcc, (25, 1), extradata)
    elif args.output.lower().endswith(".nut"):
        from ..container.nut import NutWriter
        out = NutWriter(w, h, fourcc, (25, 1), extradata)
    else:
        out = AviWriter(w, h, fourcc, (25, 1), extradata)
    gop = args.g if args.c == "ffv1" else 1
    nbytes = 0
    vstats = open(args.vstats, "w") if args.vstats else None
    stats = FrameStats() if vstats else None
    p_enc = getattr(enc, "p", None)         # FFV1Params (slice trailers)
    trace = None
    if vstats and hasattr(enc, "trace"):
        # a device session: its stages, on a recorder of this run's own
        trace = enc.trace = StageTrace()
    if (args.c == "ffv2" and getattr(args, "workers", 1) > 1
            and args.backend != "python"):
        # frame-pipelined Daala EC: frame t's C++ coder overlaps frame
        # t+1's front on worker threads; packets byte-identical
        from ..ffv2.native import PipelinedFFV2Encoder
        pipe = PipelinedFFV2Encoder(w, h, args.pix_fmt, enc.cfg,
                                    depth=args.workers, device=args.device)
        try:
            pre = pipe.encode_stream(frames)
        finally:
            pipe.close()
    for t, planes in enumerate(frames):
        pkt = pre[t] if pre is not None else enc.encode(planes)
        key = (gop == 0 or t % gop == 0)
        out.write_packet(pkt, keyframe=key)
        nbytes += len(pkt)
        if vstats:
            slice_sz = None
            if p_enc is not None and p_enc.version >= 3:
                regions = packet_slice_sizes(pkt, bool(p_enc.ec),
                                             p_enc.version)
                slice_sz = [ln for (_, ln, _) in regions]
            stats.add_frame(w * h, pkt, key, slice_sz)
            rec = {"frame": t, "key": int(key), "bytes": len(pkt),
                   "bpp": round(8 * len(pkt) / (w * h), 4)}
            if slice_sz is not None:
                rec["slices"] = slice_sz
                # only claim CRC verification when CRCs exist (ec on);
                # null means "no CRCs present in the packet"
                rec["crc_ok"] = (
                    all(ok for (_, _, ok) in regions if ok is not None)
                    if p_enc.ec else None)
            if trace is not None:
                rec["stages_ms"] = {k: round(v, 4) for k, v in
                                    trace.last().stage_ms().items()}
            vstats.write(json.dumps(rec) + "\n")
    if vstats:
        line = {"summary": stats.report()}
        if trace is not None:
            line["stages"] = {k: {"ms": round(v * 1e3, 4),
                                  "count": trace.counts[k]}
                              for k, v in trace.totals.items()}
        vstats.write(json.dumps(line) + "\n")
        vstats.close()
    out.save(args.output)
    print(f"encoded {len(frames)} frames -> {args.output} "
          f"({nbytes} packet bytes)")


def cmd_decode(args):
    data = open(args.input, "rb").read()
    if data[:4] == b"\x1a\x45\xdf\xa3":           # EBML -> Matroska
        from ..container import MatroskaReader
        st = MatroskaReader(data).video
        fourcc = st.codec_id[2:].strip("\x00 ").upper()
    elif data[:4] == b"nut/":
        from ..container.nut import NutReader
        st = NutReader(data).video
        fourcc = st.fourcc.strip("\x00 ").upper()
    else:
        avi = AviReader(data)
        st = avi.video
        fourcc = st.fcc_handler.strip("\x00 ").upper()
    frames = []
    if fourcc == "FFV1":
        from ..ffv1.params import FFV1Config
        from ..ffv1 import headers as Hdr
        from ..ffv1.native import NativeFFV1Codec
        from ..ffv1 import FFV1Decoder
        if st.extradata:
            p = Hdr.read_extradata(st.extradata, st.width, st.height)
            workers = getattr(args, "workers", 1)
            keyflags = getattr(st, "keyflags", None)
            if workers > 1 and keyflags:
                from ..ffv1.batched import BatchedFFV1Decoder
                bd = BatchedFFV1Decoder(p, n_workers=workers)
                frames = bd.decode_all(st.packets, keyflags)
            else:
                dec = NativeFFV1Codec(p)
                for pkt in st.packets:
                    frames.append(dec.decode(pkt))
            bits, outfmt = p.bits, p.pix_fmt
        else:
            dec = FFV1Decoder(st.width, st.height)
            for pkt in st.packets:
                frames.append(dec.decode(pkt))
            bits, outfmt = dec.p.bits, dec.p.pix_fmt
    elif fourcc == "FFV2":
        from ..ffv2.native import NativeFFV2Decoder
        dec = NativeFFV2Decoder(st.width, st.height, device=args.device)
        for pkt in st.packets:
            frames.append(dec.decode(pkt))
        bits, outfmt = dec.fmt.bits, dec.fmt
    else:
        sys.exit(f"unsupported fourcc {fourcc!r}")
    write_raw_frames(args.output, frames, bits, outfmt)
    print(f"decoded {len(frames)} frames -> {args.output}")


def cmd_psnr(args):
    a = open(args.file_a, "rb").read()
    b = open(args.file_b, "rb").read()
    print(tiny_psnr_line(a, b))


def cmd_transcode(args):
    """raw -> encode -> decode -> raw round trip (keeps the intermediate
    container when -keep points at a path)."""
    import tempfile, os
    container = args.keep or os.path.join(
        tempfile.mkdtemp(prefix="ffvtrans"), "t.avi")
    d = dict(vars(args))
    d["output"] = container
    cmd_encode(argparse.Namespace(**d))
    dec_args = argparse.Namespace(input=container, output=args.output,
                                  device=args.device)
    cmd_decode(dec_args)
    if not args.keep:
        os.remove(container)
        os.rmdir(os.path.dirname(container))


def cmd_info(args):
    data = open(args.input, "rb").read()
    if data[:4] == b"\x1a\x45\xdf\xa3":
        from ..container import MatroskaReader
        st = MatroskaReader(data).video
        print(f"stream: mkv codec={st.codec_id} {st.width}x{st.height} "
              f"packets={len(st.packets)} extradata={len(st.extradata)}B")
        fourcc = st.codec_id[2:].strip("\x00 ").upper()
    else:
        avi = AviReader(data)
        st = avi.video
        print(f"stream: {st.fcc_type} handler={st.fcc_handler!r} "
              f"{st.width}x{st.height} {st.rate}/{st.scale} fps "
              f"packets={len(st.packets)} extradata={len(st.extradata)}B")
        fourcc = st.fcc_handler.strip("\x00 ").upper()
    if fourcc == "FFV1" and st.extradata:
        from ..ffv1 import headers as Hdr
        p = Hdr.read_extradata(st.extradata, st.width, st.height)
        print(f"ffv1: version {p.version}.{p.micro_version} coder={p.ac} "
              f"bits={p.bits} colorspace={p.colorspace} "
              f"chroma={p.chroma_h_shift}:{p.chroma_v_shift} "
              f"slices={p.num_h_slices}x{p.num_v_slices} crc={p.ec} "
              f"intra={p.intra}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ffv",
                                 description="FFV1/FFV2 tool on PyTorch/CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_common_enc(p):
        p.add_argument("-i", dest="input", required=True)
        p.add_argument("-s", required=True, help="WxH")
        p.add_argument("-pix_fmt", default="yuv420p")
        p.add_argument("-c", "-c:v", dest="c", default="ffv1")
        p.add_argument("-level", type=int, default=-1)
        p.add_argument("-slices", type=int, default=0)
        p.add_argument("-coder", default="rice")
        p.add_argument("-context", type=int, default=0)
        p.add_argument("-slicecrc", type=int, default=-1)
        p.add_argument("-g", type=int, default=12)
        p.add_argument("-global_quality", "-qp", dest="global_quality",
                       type=int, default=12)
        p.add_argument("-block_size", type=int, default=64,
                       choices=[0, 4, 8, 16, 32, 64],
                       help="ffv2 leaf block size (<64 emits the split "
                            "tree; 0 = activity-adaptive)")
        p.add_argument("--mesh", default="", metavar="DxS",
                       help="shard the encode over a (data x slice) "
                            "mesh of ranks, e.g. 2x4: GOPs ride the data "
                            "axis, FFV1 slices the slice axis "
                            "(ffv1 only; the encode runs on -device, "
                            "whatever --backend says)")
        p.add_argument("--backend", default="device",
                       choices=["native", "tpu", "device", "python"],
                       help="device (default): the whole encode on the "
                            "card's kernels; tpu: phase A there, the "
                            "native coder on the host; native: the C++ "
                            "codec on the host; python: the Python codec")
        p.add_argument("-device", default="cuda",
                       help="the torch device of the tpu and device "
                            "backends, of FFV2 and of --mesh: cuda (the "
                            "kernels) or cpu (their plain versions)")
        p.add_argument("-pass", dest="pass_num", type=int, default=0,
                       choices=[0, 1, 2])
        p.add_argument("-passlogfile", default="ffv1pass")
        p.add_argument("-workers", type=int, default=1,
                       help="ffv2: frame-pipeline depth (EC on worker "
                            "threads overlapping the device front)")
        p.add_argument("-vstats", default="", metavar="FILE",
                       help="write per-frame stats JSONL (bytes, bpp, "
                            "per-slice sizes from the trailer walk, "
                            "CRC status; a device session's stage ms) + "
                            "a summary line (with each stage's total ms "
                            "and count)")

    pe = sub.add_parser("encode")
    add_common_enc(pe)
    pe.add_argument("-o", dest="output", required=True)
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode")
    pd.add_argument("-i", dest="input", required=True)
    pd.add_argument("-o", dest="output", required=True)
    pd.add_argument("-workers", type=int, default=1,
                    help="GOP-parallel decode pipelines (frame threading)")
    pd.add_argument("-device", default="cuda",
                    help="FFV2 decode's torch device: cuda (the kernels) or "
                         "cpu (their plain versions)")
    pd.set_defaults(fn=cmd_decode)

    pt = sub.add_parser("transcode")
    add_common_enc(pt)
    pt.add_argument("-o", dest="output", required=True)
    pt.add_argument("-keep", default="",
                    help="save the intermediate container here")
    pt.set_defaults(fn=cmd_transcode)

    pp = sub.add_parser("psnr")
    pp.add_argument("file_a")
    pp.add_argument("file_b")
    pp.set_defaults(fn=cmd_psnr)

    pi = sub.add_parser("info")
    pi.add_argument("-i", dest="input", required=True)
    pi.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
