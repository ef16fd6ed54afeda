"""The port's copies of the CLI's host modules equal their originals in the
JAX package: the bit I/O, the PSNR line and metrics, the packing and
scaling helpers, ``VideoFrame``, the containers (AVI, Matroska, NUT,
rawvideo), the Python FFV1 codec, the header readers, the runtime's
frame-pipelined decode and damaged-slice query, and
``BatchedFFV1Decoder``.  Each case feeds both packages the same inputs,
made from a seed with numpy, and compares bytes or arrays exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from ffmpeg_ffv2_tpu.coder import bitio as jbitio
from ffmpeg_ffv2_tpu.container import avi as javi
from ffmpeg_ffv2_tpu.container import matroska as jmkv
from ffmpeg_ffv2_tpu.container import nut as jnut
from ffmpeg_ffv2_tpu.container import rawvideo as jraw
from ffmpeg_ffv2_tpu.convert import packing as jpacking
from ffmpeg_ffv2_tpu.convert import scale as jscale
from ffmpeg_ffv2_tpu.core.frame import VideoFrame as JFrame
from ffmpeg_ffv2_tpu.ffv1 import FFV1Decoder as JDecoder
from ffmpeg_ffv2_tpu.ffv1 import FFV1Encoder as JEncoder
from ffmpeg_ffv2_tpu.ffv1 import headers as JH
from ffmpeg_ffv2_tpu.ffv1.batched import BatchedFFV1Decoder as JBatched
from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec as JNative
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config as JConfig
from ffmpeg_ffv2_tpu.ffv1.params import params_from_config as jparams
from ffmpeg_ffv2_tpu.utils import metrics as jmetrics
from ffmpeg_ffv2_tpu.utils import psnr as jpsnr
from ffmpeg_ffv2_tpu_torch import container as tcontainer
from ffmpeg_ffv2_tpu_torch.cli.main import _plane_shapes
from ffmpeg_ffv2_tpu_torch.coder import bitio as tbitio
from ffmpeg_ffv2_tpu_torch.container import avi as tavi
from ffmpeg_ffv2_tpu_torch.container import matroska as tmkv
from ffmpeg_ffv2_tpu_torch.container import nut as tnut
from ffmpeg_ffv2_tpu_torch.container import rawvideo as traw
from ffmpeg_ffv2_tpu_torch.convert import packing as tpacking
from ffmpeg_ffv2_tpu_torch.convert import scale as tscale
from ffmpeg_ffv2_tpu_torch.core.frame import VideoFrame as TFrame
from ffmpeg_ffv2_tpu_torch.core.pixfmt import get_pix_fmt
from ffmpeg_ffv2_tpu_torch.ffv1 import FFV1Decoder as TDecoder
from ffmpeg_ffv2_tpu_torch.ffv1 import FFV1Encoder as TEncoder
from ffmpeg_ffv2_tpu_torch.ffv1 import headers as TH
from ffmpeg_ffv2_tpu_torch.ffv1.batched import BatchedFFV1Decoder as TBatched
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec as TNative
from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config as TConfig
from ffmpeg_ffv2_tpu_torch.ffv1.params import params_from_config as tparams
from ffmpeg_ffv2_tpu_torch.utils import metrics as tmetrics
from ffmpeg_ffv2_tpu_torch.utils import psnr as tpsnr
from test_torch_formats import torch_one_thread  # noqa: F401

W, H = 64, 48


def _same_params(tp, jp):
    """Every field of the port's FFV1Params equals the original's."""
    for f in dataclasses.fields(jp):
        a, b = getattr(tp, f.name), getattr(jp, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            np.testing.assert_equal(a, b, f.name)


def _frames(pix, n, seed, w=W, h=H):
    """n frames of pix at w x h: a gradient that moves and noise, so that
    inter frames differ from key frames."""
    rng = np.random.RandomState(seed)
    fmt = get_pix_fmt(pix)
    mx = (1 << fmt.bits) - 1
    out = []
    for t in range(n):
        planes = []
        for ph, pw in _plane_shapes(fmt, w, h):
            g = (np.indices((ph, pw)).sum(0) * 3 + 5 * t) % (mx + 1)
            planes.append(np.clip(g + rng.randint(-4, 5, (ph, pw)), 0, mx))
        out.append(planes)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_bitio_round_trip(seed):
    """Random (width, value) writes give the same bytes in both writers,
    and the port's reader reads them back as the original's does."""
    rng = np.random.RandomState(seed)
    fields = [(int(n), int(rng.randint(0, 1 << n)) if n else 0)
              for n in rng.randint(0, 25, 400)]
    jw, tw = jbitio.BitWriter(), tbitio.BitWriter()
    for n, v in fields:
        jw.put(n, v)
        tw.put(n, v)
    assert tw.bit_count() == jw.bit_count()
    data = tw.flush()
    assert data == jw.flush()
    jr, tr = jbitio.BitReader(data), tbitio.BitReader(data)
    for n, v in fields:
        assert tr.peek(n) == jr.peek(n)
        got = tr.get(n)
        assert got == jr.get(n) == v
        assert tr.bits_left() == jr.bits_left()


@pytest.mark.parametrize("n, seed", [(0, 0), (1, 1), (4096, 2), (13824, 3)])
def test_torch_psnr_line_and_metrics(n, seed):
    """tiny_psnr's line and psnr_u8 on random buffers (equal, and one a
    few bytes off); FrameStats and the slice walk of a real packet."""
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 256, n).astype(np.uint8).tobytes()
    b = bytearray(a)
    for i in rng.randint(0, max(n, 1), min(n, 7)):
        b[i] ^= 0x5A
    for x, y in ((a, a), (a, bytes(b))):
        assert tpsnr.tiny_psnr_line(x, y) == jpsnr.tiny_psnr_line(x, y)
        assert tpsnr.psnr_u8(x, y) == jpsnr.psnr_u8(x, y)
    cfg = dict(level=3, coder=1, slices=4, slicecrc=1)
    p = jparams(JConfig(**cfg), "yuv420p", W, H)
    codec = JNative(p)
    js, ts = jmetrics.FrameStats(), tmetrics.FrameStats()
    for t, planes in enumerate(_frames("yuv420p", 3, seed)):
        pkt = codec.encode(planes, t == 0)
        regions = tmetrics.packet_slice_sizes(pkt, True, 3)
        assert regions == jmetrics.packet_slice_sizes(pkt, True, 3)
        sizes = [ln for _, ln, _ in regions]
        js.add_frame(W * H, pkt, t == 0, sizes)
        ts.add_frame(W * H, pkt, t == 0, sizes)
    assert ts.report() == js.report()
    stat2 = rng.randint(0, 50, (2, 40, 32, 2)).astype(np.uint64)
    assert (tmetrics.context_occupancy(stat2)
            == jmetrics.context_occupancy(stat2))


def test_torch_packing_and_scale():
    """The packed RGB layouts both ways and swscale's neighbour
    conversions give the same arrays and bytes."""
    rng = np.random.RandomState(4)
    w, h = 36, 22
    data32 = rng.randint(0, 256, 4 * w * h).astype(np.uint8).tobytes()
    data48 = rng.randint(0, 256, 6 * w * h).astype(np.uint8).tobytes()
    for name, data in (("bgr0", data32), ("rgb32", data32),
                       ("rgb48", data48)):
        jp = getattr(jpacking, "unpack_" + name)(data, w, h)
        tp = getattr(tpacking, "unpack_" + name)(data, w, h)
        for x, y in zip(tp, jp):
            np.testing.assert_array_equal(x, y)
        assert (getattr(tpacking, "pack_" + name)(tp)
                == getattr(jpacking, "pack_" + name)(jp))
    assert tpacking.pack_bgr0(jp[:3], 7) == jpacking.pack_bgr0(jp[:3], 7)
    y = rng.randint(0, 256, (h, w))
    u = rng.randint(0, 256, (h // 2, w // 2))
    v = rng.randint(0, 256, (h // 2, w // 2))
    y10 = rng.randint(0, 1024, (h, w))
    u10 = rng.randint(0, 1024, (h, w // 2))
    y16 = rng.randint(0, 65536, (h, w))
    for fn, args in (("yuv420p_to_yuv422p10_neighbor", (y, u, v)),
                     ("yuv420p_to_yuv444p16_neighbor", (y, u, v)),
                     ("yuv422p10_to_yuv420p_neighbor", (y10, u10, u10)),
                     ("yuv444p16_to_yuv420p_neighbor", (y16, y16, y16))):
        for x, z in zip(getattr(tscale, fn)(*args),
                        getattr(jscale, fn)(*args)):
            np.testing.assert_array_equal(x, z)


@pytest.mark.parametrize("pix", ["yuv420p", "yuv422p10", "gbrp", "gray"])
def test_torch_video_frame(pix):
    """from_bytes, to_bytes and alloc equal the original's; to_device
    ("cpu") holds each plane as a torch tensor, to_host gives numpy back,
    and the bytes do not change on the way."""
    jf = JFrame.alloc(pix, 35, 21)
    n = sum(p.size for p in jf.planes) * (1 if jf.pix_fmt.bits <= 8 else 2)
    data = np.random.RandomState(5).randint(0, 256, n).astype(
        np.uint8).tobytes()
    if jf.pix_fmt.bits > 8:        # keep the 16-bit words in range
        words = np.frombuffer(data, "<u2") & ((1 << jf.pix_fmt.bits) - 1)
        data = words.astype("<u2").tobytes()
    jf = JFrame.from_bytes(data, pix, 35, 21)
    tf = TFrame.from_bytes(data, pix, 35, 21)
    assert tf.pix_fmt.name == jf.pix_fmt.name and tf.to_bytes() == data
    for x, y in zip(tf.planes, jf.planes):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    for x, y in zip(TFrame.alloc(pix, 35, 21).planes,
                    JFrame.alloc(pix, 35, 21).planes):
        assert x.shape == y.shape and x.dtype == y.dtype
    tf.to_device("cpu")
    assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu"
               for p in tf.planes)
    assert tf.to_bytes() == data
    tf.to_host()
    assert all(isinstance(p, np.ndarray) for p in tf.planes)
    assert tf.to_bytes() == jf.to_bytes() == data


def _packets(seed, n=5):
    rng = np.random.RandomState(seed)
    return ([rng.randint(0, 256, rng.randint(1, 400)).astype(
        np.uint8).tobytes() for _ in range(n)],
        [t % 3 == 0 for t in range(n)])


@pytest.mark.parametrize("fourcc, extradata", [
    ("FFV1", b""), ("FFV1", bytes(range(41))), ("FFV2", bytes(range(42)))])
def test_torch_containers_write_and_read(tmp_path, fourcc, extradata):
    """The AVI, Matroska and NUT writers give the same bytes for the same
    packets (odd and even extradata), and each of the port's readers
    reads the original's file to the same packets, key flags and
    metadata."""
    pkts, keys = _packets(len(extradata))
    cases = ((javi.AviWriter, tavi.AviWriter, fourcc, "getvalue"),
             (jmkv.MatroskaWriter, tmkv.MatroskaWriter, "V_" + fourcc,
              "tobytes"),
             (jnut.NutWriter, tnut.NutWriter, fourcc, "tobytes"))
    for JW, TW, tag, out in cases:
        jw, tw = (Wr(W, H, tag, (25, 1), extradata) for Wr in (JW, TW))
        for p, k in zip(pkts, keys):
            jw.write_packet(p, keyframe=k)
            tw.write_packet(p, keyframe=k)
        data = getattr(jw, out)()
        assert getattr(tw, out)() == data, JW.__name__
        path = tmp_path / f"t_{JW.__name__}"
        tw.save(str(path))
        assert path.read_bytes() == data
    avi = javi.AviWriter(W, H, fourcc, (25, 1), extradata)
    mkv = jmkv.MatroskaWriter(W, H, "V_" + fourcc, (25, 1), extradata)
    nut = jnut.NutWriter(W, H, fourcc, (25, 1), extradata)
    for w_ in (avi, mkv, nut):
        for p, k in zip(pkts, keys):
            w_.write_packet(p, keyframe=k)
    for JR, TR, data in ((javi.AviReader, tcontainer.AviReader,
                          avi.getvalue()),
                         (jmkv.MatroskaReader, tcontainer.MatroskaReader,
                          mkv.tobytes()),
                         (jnut.NutReader, tnut.NutReader, nut.tobytes())):
        js, ts = JR(data).video, TR(data).video
        assert ts.packets == js.packets == pkts
        assert (ts.width, ts.height) == (js.width, js.height) == (W, H)
        assert ts.extradata == js.extradata == extradata
        for k in ("keyflags", "fcc_handler", "codec_id", "fourcc"):
            assert getattr(ts, k, None) == getattr(js, k, None), k
    jr, tr = javi.AviReader(avi.getvalue()), tavi.AviReader(avi.getvalue())
    assert ([tr.keyframe_before(i) for i in range(len(pkts))]
            == [jr.keyframe_before(i) for i in range(len(pkts))])


def test_torch_rawvideo(tmp_path):
    """RawVideoWriter's file equals the original's, and both readers give
    the same frames."""
    frames = _frames("yuv420p", 3, 6)
    jpath, tpath = tmp_path / "j.yuv", tmp_path / "t.yuv"
    jw, tw = jraw.RawVideoWriter(str(jpath)), traw.RawVideoWriter(str(tpath))
    for planes in frames:
        jw.write(JFrame(planes, JFrame.alloc("yuv420p", W, H).pix_fmt, W, H))
        tw.write(TFrame(planes, TFrame.alloc("yuv420p", W, H).pix_fmt, W, H))
    jw.close()
    tw.close()
    assert tpath.read_bytes() == jpath.read_bytes()
    got = list(tcontainer.RawVideoReader(str(jpath), "yuv420p", W, H))
    want = list(jraw.RawVideoReader(str(jpath), "yuv420p", W, H))
    assert len(got) == len(want) == 3
    for g, w_ in zip(got, want):
        assert g.to_bytes() == w_.to_bytes()


CODEC_CASES = [
    ("yuv420p", dict(level=1, coder=0)),
    ("yuv420p", dict(level=3, coder=1, slices=4)),
    ("yuv420p", dict(level=3, coder=0, slices=4, context=1)),
    ("yuv422p10", dict(level=3, coder=1, slices=4)),
    ("gbrp", dict(level=3, coder=0, slices=4)),
    ("bgr0", dict(level=4, coder=1, slices=4)),
]


@pytest.mark.parametrize("pix, cfg", CODEC_CASES)
def test_torch_python_codec_matches_original(pix, cfg):
    """The Python codec's packets and extradata equal the original's; the
    port's FFV1Decoder (with the extradata, and without it where the
    version carries its headers in-band) decodes them back, and its
    read_extradata gives the original's params.  At Golomb-Rice with
    context model 1 both Python decoders raise (a fault of the original,
    kept), and the native codec decodes the packets."""
    frames = _frames(pix, 3, 7, 32, 24)
    je = JEncoder(32, 24, pix, JConfig(gop_size=2, **cfg))
    te = TEncoder(32, 24, pix, TConfig(gop_size=2, **cfg))
    assert te.extradata == je.extradata
    pkts = []
    for planes in frames:
        pkt = te.encode(planes)
        assert pkt == je.encode(planes)
        pkts.append(pkt)
    if te.extradata:
        _same_params(TH.read_extradata(te.extradata, 32, 24),
                     JH.read_extradata(je.extradata, 32, 24))
    if cfg["coder"] == 0 and cfg.get("context") == 1 and te.extradata:
        # a fault of the original (ROADMAP.md section 3): the extradata
        # carries no context model, so the decoder sizes each slice's VLC
        # states for table 0 (666 contexts) while the slice header picks
        # table 1 (7563); the copy keeps it, the native codec decodes
        for Dec in (TDecoder, JDecoder):
            with pytest.raises(IndexError):
                Dec(32, 24, te.extradata).decode(pkts[0])
        dec = TNative(te.p)
        for pkt, planes in zip(pkts, frames):
            for g, x in zip(dec.decode(pkt), planes):
                np.testing.assert_array_equal(g, x)
        return
    decs = [TDecoder(32, 24, te.extradata)]
    if te.p.version < 2:
        decs.append(TDecoder(32, 24))
    for dec in decs:
        jdec = JDecoder(32, 24, je.extradata)
        for pkt, planes in zip(pkts, frames):
            got = dec.decode(pkt)
            want = jdec.decode(pkt)
            for g, w_, x in zip(got, want, planes):
                np.testing.assert_array_equal(g, w_)
                np.testing.assert_array_equal(g, x)
        assert dec.pix_fmt.name == jdec.pix_fmt.name


@pytest.mark.parametrize("pix, cfg", [
    ("yuv420p", dict(level=3, coder=1, slices=4)),
    ("yuv420p", dict(level=3, coder=0, slices=6)),
    ("yuva420p", dict(level=3, coder=1, slices=4)),
    ("yuv420p", dict(level=1, coder=0)),
])
def test_torch_decode_pipelined_and_batched(pix, cfg):
    """decode_pipelined and BatchedFFV1Decoder (pipeline and GOP modes)
    of the runtime's copy equal the original's on a stream of key and
    inter frames, and the input; a damaged slice is concealed alike and
    slice_damaged names it."""
    frames = _frames(pix, 6, 8)
    jp = jparams(JConfig(gop_size=3, **cfg), pix, W, H)
    tp = tparams(TConfig(gop_size=3, **cfg), pix, W, H)
    enc = JNative(jp)
    pkts = [enc.encode(pl, t % 3 == 0) for t, pl in enumerate(frames)]
    keys = [t % 3 == 0 for t in range(len(pkts))]
    got = TNative(tp).decode_pipelined(pkts)
    want = JNative(jp).decode_pipelined(pkts)
    for g, w_, x in zip(got, want, frames):
        for a, b, c in zip(g, w_, x):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    for mode in ("pipeline", "gop"):
        tb = TBatched(tp, n_workers=3, mode=mode).decode_all(pkts, keys)
        jb = JBatched(jp, n_workers=3, mode=mode).decode_all(pkts, keys)
        for g, w_ in zip(tb, jb):
            for a, b in zip(g, w_):
                np.testing.assert_array_equal(a, b)
    if tp.version < 3:
        return
    bad = list(pkts)
    b = bytearray(bad[1])
    b[len(b) // 3] ^= 0xFF
    bad[1] = bytes(b)
    tdec, jdec = TNative(tp), JNative(jp)
    for pkt in bad[:2]:
        g, w_ = tdec.decode(pkt), jdec.decode(pkt)
        for a, c in zip(g, w_):
            np.testing.assert_array_equal(a, c)
    flags = [tdec.slice_damaged(i) for i in range(tp.slice_count)]
    assert flags == [jdec.slice_damaged(i) for i in range(jp.slice_count)]
    assert any(flags)
    tq, jq = TNative(tp), JNative(jp)
    for g, w_ in zip(tq.decode_pipelined(bad), jq.decode_pipelined(bad)):
        for a, c in zip(g, w_):
            np.testing.assert_array_equal(a, c)
    assert tq.last_status == jq.last_status and tq.last_status[1] == 1
