"""The port's FFV2 host copies and native sessions on the CPU, against the
JAX package, exactly (equal integers and equal bytes).

The copies (``ffv2/{tables,dsp,pvq,entropy,osd,codec}.py``, the CGA font,
``native/ffv2_runtime.cpp``) against their originals; then the sessions of
``ffv2/native.py`` with ``device="cpu"`` (the plain versions of K18 and
K19) and their host paths against JAX ``NativeFFV2Encoder`` /
``NativeFFV2Decoder`` and the Python codec, at the cases of
``tests/test_ffv2_native.py``, on split trees, with session reuse and
pipelined.  FFV2 keeps no state between frames: its tables and transform
basis, which the copy tests hold, are all that carries across."""

import filecmp
import os

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.core.pixfmt import get_pix_fmt
from ffmpeg_ffv2_tpu.ffv2 import FFV2Config as JConfig
from ffmpeg_ffv2_tpu.ffv2 import FFV2Decoder as JDecoder
from ffmpeg_ffv2_tpu.ffv2 import FFV2Encoder as JEncoder
from ffmpeg_ffv2_tpu.ffv2 import dsp as jdsp
from ffmpeg_ffv2_tpu.ffv2 import entropy as jent
from ffmpeg_ffv2_tpu.ffv2 import native as jnat
from ffmpeg_ffv2_tpu.ffv2 import osd as josd
from ffmpeg_ffv2_tpu.ffv2 import pvq as jpvq
from ffmpeg_ffv2_tpu.ffv2 import tables as jtables
from ffmpeg_ffv2_tpu.ffv1 import native as jffv1_native
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch import ffv2 as tffv2
from ffmpeg_ffv2_tpu_torch.ffv2 import FFV2Config, FFV2Decoder, FFV2Encoder
from ffmpeg_ffv2_tpu_torch.ffv2 import dsp, entropy, osd, pvq, tables
from ffmpeg_ffv2_tpu_torch.ffv2 import native as tnat
from test_torch_formats import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_ffv2_native.py:24-33
CASES = [
    ("gray", 70, 44, 8, 0),
    ("yuv444p", 96, 96, 12, 1),
    ("yuv444p", 130, 66, 31, 2),
    ("yuv444p10", 64, 64, 16, 3),
    ("yuv444p12", 64, 64, 20, 4),
    ("gbrp", 128, 96, 24, 5),
    ("gbrp10", 64, 64, 10, 6),
    ("gbrp12", 100, 80, 32, 7),
]


def _planes(fmt, w, h, seed):
    """tests/test_ffv2_native.py's content."""
    f = get_pix_fmt(fmt)
    mx = (1 << f.bits) - 1
    rng = np.random.RandomState(seed)
    base = rng.randint(0, mx + 1, (h, w)).astype(np.int64)
    return [np.clip(base + rng.randint(-40, 40, (h, w)), 0, mx)
            for _ in range(f.nb_planes)]


def _same_planes(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------


def test_torch_ffv2_tables_equal():
    names = [n for n in dir(jtables) if n.isupper()]
    assert names
    for n in names:
        a, b = getattr(tables, n), getattr(jtables, n)
        if isinstance(b, dict):
            assert a.keys() == b.keys(), n
            for k in b:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), n
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), n


def test_torch_ffv2_dsp_equal():
    for n in (4, 8, 16, 32, 64):
        assert np.array_equal(dsp.scan_order(n), jdsp.scan_order(n))
        assert list(dsp.band_starts(n)) == list(jdsp.band_starts(n))
        for tx in (dsp.TX_DCT, dsp.TX_DST):
            assert np.array_equal(dsp._basis(n, tx), jdsp._basis(n, tx))
    assert dsp.LAP_PARAMS.keys() == jdsp.LAP_PARAMS.keys()
    for k in dsp.LAP_PARAMS:
        assert np.array_equal(dsp.LAP_PARAMS[k], jdsp.LAP_PARAMS[k])
    assert (dsp._FRAC_BITS, dsp._ROUND, dsp.SB_SIZE) == (
        jdsp._FRAC_BITS, jdsp._ROUND, jdsp.SB_SIZE)
    rng = np.random.RandomState(0)
    plane = rng.randint(-2048, 2048, (128, 192))
    for fwd in (True, False):
        assert np.array_equal(
            dsp.lap_filter_frame_hor(plane, 64, 32, fwd),
            jdsp.lap_filter_frame_hor(plane, 64, 32, fwd))
        assert np.array_equal(
            dsp.lap_filter_frame_ver(plane, 64, 32, fwd),
            jdsp.lap_filter_frame_ver(plane, 64, 32, fwd))
    blk = rng.randint(-2048, 2048, (16, 16)).astype(np.int32)
    assert np.array_equal(dsp.fwd_tx_2d(blk), jdsp.fwd_tx_2d(blk))
    assert np.array_equal(dsp.inv_tx_2d(blk), jdsp.inv_tx_2d(blk))


@pytest.mark.parametrize("k,max_abs", [(1, None), (8, 7), (31, 30),
                                       (16, None)])
def test_torch_ffv2_pvq_equal(k, max_abs):
    rng = np.random.RandomState(k)
    for length in (15, 33, 129, 513):
        for x in (rng.randint(-300, 300, length),
                  rng.randint(-(1 << 17), 1 << 17, length),
                  np.full(length, 5), np.zeros(length, np.int64)):
            assert np.array_equal(pvq.pvq_search(x, k, max_abs),
                                  jpvq.pvq_search(x, k, max_abs))
    v = np.r_[rng.randint(0, 1 << 40, 2000, dtype=np.int64),
              np.arange(-3, 2000) ** 3, np.arange(1, 2000) ** 3 - 1]
    assert np.array_equal(pvq.icbrt_array(v), jpvq.icbrt_array(v))
    p = rng.randint(-9, 10, 64)
    assert np.array_equal(pvq.band_reconstruct(p, 77),
                          jpvq.band_reconstruct(p, 77))


def _code_symbols(mod, seed):
    """Seeded symbols of every kind through a Daala encoder of ``mod``;
    returns the packet and the symbols."""
    rng = np.random.RandomState(seed)
    e = mod.DaalaEncoder()
    cdf = mod.DaalaCDF(13, 16, 64, 0, 6, 0)
    syms = []
    for _ in range(400):
        kind = rng.randint(4)
        if kind == 0:
            v = (int(rng.randint(196)), 196)
            e.encode_uint(*v)
        elif kind == 1:
            v = (int(rng.randint(1 << rng.randint(1, 14))),)
            e.encode_golomb(*v)
        elif kind == 2:
            n = int(rng.randint(1, 17))
            v = (int(rng.randint(1 << n)), n)
            e.encode_bits(*v)
        else:
            v = (int(rng.randint(16)), int(rng.randint(13)))
            e.encode_cdf_adapt(cdf, v[0], v[1], 16)
        syms.append((kind, v))
    return e.done(), syms


def test_torch_ffv2_daala_coder_equal():
    for seed in range(3):
        pkt, syms = _code_symbols(entropy, seed)
        assert pkt == _code_symbols(jent, seed)[0]
        d = entropy.DaalaDecoder(pkt)
        cdf = entropy.DaalaCDF(13, 16, 64, 0, 6, 0)
        for kind, v in syms:
            got = (d.decode_uint(v[1]) if kind == 0 else
                   d.decode_golomb() if kind == 1 else
                   d.decode_bits(v[1]) if kind == 2 else
                   d.decode_cdf_adapt(cdf, v[1], 16))
            assert got == v[0]


def test_torch_ffv2_codec_and_osd_equal():
    w, h = 130, 66
    planes = _planes("yuv444p", w, h, 2)
    pkt = FFV2Encoder(w, h, "yuv444p", FFV2Config(qp=16)).encode(planes)
    assert pkt == JEncoder(w, h, "yuv444p", JConfig(qp=16)).encode(planes)
    assert _same_planes(FFV2Decoder(w, h).decode(pkt),
                        JDecoder(w, h).decode(pkt))
    lines = osd.osd_lines("0.1.0", w, h, 3, 2, "yuv444p", 1, 1, len(pkt),
                          7, 16)
    assert lines == josd.osd_lines("0.1.0", w, h, 3, 2, "yuv444p", 1, 1,
                                   len(pkt), 7, 16)
    a = np.zeros((80, 400), np.uint8)
    b = np.zeros((80, 400), np.uint8)
    osd.stamp_osd(a, 8, lines)
    josd.stamp_osd(b, 8, lines)
    assert np.array_equal(a, b) and a.any()
    assert filecmp.cmp(os.path.join(os.path.dirname(osd.__file__),
                                    "cga_font.npy"),
                       os.path.join(os.path.dirname(josd.__file__),
                                    "cga_font.npy"), shallow=False)
    from ffmpeg_ffv2_tpu import __version__ as jver
    from ffmpeg_ffv2_tpu_torch import __version__
    assert __version__ == jver
    for name in ("FFV2Encoder", "FFV2Decoder", "FFV2Config", "DaalaEncoder",
                 "DaalaDecoder", "DaalaCDF"):
        assert hasattr(tffv2, name)


SIGN_STEP = ("""    for (int i = 0; i < n; i++)
        if (x[i] < 0) y[i] = -y[i];
""", """    // y * sign(x), as pvq.py and the device quantizer: a pulse that the
    // cap pushed onto a zero coefficient codes as 0 (the JAX package's
    // file keeps it as +1 here)
    for (int i = 0; i < n; i++)
        y[i] = x[i] < 0 ? -y[i] : (x[i] > 0 ? y[i] : 0);
""")


def test_torch_ffv2_runtime_copy():
    """``native/ffv2_runtime.cpp`` is the JAX file below its header but
    for pvq_search's sign step, and the port's library and the JAX
    package's code the same packets on the cases (``encode_host`` bound
    to each)."""
    with open(os.path.join(REPO, "ffmpeg_ffv2_tpu_torch", "native",
                           "ffv2_runtime.cpp")) as f:
        port = f.read()
    with open(os.path.join(REPO, "ffmpeg_ffv2_tpu", "native",
                           "ffv2_runtime.cpp")) as f:
        orig = f.read()
    assert orig.count(SIGN_STEP[0]) == 1
    want = orig.replace(*SIGN_STEP)
    assert port.endswith(want) and port[:-len(want)].startswith("// Copy")
    jlib = jnat._bind(jffv1_native.get_lib())
    for fmt, w, h, qp, seed in CASES[:3] + CASES[5:6]:
        planes = _planes(fmt, w, h, seed)
        enc = tnat.NativeFFV2Encoder(w, h, fmt, FFV2Config(qp=qp),
                                     device="cpu")
        ours = enc.encode_host(planes)
        enc.lib = jlib
        assert enc.encode_host(planes) == ours


def test_torch_ffv2_runtime_sign_step_finding():
    """The finding in the reference: the JAX package's C++ quantizer
    (``ffv2_runtime.cpp:pvq_search``, behind ``ffv2rt_enc_frame`` and
    ``ffv2rt_enc_leaf``) leaves +1 on a zero coefficient that the qp - 1
    cap pushed the last pulse onto, where the Python codec's
    ``pvq_search`` (y * sign(x)) and the device quantizer code 0.  A
    64x64 block whose band 6 holds one nonzero coefficient: the Python
    codec's packet equals the port library's, not the JAX library's."""
    from ffmpeg_ffv2_tpu.ffv2 import codec as jcodec
    qp = 16
    stream = np.zeros(64 * 64, np.int64)
    stream[0] = -13251
    stream[1 + jdsp.band_starts(64)[6] + 93] = -1
    e = jent.DaalaEncoder()
    e.encode_uint(jcodec.PIXFMT_WIRE_IDS["gray"], jcodec.PIXFMT_WIRE_NB)
    e.encode_golomb(qp)
    e.encode_cdf_adapt(jcodec._subdiv_cdf(), jcodec.SPLIT_END, 0,
                       jcodec.SPLIT_NB)
    e.encode_bits(jdsp.TX_DCT, 4)
    jcodec._quant_block(e, jcodec._pulse_cdf(qp), stream, qp, 64)
    want = e.done()
    enc = tnat.NativeFFV2Encoder(64, 64, "gray", FFV2Config(qp=qp),
                                 device="cpu")

    def frame_packet(lib):
        h = enc._open()
        try:
            s = np.ascontiguousarray(stream[None])
            lib.ffv2rt_enc_frame(h, tnat._ptr(s, tnat.ctypes.c_int64), 1,
                                 1, 64, jdsp.TX_DCT)
            return enc._done(h)
        finally:
            lib.ffv2rt_enc_destroy(h)

    assert frame_packet(enc.lib) == want
    assert frame_packet(jnat._bind(jffv1_native.get_lib())) != want
    dc, pulses, _ = tnat.dv.quantize_streams(stream[None], qp,
                                             dsp.band_starts(64), 64,
                                             device="cpu")
    assert np.array_equal(pulses[0].astype(np.int64), np.concatenate(
        [jpvq.pvq_search(np.r_[stream[1:], 0][lo:hi], qp, qp - 1)
         for lo, hi in zip(jdsp.band_starts(64)[:-1],
                           jdsp.band_starts(64)[1:])]))


# ---------------------------------------------------------------------------
# the sessions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt,w,h,qp,seed", CASES)
def test_torch_ffv2_native_cases(fmt, w, h, qp, seed):
    """The port's device path (plain K18/K19) and host path against JAX
    NativeFFV2Encoder and the Python codec; the decodes against theirs."""
    planes = _planes(fmt, w, h, seed)
    pkt_py = JEncoder(w, h, fmt, JConfig(qp=qp)).encode(planes)
    assert jnat.NativeFFV2Encoder(w, h, fmt, JConfig(qp=qp)).encode(
        planes) == pkt_py
    enc = tnat.NativeFFV2Encoder(w, h, fmt, FFV2Config(qp=qp), device="cpu")
    assert enc.encode(planes) == pkt_py
    assert enc.encode_host(planes) == pkt_py
    ref = JDecoder(w, h).decode(pkt_py)
    assert _same_planes(jnat.NativeFFV2Decoder(w, h).decode(pkt_py), ref)
    dec = tnat.NativeFFV2Decoder(w, h, device="cpu")
    assert _same_planes(dec.decode(pkt_py), ref)
    assert _same_planes(dec.decode_host(pkt_py), ref)


@pytest.mark.parametrize("bs", [32, 16, 8, 4, 0])
def test_torch_ffv2_split_tree(bs):
    """block_size < 64: the XY quad-tree (0: activity-adaptive, mixed leaf
    sizes), as tests/test_ffv2_native.py builds it."""
    w, h = 128, 96
    planes = _planes("yuv444p", w, h, 20 + bs)
    if bs == 0:
        planes[0][:64, :64] = np.linspace(
            0, 255, 64 * 64).reshape(64, 64).astype(np.int64)
    pkt_py = JEncoder(w, h, "yuv444p", JConfig(qp=12, block_size=bs)).encode(
        planes)
    assert jnat.NativeFFV2Encoder(
        w, h, "yuv444p", JConfig(qp=12, block_size=bs)).encode(planes) == \
        pkt_py
    enc = tnat.NativeFFV2Encoder(w, h, "yuv444p",
                                 FFV2Config(qp=12, block_size=bs),
                                 device="cpu")
    assert enc.encode(planes) == pkt_py
    assert enc.encode_host(planes) == pkt_py
    ref = JDecoder(w, h).decode(pkt_py)
    assert _same_planes(jnat.NativeFFV2Decoder(w, h).decode(pkt_py), ref)
    dec = tnat.NativeFFV2Decoder(w, h, device="cpu")
    assert _same_planes(dec.decode(pkt_py), ref)
    assert _same_planes(dec.decode_host(pkt_py), ref)


def test_torch_ffv2_session_reuse_and_osd():
    """One encoder and one decoder across frames stay exact; the decoder's
    OSD equals JAX's on 8-bit luma."""
    w = h = 96
    enc = tnat.NativeFFV2Encoder(w, h, "yuv444p", FFV2Config(qp=14),
                                 device="cpu")
    dec = tnat.NativeFFV2Decoder(w, h, device="cpu")
    jdec = jnat.NativeFFV2Decoder(w, h)
    for seed in range(3):
        planes = _planes("yuv444p", w, h, 10 + seed)
        pkt = JEncoder(w, h, "yuv444p", JConfig(qp=14)).encode(planes)
        assert enc.encode(planes) == pkt
        assert _same_planes(dec.decode(pkt), jdec.decode(pkt))
    a = tnat.NativeFFV2Decoder(w, h, osd=True, device="cpu").decode(pkt)[0]
    b = jnat.NativeFFV2Decoder(w, h, osd=True).decode(pkt)[0]
    # the decode time (ms) printed in line 7 may differ: compare the rest
    assert np.array_equal(np.delete(a, np.s_[68:76], 0),
                          np.delete(b, np.s_[68:76], 0))


@pytest.mark.parametrize("bs,depth", [(64, 2), (64, 1), (16, 2)])
def test_torch_ffv2_pipelined(bs, depth):
    """PipelinedFFV2Encoder's packets equal the sequential ones and JAX's
    PipelinedFFV2Encoder's."""
    w, h = 130, 66
    frames = [_planes("yuv444p", w, h, 30 + t) for t in range(4)]
    cfg = FFV2Config(qp=16, block_size=bs)
    seq = tnat.NativeFFV2Encoder(w, h, "yuv444p", cfg, device="cpu")
    want = [seq.encode(f) for f in frames]
    pipe = tnat.PipelinedFFV2Encoder(w, h, "yuv444p", cfg, depth=depth,
                                     device="cpu")
    try:
        assert pipe.encode_stream(frames) == want
    finally:
        pipe.close()
    if bs == 64 and depth == 2:
        jpipe = jnat.PipelinedFFV2Encoder(w, h, "yuv444p",
                                          JConfig(qp=16, block_size=bs))
        try:
            assert jpipe.encode_stream(frames) == want
        finally:
            jpipe.close()


def test_torch_ffv2_sessions_refuse_without_card(monkeypatch):
    """device="cuda" with no card raises RuntimeError; on the CPU the
    encoder's path takes the plain K18 and K19 and launches nothing."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tnat.NativeFFV2Encoder(64, 64, "gray"),
                 lambda: tnat.PipelinedFFV2Encoder(64, 64, "gray"),
                 lambda: tnat.NativeFFV2Decoder(64, 64)):
        with pytest.raises(RuntimeError):
            make()
    _build.reset_counts()
    planes = _planes("gray", 130, 66, 0)
    enc = tnat.NativeFFV2Encoder(130, 66, "gray", FFV2Config(qp=8),
                                 device="cpu")
    tnat.NativeFFV2Decoder(130, 66, device="cpu").decode(enc.encode(planes))
    counts = {k: (_build.KERNELS[k].plain_calls, _build.KERNELS[k].launches)
              for k in ("pvq", "lap_pre", "lap_post")}
    assert counts == {"pvq": (1, 0), "lap_pre": (1, 0), "lap_post": (1, 0)}
