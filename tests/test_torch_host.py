"""The PyTorch port's host side equals its JAX-package originals (the numpy
helpers, and the copies of params, headers, the range encoder, CRC and the
native codec), and the port imports neither jax nor the JAX package."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from ffmpeg_ffv2_tpu.coder.rac import RangeEncoder as JRangeEncoder
from ffmpeg_ffv2_tpu.core.crc import crc32_ieee as j_crc32_ieee
from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu.ffv1 import headers as JH
from ffmpeg_ffv2_tpu.ffv1 import params as jparams
from ffmpeg_ffv2_tpu.ffv1.codec_py import SliceState as JSliceState
from ffmpeg_ffv2_tpu.ffv1.expand_pallas import OP_GRAN
from ffmpeg_ffv2_tpu.ffv1.native import NativeFFV1Codec as JNative
from ffmpeg_ffv2_tpu.ffv1.params import FFV1Config, params_from_config
from ffmpeg_ffv2_tpu.ffv1.codec_py import SliceState
from ffmpeg_ffv2_tpu.ffv1.tpu_encoder import TPUFFV1Encoder
from ffmpeg_ffv2_tpu_torch.coder.rac import RangeEncoder as TRangeEncoder
from ffmpeg_ffv2_tpu_torch.core.crc import crc32_ieee as t_crc32_ieee
from ffmpeg_ffv2_tpu_torch.ffv1 import headers as TH
from ffmpeg_ffv2_tpu_torch.ffv1 import host
from ffmpeg_ffv2_tpu_torch.ffv1 import params as tparams
from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec as TNative
from ffmpeg_ffv2_tpu_torch.ffv1.slice_state import SliceState as TSliceState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("coder", [1, -2])
def test_torch_transition_tables(coder):
    p = params_from_config(FFV1Config(level=3, coder=coder, slices=4),
                           "yuv420p", 64, 48)
    for a, b in zip(host.transition_tables(p), jdc.transition_tables(p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    a = host.packed_transition_table(p)
    b = jdc.packed_transition_table(p)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_torch_quantize_cap_and_sizes():
    for cap_max in (1000, 1 << 20):
        for gran in (1, 7, 4096):
            for need in list(range(0, 300)) + [4095, 4096, 4097, 99999,
                                               cap_max, cap_max + 5]:
                assert (host.quantize_cap(need, cap_max, gran)
                        == jdc.quantize_cap(need, cap_max, gran))
    for bits in range(1, 18):
        assert host.k_max_for_bits(bits) == jdc.k_max_for_bits(bits)
        assert host.payload_field(bits) == jdc.payload_field(bits)
        assert host.n_sv_words(bits) == jdc.n_sv_words(bits)
        assert host.n_ev_words(bits) == jdc.n_ev_words(bits)
    assert np.array_equal(host.SLOT_AT_ROW, jdc.SLOT_AT_ROW)
    assert np.array_equal(host.ROW_OF_SLOT, jdc.ROW_OF_SLOT)
    assert (host.GCAP, host.TERMINATOR_SV, host.OP_GRAN) == (
        jdc.GCAP, jdc.TERMINATOR_SV, OP_GRAN)


@pytest.mark.parametrize("level,coder,slices", [(3, 1, 4), (3, -2, 30),
                                                (1, 2, 1), (4, 1, 4)])
def test_torch_plan_slice_prefix(level, coder, slices):
    cfg = FFV1Config(level=level, coder=coder, slices=slices)
    p = params_from_config(cfg, "yuv420p", 192, 108)
    rects = p.rects()
    for key in (True, False):
        for si in range(p.slice_count):
            a = host.plan_slice_prefix(p, SliceState(p), si, rects[si], key)
            b = jdc.plan_slice_prefix(p, SliceState(p), si, rects[si], key)
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("pix,wh,slices", [
    ("yuv420p", (64, 48), 4), ("yuv420p", (1920, 1080), 30),
    ("yuv420p", (35, 33), 4), ("gray", (48, 32), 4), ("bgr0", (48, 32), 4),
    ("yuva420p", (64, 48), 4)])
def test_torch_build_crop_plan(pix, wh, slices):
    p = params_from_config(FFV1Config(level=3, coder=1, slices=slices),
                           pix, *wh)
    shell = TPUFFV1Encoder.__new__(TPUFFV1Encoder)
    shell.p = p
    assert host.build_crop_plan(p) == TPUFFV1Encoder._build_plan(shell)


def test_torch_port_imports_without_jax():
    """Every module of the port imports with jax and the JAX package
    blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ffmpeg_ffv2_tpu'] = None\n"
        "import ffmpeg_ffv2_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "for m in ('ffv1.device_coder', 'ffv1.tpu_coder', "
        "'ffv1.tpu_encoder', 'ffv1.twopass', 'ops.sort', "
        "'tools.microbench_sort', 'tools.microbench_prims', 'tools.probes', "
        "'ffv2.codec', 'ffv2.device', 'ffv2.dsp', 'ffv2.entropy', "
        "'ffv2.native', 'ffv2.osd', 'ffv2.pvq', 'ffv2.tables', "
        "'parallel.slices', 'parallel.ffv1', 'parallel.ffv2', "
        "'parallel.world', 'coder.bitio', 'utils.psnr', 'utils.metrics', "
        "'convert.packing', 'convert.scale', 'core.frame', "
        "'container.avi', 'container.matroska', 'container.nut', "
        "'container.rawvideo', 'ffv1.codec_py', 'ffv1.encoder', "
        "'ffv1.decoder', 'ffv1.batched', 'cli.main', 'cli.__main__', "
        "'cli.mesh', 'tools.native_check', 'testsrc', 'testsrc.videogen', "
        "'testsrc.rotozoom', 'graft_entry'):\n"
        "    assert 'ffmpeg_ffv2_tpu_torch.' + m in names, m\n"
        "assert not any(m.split('.')[0] in ('jax', 'ffmpeg_ffv2_tpu') "
        "for m, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 53


def test_torch_chip_smoke_imports_no_jax_package():
    """chip_smoke.py imports neither the JAX package nor bench.py."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "ffmpeg_ffv2_tpu_torch" in {n.split(".")[0] for n in names}
    for n in names:
        assert n.split(".")[0] not in ("ffmpeg_ffv2_tpu", "bench", "jax"), n


def _params(pix, level, coder):
    cfg = FFV1Config(level=level, coder=coder, slices=4 if level > 2 else 0)
    return (params_from_config(cfg, pix, 64, 48),
            tparams.params_from_config(
                tparams.FFV1Config(level=level, coder=coder,
                                   slices=4 if level > 2 else 0),
                pix, 64, 48))


@pytest.mark.parametrize("pix", ["yuv420p", "gray", "yuv420p10", "bgr0"])
@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("coder", [0, 1])
def test_torch_params_copy(pix, level, coder):
    jp, tp = _params(pix, level, coder)
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if f.name == "pix_fmt":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert jp.rects() == tp.rects() and jp.slice_count == tp.slice_count
    for name in ("CODER_GOLOMB", "CODER_RANGE_DEFAULT", "CODER_RANGE_CUSTOM",
                 "CONTEXT_SIZE"):
        assert getattr(jparams, name) == getattr(tparams, name)


@pytest.mark.parametrize("pix,level,coder", [
    ("yuv420p", 3, 0), ("yuv420p", 3, 1), ("gray", 1, 1), ("bgr0", 3, 1),
    ("yuv420p10", 1, 0), ("yuv420p", 4, 1)])
def test_torch_headers_copy(pix, level, coder):
    """write_extradata, write_v01_header and write_slice_header byte for
    byte, with the custom and the default transition tables."""
    jp, tp = _params(pix, level, coder)
    assert TH.write_extradata(tp) == JH.write_extradata(jp)
    a, b = TRangeEncoder(), JRangeEncoder()
    TH.write_v01_header(a, tp)
    JH.write_v01_header(b, jp)
    assert a.terminate(1) == b.terminate(1)
    for rect in jp.rects():
        a, b = TRangeEncoder(), JRangeEncoder()
        a.set_state_tables(tp.state_transition)
        b.set_state_tables(jp.state_transition)
        TH.write_slice_header(a, tp, TSliceState(tp), rect)
        JH.write_slice_header(b, jp, JSliceState(jp), rect)
        assert a.terminate(0) == b.terminate(0)


def test_torch_coder_and_slice_state_copy():
    """The range encoder's default tables, the run ladder, the VlcState
    defaults and SliceState's per-plane fields equal the originals."""
    from ffmpeg_ffv2_tpu.coder import golomb as jg
    from ffmpeg_ffv2_tpu.coder import rac as jrac
    from ffmpeg_ffv2_tpu_torch.coder import golomb as tg
    from ffmpeg_ffv2_tpu_torch.coder import rac as trac
    for name in ("DEFAULT_ZERO_STATE", "DEFAULT_ONE_STATE"):
        assert np.array_equal(getattr(trac, name), getattr(jrac, name))
    assert tg.LOG2_RUN == jg.LOG2_RUN
    assert dataclasses.asdict(tg.VlcState()) == dataclasses.asdict(
        jg.VlcState())
    for pix, coder in (("yuv420p", 0), ("gray", 1), ("yuva420p", 1)):
        jp, tp = _params(pix, 3, coder)
        a, b = TSliceState(tp), JSliceState(jp)
        assert a.plane_ctx_count == b.plane_ctx_count
        assert a.plane_qt_index == b.plane_qt_index
        assert (a.slice_rct_by, a.slice_rct_ry, a.slice_coding_mode) == (
            b.slice_rct_by, b.slice_rct_ry, b.slice_coding_mode)


def test_torch_crc_copy():
    rng = np.random.default_rng(9)
    for n in (0, 1, 3, 4, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert t_crc32_ieee(data) == j_crc32_ieee(data)
        assert t_crc32_ieee(data, 0x1234567) == j_crc32_ieee(data, 0x1234567)


def _planned(enc, planes, key):
    """A hybrid encoder's native planner output for one frame: per slice
    the range-coded (sv, bit) ops and, for Golomb-Rice, the (value,
    nbits) bit ops."""
    import ctypes
    lib, h = enc.lib, enc.native.handle
    arrs = [np.ascontiguousarray(x, dtype=np.int32) for x in planes]
    ptrs = (ctypes.c_void_p * len(arrs))(
        *[x.ctypes.data_as(ctypes.c_void_p) for x in arrs])
    mx = (lib.ffv1rt_plan_golomb if enc.golomb else lib.ffv1rt_plan)(
        h, ptrs, int(key))
    assert mx >= 0
    out = []
    for si in range(enc.p.slice_count):
        sv, bt = np.empty(mx, np.uint8), np.empty(mx, np.uint8)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        n = lib.ffv1rt_get_plan(h, si, sv.ctypes.data_as(u8),
                                bt.ctypes.data_as(u8), mx)
        out += [sv[:n], bt[:n]]
        if enc.golomb:
            val, nb = np.empty(mx, np.uint32), np.empty(mx, np.uint8)
            n = lib.ffv1rt_get_plan_bits(
                h, si, val.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                nb.ctypes.data_as(u8), mx)
            out += [val[:n], nb[:n]]
    return out


@pytest.mark.parametrize("coder", [0, 1])
def test_torch_native_copy(coder):
    """The port's native codec copy encodes the packets of the original,
    and decodes them back; its encode from (ctx, diff) symbols, its
    planner's (sv, bit) and bit streams and its pass-1 statistics (of
    the encode and of the planner) equal the original's too."""
    from ffmpeg_ffv2_tpu.ffv1 import twopass as jtp
    from ffmpeg_ffv2_tpu.ffv1.tpu_coder import TPUCoderFFV1Encoder as JHyb
    from ffmpeg_ffv2_tpu_torch.ffv1 import twopass as ttp
    from ffmpeg_ffv2_tpu_torch.ffv1.tpu_coder import TPUCoderFFV1Encoder
    from ffmpeg_ffv2_tpu_torch.ffv1.tpu_encoder import (
        TPUFFV1Encoder as THyb)
    jp, tp = _params("yuv420p", 3, coder)
    a, b, dec = TNative(tp), JNative(jp), TNative(tp)
    sa, sb = TNative(tp), JNative(jp)                # encode_sym sessions
    cfg = FFV1Config(level=3, coder=coder, slices=4)
    phase_a = THyb(64, 48, "yuv420p", tparams.FFV1Config(
        level=3, coder=coder, slices=4), device="cpu").phase_a
    ta = TPUCoderFFV1Encoder(64, 48, "yuv420p", tparams.FFV1Config(
        level=3, coder=coder, slices=4), device="cpu")
    tb = JHyb(64, 48, "yuv420p", cfg)
    if coder:
        a.enable_stats()
        b.enable_stats()
        ta.set_stats_mode(True)
        tb.set_stats_mode(True)
    rng = np.random.RandomState(6)
    for t in range(3):
        planes = [rng.randint(0, 256, s).astype(np.int32)
                  for s in ((48, 64), (24, 32), (24, 32))]
        if t == 1:
            planes = [pl_ // 16 * 16 for pl_ in planes]
        pkt = a.encode(planes, t == 0)
        assert pkt == b.encode(planes, t == 0)
        for x, y in zip(dec.decode(pkt), planes):
            assert np.array_equal(x, y)
        ctx, diff = phase_a(planes)
        sym = sa.encode_sym(planes, ctx, diff, t == 0)
        assert sym == sb.encode_sym(planes, ctx, diff, t == 0) == pkt
        for x, y in zip(_planned(ta, planes, t == 0),
                        _planned(tb, planes, t == 0)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    if coder:
        for x, y in ((a, b), (ta.native, tb.native)):
            st, sj = ttp.collect_stats(x), jtp.collect_stats(y)
            assert st[2] == sj[2] == 1
            assert np.array_equal(st[0], sj[0]) and st[0].sum() > 0
            assert np.array_equal(st[1], sj[1])
