"""The SD tape configuration's own parts: the plain reference above 8 bits
(``reference/ffv1_hbd.py``) against the port's native codec and its
device session on the CPU, byte for byte; its transcribed quantisers; its
refusal of Golomb-Rice above 8 bits; the 10-bit 4:2:2 generator
(``gen/videogen422p10.py``); and whole runs of the cell on the CPU at a
small size, sound, under the 9-bit control and with a planted fault."""

import ast
import dataclasses
import os

import numpy as np
import pytest

from portbench import harness
from portbench.gen import videogen, videogen422p10
from portbench.reference import ffv1_hbd, tables_hbd
from portbench.tests.faults import CpuPort, _Host, program_for

CELL = "sd-tape-yuv422p10-stream"
SEED = 2 ** 31 + 23


def _noisy(w, h, n, pix="yuv422p10", seed=3):
    """``n`` frames of the 10-bit 4:2:2 source at w x h (another layout
    or depth: seeded noise over a gradient), with noise over the whole
    range of the samples in every plane, so residuals past 8 bits are
    common."""
    bits, hs, vs = ffv1_hbd.pix_fmt_layout(pix)
    rng = np.random.default_rng(seed)
    top = (1 << bits) - 1
    if pix == "yuv422p10":
        frames = videogen422p10.pool(seed, n, {"width": w, "height": h})
    else:
        cw, ch = -(-w >> hs), -(-h >> vs)
        ramp = [np.indices(s).sum(0) * (top // 64) for s in
                ((h, w), (ch, cw), (ch, cw))]
        frames = [[(r + t * 97) % (top + 1) for r in ramp] for t in range(n)]
    return [[np.clip(p.astype(np.int64) + rng.integers(-(top // 3),
                                                       top // 3 + 1, p.shape),
                     0, top).astype(np.uint16) for p in f] for f in frames]


@pytest.mark.parametrize("context,gop", [(1, 1), (0, 1), (1, 3), (0, 3)])
def test_the_reference_equals_the_ports_codecs(context, gop):
    """96x50 at 24 slices: FFmpeg's 6 x 4 grid with rows of 12 and 13
    lines, so the port's session splits into two shape banks; the
    reference equals the native codec and the device session."""
    from ffmpeg_ffv2_tpu_torch.ffv1.device_coder import DeviceFFV1Encoder
    from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
    w, h = 96, 50
    frames = _noisy(w, h, 2 if gop == 1 else 3, seed=context + gop)
    # the content is noisy in all 10 bits
    assert max(int(p.max()) for f in frames for p in f) > 1000
    assert all(len(np.unique(p & 0x3FF)) > 256 for f in frames for p in f)
    cfg = FFV1Config(level=3, coder=1, context=context, slices=24,
                     slicecrc=1, gop_size=gop)
    enc = DeviceFFV1Encoder(w, h, "yuv422p10", cfg, device="cpu")
    assert len(enc.banks) == 2
    assert ffv1_hbd.slice_grid(w, h, 24, 10, 1, 0) == (6, 4)
    nat = NativeFFV1Codec(enc.p)
    ref = ffv1_hbd.RefHBDEncoder(w, h, 24, gop, context, 10, 1, 0)
    got = ref.encode_all(frames)
    for i, f in enumerate(frames):
        key = gop <= 1 or i % gop == 0
        want = nat.encode([x.astype(np.int32) for x in f], keyframe=key)
        assert got[i] == want, i
        assert enc.encode(f) == want, i
    # residuals past 8 bits were coded
    parts = [ffv1_hbd.predict_contexts(p, context, 10)[1] for p in frames[0]]
    assert max(int(np.abs(d).max()) for d in parts) > 255


@pytest.mark.parametrize("pix", ["yuv420p16", "yuv444p12", "yuv420p9",
                                 "yuv440p10"])
def test_the_reference_takes_the_depth_and_layout(pix):
    """Other depths and chroma shifts against the native codec; at 16
    bits the samples past 32767 wrap as ffv1enc.c reads them."""
    from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu_torch.ffv1.params import (FFV1Config,
                                                   params_from_config)
    w, h = 64, 40
    bits, hs, vs = ffv1_hbd.pix_fmt_layout(pix)
    frames = _noisy(w, h, 3, pix)
    for context in (0, 1):
        p = params_from_config(FFV1Config(level=3, coder=1, context=context,
                                          slices=4, slicecrc=1, gop_size=2),
                               pix, w, h)
        nat = NativeFFV1Codec(p)
        got = ffv1_hbd.RefHBDEncoder(w, h, 4, 2, context, bits, hs,
                                     vs).encode_all(frames)
        for i, f in enumerate(frames):
            assert got[i] == nat.encode([x.astype(np.int32) for x in f],
                                        keyframe=i % 2 == 0), (context, i)


def test_the_transcribed_quantisers_equal_the_ports():
    from ffmpeg_ffv2_tpu_torch.ffv1.params import build_quant_tables
    tabs, counts = build_quant_tables(10)
    for model, qs in ffv1_hbd.QUANT.items():
        for i, q in enumerate(qs):
            assert np.array_equal(q, tabs[model][i]), (model, i)
        assert ffv1_hbd.CONTEXTS[model] == counts[model]
    assert len(tables_hbd.QUANT9_10BIT) == len(tables_hbd.QUANT5_10BIT) == 256


def test_the_reference_refuses_what_it_does_not_code():
    conf = harness.load_cell(CELL).config
    with pytest.raises(ValueError, match="Golomb-Rice"):
        ffv1_hbd.packets({**conf, "coder": 0}, [])
    for pix in ("yuv420p", "yuv422p8", "rgb48", "yuv422p17", "gbrp10"):
        with pytest.raises(ValueError, match="9-16 bits"):
            ffv1_hbd.pix_fmt_layout(pix)
    with pytest.raises(ValueError, match="version 3"):
        ffv1_hbd.packets({**conf, "slicecrc": 0}, [])
    assert ffv1_hbd.pix_fmt_layout("yuv422p10") == (10, 1, 0)


def test_the_generator_is_deterministic_and_10_bit():
    size = {"width": 720, "height": 486}
    a = videogen422p10.pool(SEED, 2, size)
    b = videogen422p10.pool(SEED, 2, size)
    c = videogen422p10.pool(SEED + 1, 1, size)
    assert all((x == y).all() for fa, fb in zip(a, b) for x, y in zip(fa, fb))
    assert [p.shape for p in a[0]] == [(486, 720), (486, 360), (486, 360)]
    assert all(p.dtype == np.uint16 and int(p.max()) < 1024 for p in a[0])
    # the two low bits carry information
    assert all(len(np.unique(p & 3)) == 4 for p in a[0])
    # the seed picks the start: seed + 1 starts one frame later
    assert all((x == y).all() for x, y in zip(a[1], c[0]))


def test_the_generator_is_bt601_at_10_bits():
    """Luma is the 8-bit conversion's to within one 8-bit step; chroma
    of a gray is mid-scale; white is 1020; an odd width repeats its last
    column for the last chroma sample."""
    size = {"width": 64, "height": 48}
    start = 17
    y10 = videogen422p10.pool(start, 1, size)[0]
    y8 = videogen.pool(start, 1, size)[0]
    assert np.abs(y10[0].astype(int) / 4 - y8[0]).max() <= 1
    flat = np.zeros((2, 3, 3), np.uint8)
    flat[:, 2] = 255
    y, u, v = videogen422p10.rgb24_to_yuv422p10(flat)
    assert u.shape == (2, 2) and y.shape == (2, 3)
    assert (y[:, :2] == 0).all() and (y[:, 2] == 1020).all()
    assert (u[:, 0] == 512).all() and (v[:, 0] == 512).all()
    assert (u[:, 1] == 512).all() and (v[:, 1] == 512).all()


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_generator_imports_nothing_of_the_program():
    path = os.path.join(harness.ROOT, "portbench", "gen", "videogen422p10.py")
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "numpy"}, tops


def _small():
    """The cell at 48x26 (24 slices in rows of 6 and 7 lines: two shape
    banks, as at 720x486), a pool of 4 frames."""
    c = harness.load_cell(CELL)
    tr = {**c.traffic, "pool": 4, "warmup_calls": 3, "trace_calls": 1}
    return dataclasses.replace(c, config={**c.config, "width": 48,
                                          "height": 26}, traffic=tr)


def _run(program, trace=False, seconds=0.5):
    return harness.run_cell(_small(), SEED, seconds, trace, program=program,
                            log=lambda *a, **k: None)


def test_a_small_sd_run_is_correct_and_reads_its_banks():
    out = _run(CpuPort(), trace=True, seconds=4.0)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["bank_pipelines_per_frame"] >= 2.0
    assert m["bank_tail_ms_per_frame"] > 0
    assert m["host_syncs_per_frame"] >= 6.0
    # no card: the device's readers have nothing to read
    assert "range_kernels_roofline" not in m
    out = _run(CpuPort())
    assert out["correct"]
    assert {"encode_mpix_s", "setup_s"} <= set(out["metrics"])


class _Control10(_Host):
    """The reference in the program's place, on samples with their
    lowest bit cleared: 9-bit precision, the step below the 10 bits the
    configuration states."""

    def encoder(self, config):
        c = config
        bits, hs, vs = ffv1_hbd.pix_fmt_layout(c["pix_fmt"])
        ref = ffv1_hbd.RefHBDEncoder(c["width"], c["height"], c["slices"],
                                     c["gop"], c["context"], bits, hs, vs)

        class Enc:
            def encode(self, planes):
                return ref.encode([np.asarray(p) & 0x3FE for p in planes])
        return Enc()


@pytest.mark.parametrize("program", ["control", "altered_byte"])
def test_the_9_bit_control_and_a_fault_come_out_not_correct(program):
    prog = (_Control10() if program == "control"
            else program_for(program, CpuPort()))
    out = _run(prog)
    assert not out["correct"]
    assert out["checks"]["packets_wrong"]["value"] > 0
