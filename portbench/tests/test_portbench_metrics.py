"""The end-to-end arithmetic on made-up timings, the roofline files'
counts, the generator and the reference."""

import numpy as np
import pytest

from portbench import harness, roofline
from portbench.gen import videogen
from portbench.reference.ffv1 import (RefFFV1Encoder, predict_contexts,
                                      slice_grid, slice_rects)


def _run(calls, seconds, **kw):
    cell = harness.load_cell("range-1080p-stream")
    return harness.Run(cell=cell, seconds=seconds, setup_s=12.5,
                       window_calls=calls, pixels_per_frame=1920 * 1080,
                       launches=kw.pop("launches", {}),
                       n_calls=kw.pop("n_calls", len(calls)),
                       n_frames=kw.pop("n_frames", len(calls)),
                       peak_window_bytes=kw.pop("peak", 0), **kw)


def _calls(durations, batch=1):
    t, out = 0.0, []
    for i, d in enumerate(durations):
        out.append(harness.Call(t, t + d, list(range(i * batch,
                                                     (i + 1) * batch)), []))
        t += d
    return out


def test_rate_is_all_work_over_all_window_time():
    # 95 frames of 20 ms and one stall of 100 ms: 2.0 s of window
    calls = _calls([0.02] * 95 + [0.1])
    rate = harness.reader("encode_mpix_s")(_run(calls, 2.0))
    assert rate == pytest.approx(96 * 1920 * 1080 / 1e6 / 2.0)


def test_p95_is_over_every_frame_with_the_stall():
    calls = _calls([0.02] * 90 + [0.5] * 10)
    p95 = harness.reader("frame_ms_p95.host_paced")(_run(calls, 5.0))
    assert p95 == pytest.approx(float(np.percentile([20] * 90 + [500] * 10,
                                                    95)))
    assert p95 == pytest.approx(500.0)
    # a batch pass's time is each of its frames' time
    calls = _calls([0.16] * 19 + [0.4], batch=8)
    p95 = harness.reader("frame_ms_p95.host_paced")(_run(calls, 3.4))
    assert p95 == pytest.approx(float(np.percentile([160] * 152 + [400] * 8,
                                                    95)))


def test_setup_and_counters():
    run = _run(_calls([0.02] * 10), 1.0, launches={"place": 12},
               n_calls=10, n_frames=10, peak=3 * 2 ** 20)
    assert harness.reader("setup_s")(run) == 12.5
    assert harness.reader("cap_retries_per_frame")(run) == pytest.approx(0.2)
    assert harness.reader("peak_device_mib")(run) == 3.0


def test_trace_readers():
    # 10 traced frames busy 0.15 s on the card (15 ms a frame) over a
    # profiled span of 0.2 s; the untraced window's frames take 20 ms
    tr = harness.Trace(window_s=0.2, busy_s=0.15, frames=10,
                       lib_s={"rac_render_kernel": 0.5},
                       other_s={"at::native::elementwise_kernel": 0.75})
    run = _run(_calls([0.02] * 50), 1.0, trace=tr)
    assert harness.reader("device_idle_pct")(run) == pytest.approx(25.0)
    # a profiler that stretches the span does not move it
    tr.window_s = 0.4
    assert harness.reader("device_idle_pct")(run) == pytest.approx(25.0)
    run = _run(_calls([0.03] * 50), 1.0, trace=tr)
    assert harness.reader("device_idle_pct")(run) == pytest.approx(50.0)
    assert harness.reader("port_kernels_ms_per_frame")(run) == 50.0
    assert harness.reader("torch_ops_ms_per_frame")(run) == 75.0
    # a kernel that did not run leaves the roofline silent, never 0
    run.work, run.traced_pool_frames = [{"decisions": 1, "samples": 1,
                                         "packet_bytes": 1,
                                         "contexts": 1}], [0]
    assert harness.reader("range_kernels_roofline")(run) is None


def _decisions(v, signed):
    """Binary decisions of one symbol: a zero flag, e ones and a zero, e
    mantissa bits, a sign."""
    v = np.asarray(v)
    a = np.abs(v)
    e = np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))), 0)
    return np.where(a == 0, 1, 2 + 2 * e + (1 if signed else 0)).sum()


def test_roofline_counts_the_datas_bytes_on_a_small_frame():
    w, h, sl = 192, 160, 30
    frame = videogen.pool(5, 1, {"width": w, "height": h})[0]
    ref = RefFFV1Encoder(w, h, sl, 1, 12)
    pkt = ref.encode(frame)
    work = ref.work[0]
    nh, nv = slice_grid(w, h, sl)
    want = 1 + sl                                   # key bit, terminators
    for i, (x, y, sw, shh) in enumerate(slice_rects(w, h, nh, nv)):
        hdr = ref._header((x, y, sw, shh))
        want += _decisions(hdr, False)
        crops = [frame[0][y:y + shh, x:x + sw],
                 frame[1][y // 2:(y + shh + 1) // 2, x // 2:(x + sw + 1) // 2],
                 frame[2][y // 2:(y + shh + 1) // 2, x // 2:(x + sw + 1) // 2]]
        for c in crops:
            want += _decisions(predict_contexts(c)[1], True)
    assert work["decisions"] == want
    assert work["samples"] == w * h * 3 // 2
    assert work["packet_bytes"] == len(pkt)
    d, s, p, k = want, w * h * 3 // 2, len(pkt), sl * 2 * 666
    expect = {"place": 12 * s, "adapt": 4 * s + d + 64 * k,
              "emission_pack": 2 * d, "expand": 4 * s + 5 * d,
              "rac_render": 4 * d + p}
    for name, b in expect.items():
        assert roofline.kernel(name).need(work) == b
    rice = RefFFV1Encoder(w, h, sl, 0, 12)
    rice.encode(frame)
    rw = rice.work[0]
    assert 0 < rw["codes"] <= rw["samples"] and rw["runs"] > 0
    assert roofline.kernel("vlc").need(rw) == (4 * s + 4 * rw["codes"]
                                                + 12 * k)
    assert roofline.kernel("ladder").need(rw) == 8 * rw["runs"]


def test_the_generator_is_deterministic_by_seed():
    size = {"width": 64, "height": 48}
    a = videogen.pool(2 ** 31 + 7, 3, size)
    b = videogen.pool(2 ** 31 + 7, 3, size)
    c = videogen.pool(2 ** 31 + 8, 3, size)
    assert all((x == y).all() for fa, fb in zip(a, b) for x, y in zip(fa, fb))
    assert any((x != y).any() for x, y in zip(a[0], c[0]))
    assert a[0][0].dtype == np.uint8 and a[0][1].shape == (24, 32)
    # the seed picks the start: seed + 1 starts one frame later
    assert all((x == y).all() for x, y in zip(a[1], c[0]))


@pytest.mark.parametrize("w,h,start", [(352, 288, 0), (352, 288, 9),
                                       (34, 34, 40)])
def test_the_generator_is_fates_vsynth1(w, h, start):
    """The copy equals the port's copy of FATE's videogen (vsynth1 at
    352x288, vsynth3 at 34x34), whose frames tests/ hold to FATE's
    checksums."""
    from ffmpeg_ffv2_tpu_torch.testsrc import vsynth1_frames
    want = list(vsynth1_frames(start + 3, w, h))[start:]
    got = videogen.pool(start, 3, {"width": w, "height": h})
    for fw, fg in zip(want, got):
        assert all((x == y).all() for x, y in zip(fw, fg))


@pytest.mark.parametrize("coder,context", [(1, 1), (0, 0), (1, 0), (0, 1)])
@pytest.mark.parametrize("w,h,slices,gop", [(96, 64, 4, 12), (130, 70, 6, 3),
                                             (192, 160, 24, 1),
                                             (192, 160, 16, 1)])
def test_the_reference_equals_the_ports_native_codec(coder, context, w, h,
                                                     slices, gop):
    from ffmpeg_ffv2_tpu_torch.ffv1.native import NativeFFV1Codec
    from ffmpeg_ffv2_tpu_torch.ffv1.params import (FFV1Config,
                                                   params_from_config)
    rng = np.random.default_rng(w + coder)
    frames = videogen.pool(3, 8, {"width": w, "height": h})
    frames = [[np.clip(p.astype(np.int32) + rng.integers(-30, 31, p.shape),
                       0, 255).astype(np.uint8) if i else p
               for i, p in enumerate(f)] for f in frames]
    p = params_from_config(FFV1Config(level=3, coder=coder, context=context,
                                      slices=slices, slicecrc=1,
                                      gop_size=gop), "yuv420p", w, h)
    nat = NativeFFV1Codec(p)
    ref = RefFFV1Encoder(w, h, slices, coder, gop, context)
    got = ref.encode_all(frames)
    for i, f in enumerate(frames):
        want = nat.encode([x.astype(np.int32) for x in f],
                          keyframe=gop <= 1 or i % gop == 0)
        assert got[i] == want, i
