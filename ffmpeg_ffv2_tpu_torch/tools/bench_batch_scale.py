"""Batch-size scaling of the all-intra device encode
(``DeviceFFV1Encoder.encode_batch``): the counterpart of
``tools/bench_batch_scale.py``.

For each B it first gates ``encode_batch(frames[:B])`` byte for byte
against the native codec's key packets and their lossless decode, then
times, with the frames already on the card (CUDA events, median of
``reps`` runs after a warm-up):

- the batch: ``encode_batch`` of the B frames, frames on the card to
  packet bytes on the host, ms a frame;
- K4 (``rac_render``) alone on the batch's op words: ms a launch (B x S
  slices, one block each) and ms a frame;

and once, ``encode()`` of the same frames as key frames, ms a frame.

    python -m ffmpeg_ffv2_tpu_torch.tools.bench_batch_scale [B ...] \\
        [--device cpu] [--reps N]

Defaults: B = 1 4 8 on 1920x1080 yuv420p,
``FFV1Config(level=3, coder=1, slices=30)``, ``chip_smoke``'s
``synth_1080p_frames`` (run from the root of the checkout).  Prints one
JSON line a B, then one for ``encode()``; each names its device.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..ffv1.native import NativeFFV1Codec
from ..ffv1.rac import rac_render
from . import device_label, device_ms

SIZES = (1, 4, 8)


def gate(enc, frames, sizes, dec=None) -> dict:
    """``enc.encode_batch(frames[:B])`` for each B: every packet equal to
    the native codec's key packet and decoded losslessly (raises
    AssertionError otherwise).  Returns {B: packets}."""
    import numpy as np
    nat = NativeFFV1Codec(enc.p)
    dec = dec or NativeFFV1Codec(enc.p)
    refs = {}
    out = {}
    for B in sizes:
        out[B] = enc.encode_batch(frames[:B])
        for t, pkt in enumerate(out[B]):
            if t not in refs:
                refs[t] = nat.encode(frames[t], True)
            if pkt != refs[t]:
                raise AssertionError(
                    f"encode_batch B={B} frame {t}: packet differs from the "
                    f"native codec ({len(pkt)} vs {len(refs[t])} bytes)")
            for a, b in zip(dec.decode(pkt), frames[t]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"encode_batch B={B} frame {t}: "
                                         "decode is not lossless")
    return out


def time_batch(enc, staged, B: int, reps: int) -> tuple:
    """The batch of ``staged[:B]`` (frames already on the encoder's
    device): (row of numbers, K4's inputs (opw, steps, buf_cap) and n_ops
    of the batch)."""
    dev = enc.device
    frames = staged[:B]
    ms = device_ms(lambda: enc.encode_batch(frames), reps, dev)
    bank = enc.banks[0]
    opw, n_ops, steps = bank.batch_ops(frames)
    k4 = (opw, steps, bank.caps.render_cap)
    k4_ms = device_ms(lambda: rac_render(*k4), reps, dev)
    p = enc.p
    return dict(B=B, slices=B * bank.S, ms=ms, ms_per_frame=ms / B,
                mpixel_s=B * p.width * p.height / ms / 1e3,
                k4_ms=k4_ms, k4_ms_per_frame=k4_ms / B, k4_steps=steps,
                k4_live_steps=int(n_ops.max())), (k4, n_ops)


def time_encode(enc, staged, reps: int) -> dict:
    """``encode()`` of each staged frame as a key frame: the median over
    the frames of each frame's median ms."""
    dev = enc.device
    per = sorted(device_ms(lambda f=f: enc.encode(f, force_keyframe=True),
                           reps, dev) for f in staged)
    return dict(B="encode()", frames=len(staged),
                ms_per_frame=per[len(per) // 2], ms_per_frame_each=per)


def run(sizes=SIZES, device="cuda", reps=3) -> list:
    """Gate and time each B on a fresh encoder; returns the rows."""
    from chip_smoke import synth_1080p_frames
    from ..ffv1.device_coder import DeviceFFV1Encoder
    from ..ffv1.params import FFV1Config
    frames = synth_1080p_frames(max(sizes), 1920, 1080)
    enc = DeviceFFV1Encoder(1920, 1080, "yuv420p",
                            FFV1Config(level=3, coder=1, slices=30),
                            device=device)
    gate(enc, frames, sizes)
    staged = [enc.upload(f) for f in frames]
    rows = [time_batch(enc, staged, B, reps)[0] for B in sizes]
    rows.append(time_encode(enc, staged, reps))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", nargs="*", type=int, default=list(SIZES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    label = device_label(args.device)
    for r in run(args.sizes, args.device, args.reps):
        print(json.dumps(dict(r, device=label, gate="byte-exact vs native")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
