"""CUDA-event times of the range path's serial kernels, K4 (rac_render),
K2 (adapt) and K6 (adapt_emission), at the main path's shapes, for the
checkout at ``--root``:

    python3 ffmpeg_ffv2_tpu_torch/tools/kernel_times.py [--root DIR]

``--root`` (default: this checkout) is the root of a checkout of the
repository, whose ``ffmpeg_ffv2_tpu_torch`` and ``chip_smoke.py`` are
imported, so that two versions of the kernels are timed by the same code
on one card: unpack the other version under a git-ignored directory and
run the script for each root in turns.  It captures frame 0 of 1080p
yuv420p (``FFV1Config(level=3, coder=1, slices=30)``) and of 1080p rgb48
(``slicecrc=1``, coding depth 17, R = 7) through that checkout's
``chip_smoke.probe`` and times each kernel on the captured inputs
(median of ``REPS`` runs after a warm-up).  Prints one JSON line per
configuration: the card (``nvidia-smi`` name and power limit), the root,
ms, ns a step (K4: the longest slice's live steps) and ns a chain row (K2,
K6: the longest tile chain's rows).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


REPS = 9                    # timed runs a kernel, after a warm-up


def main() -> int:
    ap = argparse.ArgumentParser()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--root", default=here)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: torch sees no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ffmpeg_ffv2_tpu_torch import _build
    from ffmpeg_ffv2_tpu_torch.ffv1 import adapt as ad
    from ffmpeg_ffv2_tpu_torch.ffv1 import host
    from ffmpeg_ffv2_tpu_torch.ffv1 import rac
    from ffmpeg_ffv2_tpu_torch.ffv1.params import FFV1Config
    if not os.path.abspath(_build.__file__).startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.load()
    cases = [("yuv420p", cs.synth_1080p_frames(1)[0],
              FFV1Config(level=3, coder=1, slices=30)),
             ("rgb48", cs.synth_rgb48_frames(1)[0],
              FFV1Config(level=3, coder=1, slices=30, slicecrc=1))]
    for pix, frame, cfg in cases:
        enc, inputs = cs.probe(f"kernel_times {pix}", pix, cs.W, cs.H, cfg,
                               frame)
        k = inputs["walk"]
        caps, pred = k[1], k[3]
        rows = cs.chain_rows(caps.tolist(), pred.tolist())
        live = int(inputs["n_ops"].max())
        ev = k + (host.n_ev_words(enc.code_bits),)
        t4 = cs.cuda_ms(lambda: rac.rac_render(*inputs["k4"]), REPS)
        t2 = cs.cuda_ms(lambda: ad.adapt(*k), REPS)
        t6 = cs.cuda_ms(lambda: ad.adapt_emission(*ev), REPS)
        print(json.dumps(dict(
            card=card, root=root, pix=pix, code_bits=enc.code_bits,
            k4_ms=t4, k4_steps=inputs["k4"][1], k4_live_steps=live,
            k4_ns_a_step=t4 * 1e6 / live, k2_ms=t2, k6_ms=t6,
            chain_rows=rows, k2_ns_a_row=t2 * 1e6 / rows,
            k6_ns_a_row=t6 * 1e6 / rows)), flush=True)
        del enc, inputs
    return 0


if __name__ == "__main__":
    sys.exit(main())
