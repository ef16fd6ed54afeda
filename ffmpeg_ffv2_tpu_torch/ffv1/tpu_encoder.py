"""The hybrid FFV1 encoder with phase A (context modeling) on a CUDA device
and phase B (the adaptive entropy coder) in the native slice-threaded C++
runtime.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/tpu_encoder.py``
(``TPUFFV1Encoder``, ``_phase_a_batch``, ``_phase_a_rgb_batch``).  Slices
are independent coding units (the sample ring resets at slice borders,
ffv1enc.c:282), so phase A runs per slice crop: same-shaped crops of a
plane are stacked and run as one batch of ``phase_a.plane_context_diff``
(a launch of the phase_a kernel on the card).
RGB takes the fixed RCT of versions <= 3 (``phase_a.phase_a_rgb_planes``)
with the G/B swap of 9..14-bit planar RGB.  ctx and diff are narrowed to
int16 on the card before the copy to the host (ctx < 32768 by the format's
context-count cap; |diff| < 2^15 for bits <= 16), which widens them to
int32 for ``NativeFFV1Codec.encode_sym``.  Packets are byte-identical to
the native codec's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import headers as H
from .host import build_crop_plan
from .native import NativeFFV1Codec
from .params import FFV1Config, params_from_config
from .phase_a import _wrap16, lut_for, phase_a_rgb_planes, plane_context_diff


def _to_host(ctx, diff):
    """(ctx, diff) int32 grids on the device -> one int16 numpy array
    (2, ...) after one copy."""
    return torch.stack([ctx, diff]).to(torch.int16).cpu().numpy()


class TPUFFV1Encoder:
    """Encoder session: phase A on a CUDA device, the native runtime for
    the entropy coder.  device="cpu" runs phase A on the CPU (tests);
    device="cuda", the default, raises RuntimeError where torch sees no
    CUDA device.  Raises NotImplementedError for version-4 RGB (the
    per-slice RCT search) and RGB over 14 bits per sample."""

    # the kernels an encode launches: phase A (plane_context_diff on the
    # card)
    kernels = ("phase_a",)

    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV1Config | None = None, n_threads: int = 0,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TPUFFV1Encoder: device='cuda' but torch "
                               "sees no CUDA device")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.cfg = config or FFV1Config()
        self.p = p = params_from_config(self.cfg, pix_fmt, width, height)
        if p.colorspace == 1 and p.version > 3:
            raise NotImplementedError(
                "TPU phase-A RGB covers fixed RCT (version <= 3); the v4 "
                "per-slice coefficient search uses the host path")
        if p.colorspace == 1 and p.use32bit:
            raise NotImplementedError(
                "TPU phase-A RGB covers the int16 sample ring (<= 14 bpc)")
        self.native = NativeFFV1Codec(p, n_threads)
        self.extradata = H.write_extradata(p) if p.version > 1 else b""
        self.picture_number = 0
        self.qt = lut_for(p, p.context_model)
        self.five = bool(p.quant_tables[p.context_model][3][127]
                         or p.quant_tables[p.context_model][4][127])
        self._plan = build_crop_plan(p)

    def phase_a(self, planes):
        """Phase A on the device.

        Returns (ctx, diff) int16 crop arrays on the host, indexed
        [slice * n_planes + plane].  Crops are per slice because chroma
        slices of odd-sized frames overlap by a row or column (each slice
        codes its ceil-rounded chroma rect), which a full-frame array
        cannot hold."""
        p = self.p
        dev = [torch.as_tensor(np.asarray(pl), dtype=torch.int32,
                               device=self.device) for pl in planes]
        n_slices = p.slice_count
        n_planes = len(self._plan)
        ctx_streams = [None] * (n_slices * n_planes)
        diff_streams = [None] * (n_slices * n_planes)
        if p.colorspace == 1:
            rb = max(p.bits, 8) + 1
            ctxs, diffs = phase_a_rgb_planes(dev, self._plan[0], p, self.qt,
                                             rb, self.five)
            for li, (c, d) in enumerate(zip(ctxs, diffs)):
                out = _to_host(c, d)
                for si in range(n_slices):
                    ctx_streams[si * n_planes + li] = out[0, si]
                    diff_streams[si * n_planes + li] = out[1, si]
            return ctx_streams, diff_streams
        for li, prects in enumerate(self._plan):
            # group slices by crop shape -> one batch per shape
            groups = {}
            for si, (x, y, w, h) in enumerate(prects):
                groups.setdefault((h, w), []).append(si)
            for (h, w), sis in groups.items():
                crops = torch.stack([dev[li][prects[si][1]:prects[si][1] + h,
                                             prects[si][0]:prects[si][0] + w]
                                     for si in sis])
                out = _to_host(*plane_context_diff(_wrap16(crops), self.qt,
                                                   p.bits, self.five))
                for k, si in enumerate(sis):
                    ctx_streams[si * n_planes + li] = out[0, k]
                    diff_streams[si * n_planes + li] = out[1, k]
        return ctx_streams, diff_streams

    def encode(self, planes, force_keyframe=None) -> bytes:
        gop = self.cfg.gop_size
        keyframe = (gop == 0 or self.picture_number % gop == 0)
        if force_keyframe is not None:
            keyframe = bool(force_keyframe)
        ctx_streams, diff_streams = self.phase_a(planes)
        pkt = self.native.encode_sym(planes, ctx_streams, diff_streams,
                                     keyframe)
        self.picture_number += 1
        return pkt
