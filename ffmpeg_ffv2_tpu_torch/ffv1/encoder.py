"""Copy of ``ffmpeg_ffv2_tpu/ffv1/encoder.py``.

FFV1 frame encoder — packet assembly over the scalar slice codec.

Mirrors ffv1enc.c:encode_frame/encode_slice.  This is the reference-exact
host path; the TPU path (tpu.py) produces identical bytes via a
parallel-modeling + sliced-entropy-coding pipeline.
"""

from __future__ import annotations

import numpy as np

from ..coder.rac import RangeEncoder
from ..coder.bitio import BitWriter
from ..core.crc import crc32_trailer
from ..core.pixfmt import PixelFormat
from .params import FFV1Config, FFV1Params, params_from_config, CODER_GOLOMB, CODER_RANGE_CUSTOM
from .codec_py import SliceState, encode_plane, encode_rgb
from . import headers as H
from .rct import choose_rct_params


def ceil_rshift(v: int, s: int) -> int:
    return -(-v >> s) if s else v


class FFV1Encoder:
    """Stateful encoder session (context carries across non-key frames)."""

    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV1Config | None = None):
        self.cfg = config or FFV1Config()
        self.p = params_from_config(self.cfg, pix_fmt, width, height)
        self.picture_number = 0
        self.slice_states = [SliceState(self.p) for _ in range(self.p.slice_count)]
        self.extradata = (H.write_extradata(self.p)
                          if self.p.version > 1 else b"")

    # -- helpers ----------------------------------------------------------

    def _slice_planes(self, planes: list[np.ndarray], rect):
        """Crop per-plane views for a slice rect."""
        p = self.p
        x, y, w, h = rect
        out = []
        if p.colorspace == 0:
            out.append(planes[0][y:y + h, x:x + w])
            if p.chroma_planes:
                cx, cy = x >> p.chroma_h_shift, y >> p.chroma_v_shift
                cw = ceil_rshift(w, p.chroma_h_shift)
                ch = ceil_rshift(h, p.chroma_v_shift)
                out.append(planes[1][cy:cy + ch, cx:cx + cw])
                out.append(planes[2][cy:cy + ch, cx:cx + cw])
            if p.transparency:
                out.append(planes[-1][y:y + h, x:x + w])
        else:
            for pl in planes:
                out.append(pl[y:y + h, x:x + w])
        return out

    def _encode_slice(self, si: int, c: RangeEncoder,
                      planes: list[np.ndarray], keyframe: bool) -> bytes:
        p = self.p
        ss = self.slice_states[si]
        rect = p.rects()[si]
        ss.slice_coding_mode = 0
        if p.version > 3 and p.colorspace == 1:
            ss.slice_rct_by, ss.slice_rct_ry = choose_rct_params(
                self._slice_planes(planes, rect), p.bits)
        else:
            ss.slice_rct_by = 1
            ss.slice_rct_ry = 1

        if keyframe:
            ss.clear()
        if p.version > 2:
            H.write_slice_header(c, p, ss, rect)

        pb = None
        ac_bytes = b""
        if p.ac == CODER_GOLOMB:
            if p.version > 2 or si == 0:
                ac_bytes = c.terminate(1 if p.version > 2 else 0)
            pb = BitWriter()

        sp = self._slice_planes(planes, rect)
        if p.colorspace == 0 and not (p.pix_fmt and p.pix_fmt.name == "ya8"):
            encode_plane(ss, c, pb, sp[0], 0, p.bits)
            if p.chroma_planes:
                encode_plane(ss, c, pb, sp[1], 1, p.bits)
                encode_plane(ss, c, pb, sp[2], 1, p.bits)
            if p.transparency:
                encode_plane(ss, c, pb, sp[-1], 2, p.bits)
        elif p.pix_fmt and p.pix_fmt.name == "ya8":
            encode_plane(ss, c, pb, sp[0], 0, p.bits)
            encode_plane(ss, c, pb, sp[-1], 1, p.bits)
        else:
            encode_rgb(ss, c, pb, sp, p.bits)

        if p.ac == CODER_GOLOMB:
            return ac_bytes + pb.flush()
        return c.terminate(1)

    # -- public API -------------------------------------------------------

    def encode(self, planes: list[np.ndarray], force_keyframe=None) -> bytes:
        """Encode one frame; ``planes`` in coding order:
        YUV: [y, u, v, (a)]; RGB: [g, b, r, (a)] at native bit depth."""
        p = self.p
        gop = self.cfg.gop_size
        keyframe = (gop == 0 or self.picture_number % gop == 0)
        if force_keyframe is not None:
            keyframe = bool(force_keyframe)

        c0 = RangeEncoder()
        key_state = np.array([128], dtype=np.uint8)
        c0.put(key_state, 0, 1 if keyframe else 0)
        if keyframe and p.version < 2:
            H.write_v01_header(c0, p)
        elif keyframe and p.version == 2:
            H.write_v2_slice_table(c0, p, self.slice_states)

        if p.ac == CODER_RANGE_CUSTOM:
            c0.set_state_tables(p.state_transition)

        chunks = []
        for si in range(p.slice_count):
            if si == 0:
                c = c0
            else:
                c = RangeEncoder()
                if p.ac == CODER_RANGE_CUSTOM:
                    c.set_state_tables(p.state_transition)
            data = self._encode_slice(si, c, planes, keyframe)
            if si > 0 or p.version > 2:
                assert len(data) < (1 << 24)
                data += len(data).to_bytes(3, "big")
                if p.ec:
                    data += b"\x00"
                    data += crc32_trailer(data)
            chunks.append(data)

        self.picture_number += 1
        return b"".join(chunks)
