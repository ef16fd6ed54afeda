"""Copy of ``ffmpeg_ffv2_tpu/ffv1/decoder.py``.

FFV1 frame decoder (ffv1dec.c:decode_frame/decode_slice).

Supports versions 0-4, range and Golomb-Rice coding, slice CRCs, damaged
slice concealment (copy from last picture), and non-keyframe context
persistence.
"""

from __future__ import annotations

import numpy as np

from ..coder.rac import RangeDecoder
from ..coder.bitio import BitReader
from ..core.crc import crc32_ieee
from ..core.pixfmt import PixelFormat, find_yuv_format, find_rgb_format
from .params import FFV1Params, CODER_GOLOMB, CODER_RANGE_CUSTOM, MAX_SLICES
from .codec_py import SliceState, decode_plane, decode_rgb
from . import headers as H


class FFV1Decoder:
    def __init__(self, width: int, height: int, extradata: bytes = b""):
        self.width = width
        self.height = height
        self.p: FFV1Params | None = None
        self.slice_states: list[SliceState] | None = None
        self.key_frame_ok = False
        self.last_planes = None
        if extradata:
            self.p = H.read_extradata(extradata, width, height)
            self._init_slices()

    def _init_slices(self):
        self.slice_states = [SliceState(self.p)
                             for _ in range(self.p.slice_count)]

    def _deduce_pix_fmt(self) -> PixelFormat:
        p = self.p
        if p.colorspace == 0:
            return find_yuv_format(p.bits, p.chroma_planes,
                                   p.chroma_h_shift, p.chroma_v_shift,
                                   p.transparency)
        return find_rgb_format(p.bits, p.transparency)

    def _alloc_planes(self):
        p = self.p
        w, h = self.width, self.height
        dt = np.int64
        planes = []
        if p.colorspace == 0:
            planes.append(np.zeros((h, w), dtype=dt))
            if p.chroma_planes:
                cw = -(-w >> p.chroma_h_shift)
                ch = -(-h >> p.chroma_v_shift)
                planes.append(np.zeros((ch, cw), dtype=dt))
                planes.append(np.zeros((ch, cw), dtype=dt))
            if p.transparency:
                planes.append(np.zeros((h, w), dtype=dt))
        else:
            n = 3 + (1 if p.transparency else 0)
            for _ in range(n):
                planes.append(np.zeros((h, w), dtype=dt))
        return planes

    def _slice_views(self, planes, rect):
        p = self.p
        x, y, w, h = rect
        out = []
        if p.colorspace == 0:
            out.append(planes[0][y:y + h, x:x + w])
            if p.chroma_planes:
                cx, cy = x >> p.chroma_h_shift, y >> p.chroma_v_shift
                cw = -(-w >> p.chroma_h_shift)
                ch = -(-h >> p.chroma_v_shift)
                out.append(planes[1][cy:cy + ch, cx:cx + cw])
                out.append(planes[2][cy:cy + ch, cx:cx + cw])
            if p.transparency:
                out.append(planes[-1][y:y + h, x:x + w])
        else:
            for pl in planes:
                out.append(pl[y:y + h, x:x + w])
        return out

    def _decode_slice(self, si: int, c: RangeDecoder, planes, keyframe: bool,
                      rect) -> bool:
        p = self.p
        ss = self.slice_states[si]
        ss.slice_rct_by = 1
        ss.slice_rct_ry = 1

        if p.version > 2:
            try:
                rect = H.read_slice_header(c, p, ss)
            except ValueError:
                ss.damaged = True
                return False
            # context counts may have changed with the quant table index
            if p.ac != CODER_GOLOMB:
                for i in range(p.plane_count):
                    need = ss.plane_ctx_count[i]
                    if ss.states[i].shape[0] != need:
                        ss.states[i] = np.full((need, 32), 128, dtype=np.uint8)

        if keyframe or ss.slice_reset_contexts:
            ss.clear()

        gb = None
        if p.ac == CODER_GOLOMB:
            if (p.version == 3 and p.micro_version > 1) or p.version > 3:
                c.get_fixed(129)
            start = c.pos - 1 if (p.version > 2 or si == 0) else 0
            gb = BitReader(c.buf[:c.end], start)

        sp = self._slice_views(planes, rect)
        fmt_name = self.pix_fmt.name if self.pix_fmt else ""
        if p.colorspace == 0 and (p.chroma_planes or not p.transparency):
            decode_plane(ss, c, gb, sp[0], 0, p.bits)
            if p.chroma_planes:
                decode_plane(ss, c, gb, sp[1], 1, p.bits)
                decode_plane(ss, c, gb, sp[2], 1, p.bits)
            if p.transparency:
                pi = 1 if (p.version >= 4 and not p.chroma_planes) else 2
                decode_plane(ss, c, gb, sp[-1], pi, p.bits)
        elif p.colorspace == 0:
            # ya8: luma + alpha interleaved as two planes here
            decode_plane(ss, c, gb, sp[0], 0, p.bits)
            decode_plane(ss, c, gb, sp[-1], 1, p.bits)
        else:
            decode_rgb(ss, c, gb, sp, p.bits)

        if p.ac != CODER_GOLOMB and p.version > 2:
            c.get_fixed(129)
            slack = c.end - c.pos - 2 - 5 * p.ec
            if slack:
                ss.damaged = True
                return False
        return True

    @property
    def pix_fmt(self) -> PixelFormat | None:
        return self._deduce_pix_fmt() if self.p else None

    def decode(self, packet: bytes):
        """Decode one packet; returns list of planes (coding order)."""
        c = RangeDecoder(packet)
        key_state = np.array([128], dtype=np.uint8)
        keyframe = bool(c.get(key_state, 0))

        if keyframe:
            self.key_frame_ok = False
            if self.p is None or self.p.version < 2:
                old = self.p
                self.p = H.read_v01_header(c, self.width, self.height)
                if (old is None or self.slice_states is None
                        or old.ac != self.p.ac
                        or old.context_counts != self.p.context_counts):
                    self._init_slices()
                else:
                    # keep persistent states; refresh derived params
                    for ss in self.slice_states:
                        ss.p = self.p
            self.key_frame_ok = True
        else:
            if not self.key_frame_ok:
                raise ValueError("non-keyframe without a valid keyframe")

        p = self.p

        # slice regions: [(offset, length incl. trailer)], front to back
        trailer = 3 + 5 * (1 if p.ec else 0)
        regions = []
        if p.version >= 3:
            end = len(packet)
            count = 0
            while count < MAX_SLICES and trailer < end:
                size = int.from_bytes(packet[end - trailer:end - trailer + 3],
                                      "big")
                if size + trailer > end:
                    break
                regions.append((end - size - trailer, size + trailer))
                end -= size + trailer
                count += 1
            regions.reverse()
            if len(regions) != p.slice_count:
                raise ValueError(
                    f"found {len(regions)} slices, expected {p.slice_count}")
        else:
            regions = [(0, len(packet))]

        planes = self._alloc_planes()
        rects = p.rects()

        for si, (off, length) in enumerate(regions):
            ss = self.slice_states[si]
            ss.damaged = False
            data = packet[off:off + length]
            if p.ec:
                if crc32_ieee(data) != 0:
                    ss.damaged = True
                    continue
            if si == 0:
                # slice 0 continues the frame-level coder
                sc = c
                c.end = off + length
            else:
                sc = RangeDecoder(data)
            if p.ac == CODER_RANGE_CUSTOM:
                sc.set_state_tables(p.state_transition)
            ok = self._decode_slice(si, sc, planes, keyframe, rects[si])
            if not ok:
                ss.damaged = True

        # damaged slice concealment: copy rect from last picture
        for si, ss in enumerate(self.slice_states):
            if ss.damaged and self.last_planes is not None:
                for dst, src in zip(self._slice_views(planes, rects[si]),
                                    self._slice_views(self.last_planes,
                                                      rects[si])):
                    dst[:] = src

        self.last_planes = planes
        return planes
