"""Copy of ``ffmpeg_ffv2_tpu/ffv2/osd.py``.

FFV2 decoder debug OSD — the reference's only FFV2 validation instrument.

Reproduces the reference decoder's on-screen overlay (ffv2dec.c:284-313,
357-371): eight status lines rendered with the 8x8 CGA PC font
(libavutil/xga_font_data.c avpriv_cga_font) into the 8-bit luma plane,
starting at row 8, one line every 10 rows, character i at column (i+1)*8,
foreground 255 / background 0 (cga_data.c ff_draw_pc_font semantics: the
whole 8x8 cell is overwritten).  Depths other than 8 are a no-op, as in the
reference.

The reference hardcodes the overlay on (#define DEBUGGING, ffv2dec.c:88);
here it is an opt-in decoder debug option (`osd=True`).
"""

from __future__ import annotations

import os
import time

import numpy as np

_FONT = None


def _font() -> np.ndarray:
    """avpriv_cga_font as a [256, 8, 8] boolean glyph atlas."""
    global _FONT
    if _FONT is None:
        raw = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "cga_font.npy"))
        bits = np.unpackbits(raw.reshape(256, 8, 1), axis=2)
        _FONT = bits.astype(bool)
    return _FONT


def draw_pc_font(dst: np.ndarray, y: int, x: int, ch: int,
                 fg: int = 255, bg: int = 0) -> None:
    """Blit one 8x8 CGA glyph at (y, x); clips at plane edges.
    Matches cga_data.c ff_draw_pc_font with both fg and bg written."""
    glyph = _font()[ch & 0xFF]
    h, w = dst.shape
    gh, gw = min(8, h - y), min(8, w - x)
    if gh <= 0 or gw <= 0:
        return
    cell = np.where(glyph[:gh, :gw], np.uint8(fg), np.uint8(bg))
    dst[y:y + gh, x:x + gw] = cell


def draw_text_line(dst: np.ndarray, y: int, text: str) -> None:
    """One OSD line: character i at column (i+1)*8 (ffv2dec.c:298-303)."""
    for i, ch in enumerate(text[:49]):        # sbuf[50] in the reference
        draw_pc_font(dst, y, (i + 1) * 8, ord(ch))


def stamp_osd(luma: np.ndarray, depth: int, lines: list[str]) -> None:
    """Stamp the overlay block: first line at row 8, step 10
    (ffv2dec.c:360 dst1 = data[0] + linesize*8; :311 dst1 += linesize*10).
    No-op for depth != 8, like print_debug_info (ffv2dec.c:295-296)."""
    if depth != 8:
        return
    y = 8
    for line in lines:
        draw_text_line(luma, y, line)
        y += 10


def osd_lines(version: str, width: int, height: int, num_sb_x: int,
              num_sb_y: int, pix_fmt: str, pts, dts, pkt_size: int,
              dec_time_ms: int, qp: int) -> list[str]:
    """The reference's eight PRINT_OSD_DEBUG lines (ffv2dec.c:362-369)."""
    return [
        "FFV2 rev: %s" % version,
        "Frame size: %d x %d" % (width, height),
        "Superblocks: %d x %d" % (num_sb_x, num_sb_y),
        "Pixfmt: %s" % pix_fmt,
        "PTS: %d   DTS: %d" % (pts, dts),
        "Packet size: %0.2f kb" % (pkt_size * 0.001),
        "Decoding time: %d msec" % dec_time_ms,
        "Quantizer: %d" % qp,
    ]


class OsdTimer:
    """Wall-clock per-frame decode timer (gettimeofday pair in the
    reference, ffv2dec.c:327,359-361)."""

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.ms = int((time.monotonic() - self.t0) * 1000)
        return False
