"""Copy of ``ffmpeg_ffv2_tpu/ffv2/codec.py``.

FFV2 encoder/decoder sessions.

Frame flow mirrors the reference (ffv2enc.c:ffv2_encode_frame /
ffv2dec.c:ffv2_decode_frame): planes -> Q12 coefficient planes (padded to
the 64-px superblock grid) -> lapped prefilter across SB borders ->
per-superblock recursive block coding (split tree via an adaptive CDF, a
4-bit transform type, DC coded losslessly with exp-golomb raw bits, PVQ
gain/shape per frequency band) -> Daala-EC packet.  Decode runs the exact
mirror with the postfilter after reconstruction.

The bitstream syntax is reference-compatible: pulse magnitudes use the
reference's qp-ary adaptive CDF (ffv2enc.c:181 / ffv2dec.c:128, alphabet
size == qp), with the PVQ search capped at |pulse| <= qp-1 — the alphabet
cannot represent |pulse| == qp, and the reference encoder's uncapped float
search writing that symbol is an out-of-bounds CDF access.  Pixel
reconstruction diverges deliberately: MXU-friendly matrix transforms (see
dsp.py) and exact integer gain math (see pvq.py) replace the reference's
float inverse path, so cross-decoded pixels are close but not identical.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.pixfmt import get_pix_fmt, PixelFormat
from .entropy import DaalaEncoder, DaalaDecoder, DaalaCDF
from . import dsp
from .pvq import pvq_search, band_reconstruct, icbrt

SB = dsp.SB_SIZE
SPLIT_END, SPLIT_XY, SPLIT_Y, SPLIT_X = range(4)
SPLIT_NB = 4

# pix_fmt ids on the wire = the reference's AVPixelFormat enum values
# (ffv2enc.c:449 codes avctx->pix_fmt as a uint bounded by AV_PIX_FMT_NB)
PIXFMT_WIRE_IDS = {
    "gray": 8, "yuv444p": 5, "yuv444p10": 70, "yuv444p12": 133,
    "gbrp": 73, "gbrp10": 77, "gbrp12": 137,
}
PIXFMT_WIRE_NB = 196
_WIRE_TO_NAME = {v: k for k, v in PIXFMT_WIRE_IDS.items()}


@dataclass
class FFV2Config:
    qp: int = 12             # -global_quality: pulses per band
    lossless: bool = False   # declared by the reference, not yet wired
    block_size: int = 64     # uniform leaf size; < 64 emits the XY
                             # quad-tree; 0 = activity-adaptive splits
    split_threshold: int = 40000   # Q12 variance above which an adaptive
                                   # block splits (block_size == 0)
    min_block_size: int = 8        # adaptive-mode floor


def split_tree(coeff, y0: int, x0: int, n: int, thresh: int,
               min_bs: int):
    """Activity-adaptive split decision over prefiltered Q12 coefficient
    planes (list/array [P, ph, pw]): split while the block's summed
    per-plane variance exceeds ``thresh`` and n > min_bs.  Returns a
    nested tuple: ("leaf",) or ("split", tl, tr, bl, br) — same shape on
    every encoder backend so device/host streams stay byte-identical."""
    if n <= max(min_bs, 4):
        return ("leaf",)
    cnt = n * n
    var_num = 0          # sum over planes of cnt*Σx² - (Σx)², exact int
    for p in range(len(coeff)):
        blk = np.asarray(coeff[p][y0:y0 + n, x0:x0 + n],
                         dtype=np.int64).ravel()
        s = int(blk.sum())
        ss = int((blk * blk).sum())
        var_num += cnt * ss - s * s
    if var_num <= thresh * cnt * cnt:
        return ("leaf",)
    h = n // 2
    return ("split",
            split_tree(coeff, y0, x0, h, thresh, min_bs),
            split_tree(coeff, y0, x0 + h, h, thresh, min_bs),
            split_tree(coeff, y0 + h, x0, h, thresh, min_bs),
            split_tree(coeff, y0 + h, x0 + h, h, thresh, min_bs))


def uniform_tree(n: int, bs: int):
    if n == bs or n <= 4:
        return ("leaf",)
    h = n // 2
    sub = uniform_tree(h, bs)
    return ("split", sub, sub, sub, sub)


def _pad_to_sb(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    ph = -(-h // SB) * SB
    pw = -(-w // SB) * SB
    out = np.zeros((ph, pw), dtype=np.int32)
    out[:h, :w] = plane
    return out


def _subdiv_cdf() -> DaalaCDF:
    # daalaent_cdf_alloc(&subdiv_cdf, 1, SPLIT_NB, 128, 0, 2, 0)
    return DaalaCDF(1, SPLIT_NB, 128, 0, 2, 0)


def _pulse_cdf(qp: int) -> DaalaCDF:
    # reference: daalaent_cdf_alloc(&test_cdf, 13, qp, 64, 0, 6, 0);
    return DaalaCDF(13, qp, 64, 0, 6, 0)


def _quant_block(e: DaalaEncoder, cdf: DaalaCDF, stream: np.ndarray,
                 qp: int, n: int):
    """Quantize+code one scanned block (ffv2enc.c:quant_block)."""
    dc = int(stream[0])
    e.encode_golomb(abs(dc))
    if dc:
        e.encode_bits(1 if dc < 0 else 0, 1)

    starts = dsp.band_starts(n)
    ac = stream[1:]
    for bi in range(len(starts) - 1):
        lo, hi = starts[bi], starts[bi + 1]
        # the last band extends one phantom position past the real
        # coefficients (ffv2_num_bands off-by-one) — treat it as 0
        band = np.zeros(hi - lo, dtype=np.int64)
        real = ac[lo:hi]
        band[:len(real)] = real
        igain = int(np.sum(band * band))
        cg = icbrt(igain)
        e.encode_golomb(cg)
        pulses = pvq_search(band, qp, max_abs=qp - 1)
        pcnt = 0
        for v in pulses:
            if pcnt >= qp:
                break
            av = int(abs(v))
            e.encode_cdf_adapt(cdf, av, bi % 13, qp)
            if av:
                e.encode_bits(1 if v < 0 else 0, 1)
            pcnt += av


def _dequant_block(d: DaalaDecoder, cdf: DaalaCDF, qp: int, n: int) \
        -> np.ndarray:
    stream = np.zeros(n * n, dtype=np.int64)
    dc = d.decode_golomb()
    if dc:
        dc *= 1 - 2 * d.decode_bits(1)
    stream[0] = dc

    starts = dsp.band_starts(n)
    for bi in range(len(starts) - 1):
        lo, hi = starts[bi], starts[bi + 1]
        length = hi - lo
        cg = d.decode_golomb()
        pulses = np.zeros(length, dtype=np.int64)
        pcnt = 0
        for j in range(length):
            if pcnt >= qp:
                break
            v = d.decode_cdf_adapt(cdf, bi % 13, qp)
            if v:
                v *= 1 - 2 * d.decode_bits(1)
            pulses[j] = v
            pcnt += abs(v)
        recon = band_reconstruct(pulses, cg)
        avail = len(stream) - 1 - lo      # phantom tail position dropped
        stream[1 + lo:1 + hi] = recon[:avail]
    return stream


class FFV2Encoder:
    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV2Config | None = None):
        self.cfg = config or FFV2Config()
        if pix_fmt not in PIXFMT_WIRE_IDS:
            raise ValueError(
                f"ffv2 supports {sorted(PIXFMT_WIRE_IDS)}, not {pix_fmt}")
        self.fmt = get_pix_fmt(pix_fmt)
        self.pix_fmt_name = pix_fmt
        self.width = width
        self.height = height
        self.planes = self.fmt.nb_planes

    def encode(self, planes) -> bytes:
        qp = self.cfg.qp
        e = DaalaEncoder()
        subdiv = _subdiv_cdf()
        pulse_cdf = _pulse_cdf(qp)

        depth = self.fmt.bits
        coeff = [dsp.lap_filter_frame_ver(
                    dsp.lap_filter_frame_hor(
                        _pad_to_sb(dsp.ref_to_coeff(np.asarray(p), depth)),
                        SB, 32, True),
                    SB, 32, True)
                 for p in planes]

        # frame header
        e.encode_uint(PIXFMT_WIRE_IDS[self.pix_fmt_name], PIXFMT_WIRE_NB)
        e.encode_golomb(qp)

        bs = self.cfg.block_size
        if bs not in (0, 4, 8, 16, 32, 64):
            raise ValueError("ffv2 block_size must be 0 (adaptive) or a "
                             "power of 2 in 4..64")

        def leaf(y0, x0, n):
            e.encode_bits(dsp.TX_DCT, 4)
            for p in range(self.planes):
                blk = coeff[p][y0:y0 + n, x0:x0 + n]
                txed = dsp.fwd_tx_2d(blk, dsp.TX_DCT)
                stream = dsp.raster_to_coding(txed)
                _quant_block(e, pulse_cdf, stream, qp, n)

        def block_rec(tree, y0, x0, n):
            # split tree (ffv2enc.c:encode_block_rec): the reference RDO
            # stub always codes END at 64x64; we follow a uniform or
            # activity-adaptive quad-tree (4x4 carries no split symbol)
            if tree[0] == "leaf":
                if n > 4:
                    e.encode_cdf_adapt(subdiv, SPLIT_END, 0, SPLIT_NB)
                leaf(y0, x0, n)
                return
            e.encode_cdf_adapt(subdiv, SPLIT_XY, 0, SPLIT_NB)
            h = n // 2
            block_rec(tree[1], y0, x0, h)
            block_rec(tree[2], y0, x0 + h, h)
            block_rec(tree[3], y0 + h, x0, h)
            block_rec(tree[4], y0 + h, x0 + h, h)

        ph, pw = coeff[0].shape
        for y0 in range(0, ph, SB):
            for x0 in range(0, pw, SB):
                if bs == 0:
                    tree = split_tree(coeff, y0, x0, SB,
                                      self.cfg.split_threshold,
                                      self.cfg.min_block_size)
                else:
                    tree = uniform_tree(SB, bs)
                block_rec(tree, y0, x0, SB)
        return e.done()


class FFV2Decoder:
    def __init__(self, width: int, height: int, osd: bool = False):
        self.width = width
        self.height = height
        self.fmt: PixelFormat | None = None
        self.osd = osd
        self.last_qp = 0
        self._frame_no = 0

    def decode(self, packet: bytes):
        """Decode one packet; with osd=True, stamp the reference's debug
        overlay into 8-bit luma (ffv2dec.c:357-371)."""
        from .osd import OsdTimer, osd_lines, stamp_osd
        with OsdTimer() as t:
            out = self._decode(packet)
        if self.osd:
            from .. import __version__
            ph = -(-self.height // SB) * SB
            pw = -(-self.width // SB) * SB
            stamp_osd(out[0], self.fmt.bits, osd_lines(
                __version__, self.width, self.height, pw // SB, ph // SB,
                self.fmt.name, self._frame_no, self._frame_no, len(packet),
                t.ms, self.last_qp))
        self._frame_no += 1
        return out

    def _decode(self, packet: bytes):
        d = DaalaDecoder(packet)
        subdiv = _subdiv_cdf()

        wire_id = d.decode_uint(PIXFMT_WIRE_NB)
        name = _WIRE_TO_NAME.get(wire_id)
        if name is None:
            raise ValueError(f"unknown pix_fmt id {wire_id} in stream")
        self.fmt = get_pix_fmt(name)
        qp = self.last_qp = d.decode_golomb()
        pulse_cdf = _pulse_cdf(qp)

        nplanes = self.fmt.nb_planes
        depth = self.fmt.bits
        ph = -(-self.height // SB) * SB
        pw = -(-self.width // SB) * SB
        coeff = [np.zeros((ph, pw), dtype=np.int64) for _ in range(nplanes)]

        def leaf(y0, x0, n):
            tx_type = d.decode_bits(4)
            for p in range(nplanes):
                stream = _dequant_block(d, pulse_cdf, qp, n)
                blk = dsp.coding_to_raster(stream, n)
                coeff[p][y0:y0 + n, x0:x0 + n] = \
                    dsp.inv_tx_2d(blk.astype(np.int32), tx_type)

        def block_rec(y0, x0, n):
            # ffv2dec.c:decode_block_rec — 4x4 leaves carry no split
            # symbol; only the square XY split maps to a real layout
            # (ffv2_partition_layout_freq off-diagonals are NULL)
            if n == 4:
                leaf(y0, x0, n)
                return
            split = d.decode_cdf_adapt(subdiv, 0, SPLIT_NB)
            if split == SPLIT_END:
                leaf(y0, x0, n)
                return
            if split != SPLIT_XY:
                raise NotImplementedError(
                    "non-square X/Y splits have no frequency layout "
                    "(NULL in the reference's layout table)")
            h = n // 2
            block_rec(y0, x0, h)
            block_rec(y0, x0 + h, h)
            block_rec(y0 + h, x0, h)
            block_rec(y0 + h, x0 + h, h)

        for y0 in range(0, ph, SB):
            for x0 in range(0, pw, SB):
                block_rec(y0, x0, SB)

        out = []
        for p in range(nplanes):
            c = dsp.lap_filter_frame_hor(
                dsp.lap_filter_frame_ver(coeff[p], SB, 32, False),
                SB, 32, False)
            pix = dsp.coeff_to_ref(c.astype(np.int32), depth)
            mx = (1 << depth) - 1
            out.append(np.clip(pix[:self.height, :self.width], 0, mx))
        return out
