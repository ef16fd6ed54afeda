"""Counterpart of ``ffmpeg_ffv2_tpu/ffv2/native.py``: native (C++) FFV2
sessions with the device front and back on the card.

Packets are byte-identical to the pure-Python codec (``ffv2/codec.py``).
The Daala entropy coder and the band loops run in the port's native
library (``native/ffv2_runtime.cpp``, built with the FFV1 runtime by
``ffv1/native.py``); everything between pixels and the entropy coder runs
in ``ffv2/device.py`` on the session's device: ``device="cuda"`` (the
default; ``RuntimeError`` without a card) launches the CUDA kernels,
``"cpu"`` runs their plain versions.  Where the JAX module falls back to
numpy when jax is missing, nothing falls back here: the host path is
explicit, ``NativeFFV2Encoder.encode_host`` and
``NativeFFV2Decoder.decode_host`` (numpy ``dsp`` with the C quantizer
``ffv2rt_enc_frame``, and the numpy decode), the oracles of the tests and
of ``chip_smoke.py``, which nothing else calls.
"""

from __future__ import annotations

import collections
import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.pixfmt import get_pix_fmt, PixelFormat
from ..ffv1.native import get_lib
from ..utils.metrics import TRACE
from . import device as dv
from . import dsp
from .codec import (FFV2Config, PIXFMT_WIRE_IDS, PIXFMT_WIRE_NB,
                    _WIRE_TO_NAME, SPLIT_END, split_tree, uniform_tree)
from .entropy import cdf_triangle, _log2p1, UINT_BITS
from .pvq import icbrt_array

SB = dsp.SB_SIZE


def _bind(lib):
    if getattr(lib, "_ffv2_bound", False):
        return lib
    lib.ffv2rt_enc_create.restype = ctypes.c_void_p
    lib.ffv2rt_enc_create.argtypes = [ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int]
    lib.ffv2rt_enc_destroy.argtypes = [ctypes.c_void_p]
    lib.ffv2rt_enc_golomb.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.ffv2rt_enc_bits.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.c_int]
    lib.ffv2rt_enc_cdf_q15.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_uint16),
                                       ctypes.c_int]
    lib.ffv2rt_enc_frame.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
    lib.ffv2rt_enc_frame_q.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.ffv2rt_enc_split.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ffv2rt_enc_leaf.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int]
    lib.ffv2rt_enc_set_bands.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_int]
    lib.ffv2rt_dec_set_bands.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_int]
    lib.ffv2rt_dec_split.restype = ctypes.c_int
    lib.ffv2rt_dec_split.argtypes = [ctypes.c_void_p]
    lib.ffv2rt_dec_leaf.restype = ctypes.c_int
    lib.ffv2rt_dec_leaf.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int, ctypes.c_int]
    lib.ffv2rt_enc_done.restype = ctypes.c_int64
    lib.ffv2rt_enc_done.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64]
    lib.ffv2rt_dec_create.restype = ctypes.c_void_p
    lib.ffv2rt_dec_create.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_int64]
    lib.ffv2rt_dec_destroy.argtypes = [ctypes.c_void_p]
    lib.ffv2rt_dec_set_qp.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int]
    lib.ffv2rt_dec_golomb.restype = ctypes.c_uint32
    lib.ffv2rt_dec_golomb.argtypes = [ctypes.c_void_p]
    lib.ffv2rt_dec_bits.restype = ctypes.c_uint32
    lib.ffv2rt_dec_bits.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ffv2rt_dec_cdf_q15.restype = ctypes.c_int
    lib.ffv2rt_dec_cdf_q15.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_uint16),
                                       ctypes.c_int]
    lib._ffv2_bound = True
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _enc_uint(lib, h, val, num):
    """ff_daalaent_encode_uint via the Q15 triangle CDFs."""
    if num > (1 << UINT_BITS):
        bit = _log2p1(num - 1) - UINT_BITS
        num -= 1
        adr = (num >> bit) + 1
        cdf = np.ascontiguousarray(cdf_triangle(adr), dtype=np.uint16)
        lib.ffv2rt_enc_cdf_q15(h, val >> bit, _ptr(cdf, ctypes.c_uint16),
                               adr)
        lib.ffv2rt_enc_bits(h, val & ((1 << bit) - 1), bit)
    else:
        cdf = np.ascontiguousarray(cdf_triangle(num), dtype=np.uint16)
        lib.ffv2rt_enc_cdf_q15(h, val, _ptr(cdf, ctypes.c_uint16), num)


def _dec_uint(lib, h, num):
    if num > (1 << UINT_BITS):
        num -= 1
        bit = _log2p1(num) - UINT_BITS
        adr = (num >> bit) + 1
        cdf = np.ascontiguousarray(cdf_triangle(adr), dtype=np.uint16)
        t = lib.ffv2rt_dec_cdf_q15(h, _ptr(cdf, ctypes.c_uint16), adr)
        t = (t << bit) | lib.ffv2rt_dec_bits(h, bit)
        return min(t, num)
    cdf = np.ascontiguousarray(cdf_triangle(num), dtype=np.uint16)
    return lib.ffv2rt_dec_cdf_q15(h, _ptr(cdf, ctypes.c_uint16), num)


def _host_tx(blocks, inverse):
    """The numpy transform of JAX's host path, one block at a time."""
    fn = dsp.inv_tx_2d if inverse else dsp.fwd_tx_2d
    return np.stack([fn(b) for b in blocks])


def _host_prefilter(padded, depth):
    return np.stack([
        dsp.lap_filter_frame_ver(
            dsp.lap_filter_frame_hor(dsp.ref_to_coeff(pl, depth),
                                     SB, 32, True), SB, 32, True)
        for pl in padded])


def _host_postfilter(coeff, depth, height, width):
    mx = (1 << depth) - 1
    out = []
    for c in coeff:
        c = dsp.lap_filter_frame_hor(
            dsp.lap_filter_frame_ver(c, SB, 32, False), SB, 32, False)
        pix = dsp.coeff_to_ref(c.astype(np.int32), depth)
        out.append(np.clip(pix[:height, :width], 0, mx))
    return out


def _pad_px(plane, depth):
    """Pad a PIXEL plane to the SB grid with mid-grey (the pixel value
    whose Q12 coefficient is 0 — matches padding the coeff plane with 0)."""
    h, w = plane.shape
    ph = -(-h // SB) * SB
    pw = -(-w // SB) * SB
    out = np.full((ph, pw), 1 << (depth - 1), dtype=np.int32)
    out[:h, :w] = plane
    return out


def _leaves_of(trees, ph, pw):
    """Leaves (y0, x0, n) of each SB's tree, in walk order (TL, TR, BL,
    BR)."""
    leaves = []

    def collect(tree, y0, x0, n):
        if tree[0] == "leaf":
            leaves.append((y0, x0, n))
            return
        half = n // 2
        collect(tree[1], y0, x0, half)
        collect(tree[2], y0, x0 + half, half)
        collect(tree[3], y0 + half, x0, half)
        collect(tree[4], y0 + half, x0 + half, half)

    for y0 in range(0, ph, SB):
        for x0 in range(0, pw, SB):
            collect(trees[(y0, x0)], y0, x0, SB)
    return leaves


def _leaf_index(yx, n, dev):
    """Row and column indices [L, n, n] of the n x n leaves whose corners
    are ``yx`` [L, 2]: ``c[:, ys, xs]`` is their blocks [P, L, n, n]."""
    r = torch.arange(n, device=dev)
    ys = torch.as_tensor(yx[:, 0], device=dev)[:, None, None] \
        + r[None, :, None]
    xs = torch.as_tensor(yx[:, 1], device=dev)[:, None, None] \
        + r[None, None, :]
    return ys, xs


class NativeFFV2Encoder:
    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV2Config | None = None, device="cuda"):
        self.cfg = config or FFV2Config()
        if pix_fmt not in PIXFMT_WIRE_IDS:
            raise ValueError(f"unsupported ffv2 pix_fmt {pix_fmt}")
        self.fmt = get_pix_fmt(pix_fmt)
        self.pix_fmt_name = pix_fmt
        self.width = width
        self.height = height
        self.planes = self.fmt.nb_planes
        self.device = dv._device(device)
        self.lib = _bind(get_lib())

    def _pad(self, planes):
        return np.stack([_pad_px(np.asarray(p), self.fmt.bits)
                         for p in planes])

    def _open(self):
        """A native encoder with the frame header coded."""
        lib = self.lib
        bands = np.asarray(dsp.band_starts(SB), dtype=np.int32)
        h = lib.ffv2rt_enc_create(self.cfg.qp, _ptr(bands, ctypes.c_int32),
                                  len(bands))
        _enc_uint(lib, h, PIXFMT_WIRE_IDS[self.pix_fmt_name], PIXFMT_WIRE_NB)
        lib.ffv2rt_enc_golomb(h, self.cfg.qp)
        return h

    def encode(self, planes, mark=TRACE, front_q=None) -> bytes:
        """Encode one frame on the session's device; ``mark`` is called
        after each stage (``metrics.TRACE`` by default).  ``front_q``
        optionally replaces the device front (``device.encode_front_q``) with a
        drop-in of the JAX package's contract, ``front_q(padded, depth,
        qp, bands)`` -> numpy (dc, pulses, igain): the SB-banded
        ``parallel.ffv2.encode_front_q_sharded``, for one; the packet stays
        byte-identical.  A split tree (block_size != 64) takes no front."""
        padded = self._pad(planes)
        h = self._open()
        mark("host pad + header")
        try:
            if self.cfg.block_size != SB:
                self._encode_split_tree(h, padded, self.cfg.block_size)
            else:
                # Q12, lapped prefilter, transform, zigzag, PVQ pulses and
                # gain split sums on the device: ~1 byte a coefficient
                # comes down
                self._code_stage_into(h, self._front_stage(padded, mark,
                                                           front_q))
                mark("host Daala coder")
            return self._done(h)
        finally:
            self.lib.ffv2rt_enc_destroy(h)

    def encode_host(self, planes) -> bytes:
        """The numpy host path (the JAX module's path without jax):
        ``dsp``'s prefilter and block transforms, then the C quantizer
        (``ffv2rt_enc_frame``) or, for a split tree, the C leaf coder.
        The oracle of the device path."""
        lib = self.lib
        padded = self._pad(planes)
        h = self._open()
        try:
            if self.cfg.block_size != SB:
                self._encode_split_tree(h, padded, self.cfg.block_size,
                                        host=True)
                return self._done(h)
            ph, pw = padded.shape[1:]
            nby, nbx = ph // SB, pw // SB
            stacked = _host_prefilter(padded, self.fmt.bits).reshape(
                self.planes, nby, SB, nbx, SB)
            blocks = np.ascontiguousarray(
                stacked.transpose(1, 3, 0, 2, 4)).reshape(-1, SB, SB)
            txed = _host_tx(blocks.astype(np.int32), inverse=False)
            streams = np.ascontiguousarray(
                txed.reshape(len(txed), -1)[:, dsp.scan_order(SB)]
                .astype(np.int64))
            lib.ffv2rt_enc_frame(h, _ptr(streams, ctypes.c_int64),
                                 nby * nbx, self.planes, SB, dsp.TX_DCT)
            return self._done(h)
        finally:
            lib.ffv2rt_enc_destroy(h)

    def _front_stage(self, padded, mark=TRACE, front_q=None):
        """Device stage of the q-path: Q12/lapping/transform/PVQ on the
        device plus the integer-cbrt gain fold on the host — everything up
        to the serial Daala EC.  Returns the (dc, cg, pulses, geometry)
        tuple ``_code_stage_into`` consumes; a pure function of the frame,
        so frames can be staged ahead of the entropy coder."""
        ph, pw = padded.shape[1:]
        bands = list(dsp.band_starts(SB))
        if front_q is None:
            dc, pulses, igain = dv.encode_front_q(
                padded, self.fmt.bits, self.cfg.qp, bands,
                device=self.device, mark=mark)
        else:
            dc, pulses, igain = front_q(padded, self.fmt.bits, self.cfg.qp,
                                        bands)
            mark("front_q")
        cg = icbrt_array(np.asarray(igain))
        mark("host icbrt")
        return (np.ascontiguousarray(dc, dtype=np.int64),
                np.ascontiguousarray(cg),
                np.ascontiguousarray(pulses),
                int(igain.shape[1]), (ph // SB) * (pw // SB))

    def _code_stage_into(self, h, fr):
        """Serial Daala EC over a staged front (C++; the ctypes call
        releases the GIL, so the EC of frame t can overlap frame t+1's
        front on another thread)."""
        dc64, cg, pulses, nbands, nblocks = fr
        self.lib.ffv2rt_enc_frame_q(
            h, _ptr(dc64, ctypes.c_int64), _ptr(cg, ctypes.c_int32),
            _ptr(pulses, ctypes.c_int8), pulses.shape[1], nbands, nblocks,
            self.planes, SB, dsp.TX_DCT)

    def _encode_split_tree(self, h, padded, bs, host=False):
        """Quad-tree leaves (uniform bs, or activity-adaptive when bs ==
        0) under the XY split syntax (ffv2enc.c:encode_block_rec order:
        TL, TR, BL, BR).  On the device the prefilter runs on K19 and the
        transforms batch per leaf size; the split decisions and the leaf
        coding stay on the host, as in the JAX module."""
        lib = self.lib
        depth = self.fmt.bits
        ph, pw = padded.shape[1:]
        if host:
            coeff = _host_prefilter(padded, depth)
        else:
            c = dv.prefilter_t(dv.upload(padded, depth, self.device), depth,
                               SB)
            coeff = c.cpu().numpy() if bs == 0 else None
        trees = {}
        for y0 in range(0, ph, SB):
            for x0 in range(0, pw, SB):
                trees[(y0, x0)] = (
                    split_tree(coeff, y0, x0, SB, self.cfg.split_threshold,
                               self.cfg.min_block_size) if bs == 0
                    else uniform_tree(SB, bs))
        leaves = _leaves_of(trees, ph, pw)

        # transforms batched per leaf size, scanned streams per leaf
        streams_by_leaf = {}
        for n in sorted({n for (_, _, n) in leaves}):
            bands = np.asarray(dsp.band_starts(n), dtype=np.int32)
            lib.ffv2rt_enc_set_bands(h, n, _ptr(bands, ctypes.c_int32),
                                     len(bands))
            idxs = [i for i, lf in enumerate(leaves) if lf[2] == n]
            yx = np.asarray([leaves[i][:2] for i in idxs], dtype=np.int64)
            if host:
                blocks = np.stack([
                    coeff[p, y0:y0 + n, x0:x0 + n]
                    for y0, x0 in yx for p in range(self.planes)
                ]).astype(np.int32)
                scanned = _host_tx(blocks, inverse=False).reshape(
                    len(blocks), -1)[:, dsp.scan_order(n)]
            else:
                ys, xs = _leaf_index(yx, n, c.device)
                blocks = c[:, ys, xs].transpose(0, 1).reshape(-1, n, n)
                scanned = dv.scan_t(dv.tx_batch_t(
                    blocks, dsp.TX_DCT, False)).cpu().numpy()
            scanned = np.ascontiguousarray(scanned.astype(np.int64))
            for k, i in enumerate(idxs):
                streams_by_leaf[i] = scanned[k * self.planes:
                                             (k + 1) * self.planes]

        li = iter(range(len(leaves)))

        def walk(tree, n):
            if tree[0] == "leaf":
                if n > 4:
                    lib.ffv2rt_enc_split(h, SPLIT_END)
                sub = streams_by_leaf[next(li)]
                lib.ffv2rt_enc_leaf(h, _ptr(sub, ctypes.c_int64),
                                    self.planes, n, dsp.TX_DCT)
                return
            lib.ffv2rt_enc_split(h, 1)          # SPLIT_XY
            for sub in tree[1:]:
                walk(sub, n // 2)

        for y0 in range(0, ph, SB):
            for x0 in range(0, pw, SB):
                walk(trees[(y0, x0)], SB)

    def _done(self, h) -> bytes:
        cap = 1 << 24
        out = np.empty(cap, dtype=np.uint8)
        n = self.lib.ffv2rt_enc_done(h, _ptr(out, ctypes.c_uint8), cap)
        if n < 0:
            raise RuntimeError("ffv2 native encode overflow")
        return out[:n].tobytes()


class PipelinedFFV2Encoder:
    """Frame-pipelined FFV2 encoder.

    The Daala entropy coder is one serial chain a frame by format design
    (reference: libavcodec/daala_entropy.c — a single adaptive CDF state
    threads every symbol), so it cannot be split within a frame.
    Parallelism comes from pipelining frames: the C++ EC of frame t runs
    on a worker thread (ctypes releases the GIL for the whole call) while
    the caller's thread runs frame t+1's device front.  Packets are
    byte-identical to ``NativeFFV2Encoder``'s, because the EC is a pure
    function of the staged (dc, cg, pulses).

    Monolithic-SB (block_size = 64) q-path only; other configs encode each
    frame with the sequential encoder.
    """

    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV2Config | None = None, depth: int = 2,
                 device="cuda"):
        self.enc = NativeFFV2Encoder(width, height, pix_fmt, config, device)
        self.depth = max(1, depth)
        self.pool = ThreadPoolExecutor(max_workers=self.depth)

    def _code_one(self, fr) -> bytes:
        enc = self.enc
        h = enc._open()
        try:
            enc._code_stage_into(h, fr)
            return enc._done(h)
        finally:
            enc.lib.ffv2rt_enc_destroy(h)

    def encode_stream(self, frames, front_q=None):
        """Encode an iterable of frames; returns packets in order.  Keeps
        at most ``depth`` frames in flight: frame t's EC overlaps frame
        t+1's device front.  ``front_q`` as in
        ``NativeFFV2Encoder.encode``."""
        enc = self.enc
        if enc.cfg.block_size != SB:
            return [enc.encode(f) for f in frames]
        pend = collections.deque()
        out = []
        for planes in frames:
            fr = enc._front_stage(enc._pad(planes), front_q=front_q)
            pend.append(self.pool.submit(self._code_one, fr))
            while len(pend) >= self.depth:
                out.append(pend.popleft().result())
        while pend:
            out.append(pend.popleft().result())
        return out

    def close(self):
        self.pool.shutdown(wait=True)


class NativeFFV2Decoder:
    def __init__(self, width: int, height: int, osd: bool = False,
                 device="cuda"):
        self.width = width
        self.height = height
        self.fmt: PixelFormat | None = None
        self.device = dv._device(device)
        self.lib = _bind(get_lib())
        self.osd = osd
        self.last_qp = 0
        self._frame_no = 0

    def decode(self, packet: bytes, mark=TRACE):
        """Decode one packet on the session's device; with osd=True, stamp
        the reference's debug overlay into 8-bit luma
        (ffv2dec.c:357-371)."""
        from .osd import OsdTimer, osd_lines, stamp_osd
        with OsdTimer() as t:
            out = self._decode(packet, False, mark)
        if self.osd:
            from .. import __version__
            ph = -(-self.height // SB) * SB
            pw = -(-self.width // SB) * SB
            out = [np.ascontiguousarray(pl) for pl in out]
            stamp_osd(out[0], self.fmt.bits, osd_lines(
                __version__, self.width, self.height, pw // SB, ph // SB,
                self.fmt.name, self._frame_no, self._frame_no, len(packet),
                t.ms, self.last_qp))
        self._frame_no += 1
        return out

    def decode_host(self, packet: bytes):
        """The numpy host decode (the JAX module's path without jax): the
        C leaf decode, ``dsp``'s inverse transforms and postfilter.  The
        oracle of the device path; no OSD."""
        return self._decode(packet, True)

    def _decode(self, packet: bytes, host: bool, mark=TRACE):
        lib = self.lib
        buf = np.frombuffer(packet, dtype=np.uint8)
        h = lib.ffv2rt_dec_create(_ptr(buf, ctypes.c_uint8), len(packet))
        try:
            wire = _dec_uint(lib, h, PIXFMT_WIRE_NB)
            name = _WIRE_TO_NAME.get(int(wire))
            if name is None:
                raise ValueError(f"unknown pix_fmt id {wire} in stream")
            self.fmt = get_pix_fmt(name)
            qp = self.last_qp = int(lib.ffv2rt_dec_golomb(h))
            bands = np.asarray(dsp.band_starts(SB), dtype=np.int32)
            lib.ffv2rt_dec_set_qp(h, qp, _ptr(bands, ctypes.c_int32),
                                  len(bands))
            nplanes = self.fmt.nb_planes
            ph = -(-self.height // SB) * SB
            pw = -(-self.width // SB) * SB
            for n in (4, 8, 16, 32):
                b = np.asarray(dsp.band_starts(n), dtype=np.int32)
                lib.ffv2rt_dec_set_bands(h, n, _ptr(b, ctypes.c_int32),
                                         len(b))

            # walk the split tree (ffv2dec.c:decode_block_rec) collecting
            # leaves; the inverse transforms batch afterwards
            leaves = []       # (y0, x0, n, streams [nplanes, n*n])

            def walk(y0, x0, n):
                if n > 4:
                    split = lib.ffv2rt_dec_split(h)
                    if split == 1:                       # SPLIT_XY
                        half = n // 2
                        walk(y0, x0, half)
                        walk(y0, x0 + half, half)
                        walk(y0 + half, x0, half)
                        walk(y0 + half, x0 + half, half)
                        return
                    if split != SPLIT_END:
                        raise NotImplementedError(
                            "non-square X/Y splits have no frequency "
                            "layout (NULL in the reference layout table)")
                sub = np.zeros((nplanes, n * n), dtype=np.int64)
                lib.ffv2rt_dec_leaf(h, _ptr(sub, ctypes.c_int64), nplanes,
                                    n)
                leaves.append((y0, x0, n, sub))

            for y0 in range(0, ph, SB):
                for x0 in range(0, pw, SB):
                    walk(y0, x0, SB)
        finally:
            lib.ffv2rt_dec_destroy(h)
        mark("host Daala decode")
        if host:
            return self._reconstruct_host(leaves, nplanes, ph, pw)
        if any(lf[2] != SB for lf in leaves):
            return self._reconstruct_leaves(leaves, nplanes, ph, pw, mark)
        streams = torch.as_tensor(
            np.concatenate([lf[3] for lf in leaves]).astype(np.int32),
            device=self.device)
        mark("host concatenate + upload")
        pix = dv.decode_back_t(streams, self.fmt.bits, SB, nplanes, ph // SB,
                               pw // SB, SB, mark)
        return self._crop_down(pix, mark)

    def _crop_down(self, pix, mark):
        """Device pixel planes -> the cropped, clipped numpy planes."""
        mx = (1 << self.fmt.bits) - 1
        out = pix[:, :self.height, :self.width].clamp(0, mx).to(
            torch.int64).cpu().numpy()
        mark("copy down")
        return list(out)

    def _reconstruct_leaves(self, leaves, nplanes, ph, pw, mark=TRACE):
        """General (mixed leaf size) reconstruction on the device: the
        inverse transforms batch per size, the blocks scatter into the
        coefficient planes, K19 postfilters."""
        dev = self.device
        coeff = torch.zeros((nplanes, ph, pw), dtype=torch.int32, device=dev)
        by_size = collections.defaultdict(list)
        for i, lf in enumerate(leaves):
            by_size[lf[2]].append(i)
        for n, idxs in by_size.items():
            stack = torch.as_tensor(
                np.concatenate([leaves[i][3] for i in idxs]).astype(
                    np.int32), device=dev)
            inv = dv.tx_batch_t(dv.unscan_t(stack, n), dsp.TX_DCT, True)
            ys, xs = _leaf_index(np.asarray([leaves[i][:2] for i in idxs]),
                                 n, dev)
            coeff[:, ys, xs] = inv.reshape(len(idxs), nplanes, n,
                                           n).transpose(0, 1)
        mark("inverse zigzag + transform")
        dv.lap_frame(coeff, SB, False)
        mark("K19 lap_post")
        return self._crop_down(dv.coeff_to_ref_t(coeff, self.fmt.bits),
                               mark)

    def _reconstruct_host(self, leaves, nplanes, ph, pw):
        coeff = np.zeros((nplanes, ph, pw), dtype=np.int64)
        by_size = collections.defaultdict(list)
        for i, lf in enumerate(leaves):
            by_size[lf[2]].append(i)
        for n, idxs in by_size.items():
            stack = np.concatenate([leaves[i][3] for i in idxs])
            blocks = np.zeros((len(stack), n * n), dtype=np.int64)
            blocks[:, dsp.scan_order(n)] = stack
            inv = _host_tx(blocks.reshape(-1, n, n).astype(np.int32),
                           inverse=True).reshape(len(idxs), nplanes, n, n)
            for k, i in enumerate(idxs):
                y0, x0 = leaves[i][:2]
                coeff[:, y0:y0 + n, x0:x0 + n] = inv[k]
        return _host_postfilter(coeff, self.fmt.bits, self.height,
                                self.width)
