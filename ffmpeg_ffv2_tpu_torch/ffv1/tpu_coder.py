"""The hybrid FFV1 encoder with the range coder's arithmetic on a CUDA
device: native op planning, the lane coder on the card, host packet
assembly.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/tpu_coder.py`` (``MODE_*``,
``bit_pack_lanes``, ``pack_lane_bytes``, ``compact_lane`` and
``TPUCoderFFV1Encoder``).  The adaptive range coder splits into:

* adaptation: which 8-bit state value codes each binary decision.  It
  depends only on the per-(slice, context, slot) history, so the native
  planner (``ffv1rt_plan``) resolves it while it expands every slice's
  stream into (state value, bit) op pairs;
* arithmetic and byte emission: the (low, range, pending byte) recursion
  of the coder, identical lock-step work per slice, run for all slices at
  once by K7 (``rac.rac_lanes``): lanes = slices, one step per op, the
  streams of unequal length padded with NOPs and ended by the two flush
  steps.

Each step of a lane stages at most one emission (first byte, fill value,
fill count); the host compacts each lane's events into its slice's bytes
and adds the 3-byte size / CRC trailers (ffv1enc.c:1236-1262 layout).

Golomb-Rice: the range-coded slice headers go through the same lane coder;
the native planner turns the Rice bitstream into (value, nbits) pairs that
``bit_pack_lanes`` packs on the card (a cumsum and a scatter-add over
disjoint bit ranges).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import headers as H
from .expand import MODE_NOP, MODE_OP, MODE_FLUSH1, MODE_FLUSH2
from .native import NativeFFV1Codec, crc32_trailer, get_lib
from .params import FFV1Config, params_from_config, CODER_GOLOMB
from .rac import rac_lanes

M32 = 0xFFFFFFFF


def bit_pack_lanes(val, nb):
    """MSB-first concatenation of (value, nbits <= 32) ops per lane, on the
    device of ``val``.

    val: int64 or int32 (steps, lanes) values (their low 32 bits are
    used); nb: (steps, lanes) bit counts, 0 marks padding.  Returns
    (words int32 (steps + 1, lanes): the uint32 words in big-endian bit
    order, as int32 bit patterns; total_bits int32 (lanes,)).  torch has
    no uint32 cumsum or scatter-add on CUDA, so the words are summed in
    int64 and masked to 32 bits; ops write disjoint bit ranges, so add
    equals or.  put_bits semantics: the final partial byte is padded with
    zero bits."""
    steps, lanes = val.shape
    dev = val.device
    v = val.long() & M32
    nb = nb.long()
    end = torch.cumsum(nb, dim=0)
    start = end - nb
    word = start >> 5
    off = start & 31
    lo_shift = 32 - off - nb                  # >= 0 when the op fits
    fits = lo_shift >= 0
    sh1 = torch.where(fits, torch.clamp(lo_shift, max=31), -lo_shift)
    c1 = torch.where(fits, (v << sh1) & M32, v >> sh1)
    sh2 = torch.clamp(64 - off - nb, 0, 31)
    c2 = torch.where(fits, 0, (v << sh2) & M32)
    live = nb > 0
    c1 = torch.where(live, c1, 0)
    c2 = torch.where(live, c2, 0)
    # padding ops past a full last word point one row beyond the words;
    # they add 0, so clamping their row changes nothing
    lane = torch.arange(lanes, device=dev)[None, :]
    words = torch.zeros((steps + 1) * lanes, dtype=torch.int64, device=dev)
    for row, c in ((word, c1), (word + 1, c2)):
        idx = torch.clamp(row, max=steps) * lanes + lane
        words.index_add_(0, idx.reshape(-1), c.reshape(-1))
    words = (words & M32).reshape(steps + 1, lanes)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    total = (end[-1] if steps else torch.zeros(lanes, dtype=torch.int64,
                                               device=dev))
    return words.to(torch.int32), total.to(torch.int32)


def pack_lane_bytes(words_col, total_bits) -> bytes:
    """One lane's packed words (uint32 values or their int32 bit patterns)
    -> the byte stream (big-endian words, length ceil(total_bits / 8))."""
    nbytes = (int(total_bits) + 7) // 8
    w = np.asarray(words_col).astype(np.int64) & M32
    return w.astype(">u4").tobytes()[:nbytes]


def compact_lanes(first, fcount, fval) -> list:
    """Expand every lane's staged events ((steps, lanes) numpy arrays) into
    its bytestream: each emitting step (first >= 0) gives its first byte,
    then fcount copies of fval.  Vectorised over all lanes: the events in
    lane-major order, one ``np.repeat`` of the fill values by the events'
    byte counts, the first bytes stored at the events' starts."""
    f = np.asarray(first).T
    lane, step = np.nonzero(f >= 0)           # lane-major, steps ascending
    cnt = 1 + np.asarray(fcount).T[lane, step].astype(np.int64)
    out = np.repeat(np.asarray(fval).T[lane, step].astype(np.uint8), cnt)
    starts = np.cumsum(cnt) - cnt
    out[starts] = (f[lane, step] & 0xFF).astype(np.uint8)
    per_lane = np.bincount(lane, weights=cnt, minlength=f.shape[0])
    ends = np.cumsum(per_lane.astype(np.int64))
    return [out[a:b].tobytes() for a, b in
            zip(np.concatenate([[0], ends[:-1]]), ends)]


def compact_lane(first, fcount, fval) -> bytes:
    """One lane's staged events ((steps,) arrays) -> its bytestream
    (``compact_lanes`` on one lane)."""
    return compact_lanes(np.asarray(first)[:, None],
                         np.asarray(fcount)[:, None],
                         np.asarray(fval)[:, None])[0]


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class TPUCoderFFV1Encoder:
    """FFV1 encode with the range coder's arithmetic on a CUDA device:
    native op planning -> K7, the lane coder, on the card -> host packet
    assembly.  Packets are byte-identical to the native codec's.

    Covers what the native planner covers: versions 0-4, range coder
    (custom and default tables) and Golomb-Rice (range-coded headers on
    K7, the Rice bits through ``bit_pack_lanes`` on the card), YUV, gray
    and RGB, the v4 PCM fallback and pass-1 statistics
    (``set_stats_mode``).  device="cpu" runs the lane coder's plain
    version (tests); device="cuda", the default, raises RuntimeError
    where torch sees no CUDA device."""

    # the kernels an encode launches (chip_smoke.py and the card tests
    # check that the path went through them)
    kernels = ("rac_lanes",)

    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV1Config | None = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TPUCoderFFV1Encoder: device='cuda' but "
                               "torch sees no CUDA device")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.cfg = config or FFV1Config()
        self.p = params_from_config(self.cfg, pix_fmt, width, height)
        self.golomb = self.p.ac == CODER_GOLOMB
        self.native = NativeFFV1Codec(self.p)
        self.lib = get_lib()
        self.extradata = (H.write_extradata(self.p)
                          if self.p.version > 1 else b"")
        self.picture_number = 0
        self.budget_override = 0    # test hook (mirrors the native one)

    def set_budget_override(self, budget: int):
        """Force the v4 PCM retry's slice budget (a test hook shared with
        the native codec's)."""
        self.budget_override = budget
        self.lib.ffv1rt_set_budget_override(self.native.handle, budget)

    def set_stats_mode(self, enable: bool = True):
        """Pass-1 rc_stat collection through the planner (plan_symbol
        tallies the same (state value, bit) counters the native encoder
        does); read with twopass.collect_stats on .native."""
        self.lib.ffv1rt_set_stats_mode(self.native.handle,
                                       1 if enable else 0)

    # -- planning ------------------------------------------------------------

    def _get_plan(self, si: int, mx: int):
        """Slice si's planned (sv, bit) uint8 ops and their count."""
        sv = np.empty(mx, dtype=np.uint8)
        bt = np.empty(mx, dtype=np.uint8)
        ln = self.lib.ffv1rt_get_plan(self.native.handle, si,
                                      _ptr(sv, ctypes.c_uint8),
                                      _ptr(bt, ctypes.c_uint8), mx)
        return sv, bt, int(ln)

    def _plan(self, planes, keyframe):
        """Plan every slice's range-coded ops: (svs, bits, lens, max)."""
        _, ptrs = self.native._plane_ptrs(planes)
        mx = self.lib.ffv1rt_plan(self.native.handle, ptrs,
                                  1 if keyframe else 0)
        if mx < 0:
            raise RuntimeError("op planning failed")
        svs, bits, lens = zip(*(self._get_plan(si, mx)
                                for si in range(self.p.slice_count)))
        return list(svs), list(bits), list(lens), int(mx)

    # -- the lane coder -------------------------------------------------------

    def lane_matrices(self, svs, bits, lens):
        """Per-slice uint8 (sv, bit) ops -> K7's (sv, bit, mode) int32
        (steps, lanes) on the device, steps = the longest slice's ops + the
        two flush steps.  The uint8 streams go up to the card once; the
        int32 matrices and the modes (ops, FLUSH1, FLUSH2, then NOPs) are
        made there."""
        n = len(svs)
        steps = max(lens) + 2
        up = np.zeros((2, n, steps), dtype=np.uint8)
        for si in range(n):
            L = lens[si]
            up[0, si, :L] = svs[si][:L]
            up[1, si, :L] = bits[si][:L]
        up = torch.as_tensor(up).to(self.device)
        sv, bt = up.to(torch.int32).permute(0, 2, 1).contiguous()
        i = torch.arange(steps, device=self.device)[:, None]
        L = torch.as_tensor(np.asarray(lens, np.int64)).to(self.device)
        mode = torch.where(i < L, MODE_OP,
                           torch.where(i == L, MODE_FLUSH1,
                                       torch.where(i == L + 1, MODE_FLUSH2,
                                                   MODE_NOP)))
        return sv, bt, mode.to(torch.int32).contiguous()

    def code_lanes(self, svs, bits, lens):
        """K7 over every slice's ops; the staged (first, fcount, fval)
        come back to the host once, as numpy (steps, lanes) int32."""
        staged = torch.stack(rac_lanes(*self.lane_matrices(svs, bits, lens)))
        return staged.cpu().numpy()

    def _code_slices(self, svs, bits, lens, return_nbytes=False):
        """Run the lane coder over all slices; returns raw byte chunks (and
        the bytes each step emitted, (steps, lanes))."""
        first, fcount, fval = self.code_lanes(svs, bits, lens)
        chunks = compact_lanes(first, fcount, fval)
        if return_nbytes:
            return chunks, np.where(first >= 0, 1 + fcount, 0)
        return chunks

    def _encode_golomb(self, planes, keyframe) -> list:
        """Golomb-Rice: the range-coded headers through the lane coder, the
        Rice bitstream through the bit packer on the card; the native
        planner resolves the VlcState and run-ladder adaptation.  Returns
        the raw slice chunks."""
        _, ptrs = self.native._plane_ptrs(planes)
        mx = self.lib.ffv1rt_plan_golomb(self.native.handle, ptrs,
                                         1 if keyframe else 0)
        if mx < 0:
            raise RuntimeError("golomb op planning failed")
        n = self.p.slice_count
        hdr = [self._get_plan(si, mx) for si in range(n)]
        bit_val, bit_nb, bit_len = [], [], []
        for si in range(n):
            v = np.empty(mx, dtype=np.uint32)
            nb = np.empty(mx, dtype=np.uint8)
            ln = self.lib.ffv1rt_get_plan_bits(self.native.handle, si,
                                               _ptr(v, ctypes.c_uint32),
                                               _ptr(nb, ctypes.c_uint8), mx)
            bit_val.append(v)
            bit_nb.append(nb)
            bit_len.append(int(ln))
        heads = self._code_slices(*zip(*hdr))

        bsteps = max(max(bit_len), 1)
        val = np.zeros((bsteps, n), dtype=np.int64)
        nb = np.zeros((bsteps, n), dtype=np.int32)
        for si in range(n):
            L = bit_len[si]
            val[:L, si] = bit_val[si][:L]
            nb[:L, si] = bit_nb[si][:L]
        words, total_bits = bit_pack_lanes(
            torch.as_tensor(val).to(self.device),
            torch.as_tensor(nb).to(self.device))
        words = words.cpu().numpy()
        total_bits = total_bits.cpu().numpy()
        return [heads[si] + pack_lane_bytes(words[:, si], total_bits[si])
                for si in range(n)]

    # -- public API ------------------------------------------------------------

    def encode(self, planes, force_keyframe=None) -> bytes:
        gop = self.cfg.gop_size
        keyframe = (gop == 0 or self.picture_number % gop == 0)
        if force_keyframe is not None:
            keyframe = bool(force_keyframe)
        if self.golomb:
            chunks = self._encode_golomb(planes, keyframe)
        elif self.p.version > 3:
            chunks = self._encode_v4(planes, keyframe)
        else:
            chunks = self._code_slices(*self._plan(planes, keyframe)[:3])
        self.picture_number += 1
        return b"".join(self._trail(si, ch) for si, ch in enumerate(chunks))

    def _encode_v4(self, planes, keyframe) -> list:
        """v4 PCM fallback (ffv1enc.c:1107-1117): when a slice's coded size
        exceeds its packet region, replan it as raw-PCM ops and rerun the
        lane coder for the retried slices."""
        n = self.p.slice_count
        svs, bits, lens, mx = self._plan(planes, keyframe)
        chunks, nbytes = self._code_slices(svs, bits, lens,
                                           return_nbytes=True)
        budget = (self.budget_override
                  or (16384 + self.p.width * self.p.height * 3 * 4) // n)
        over = [si for si in range(n)
                if self._row_check_overflows(si, nbytes[:, si], budget)]
        if not over:
            return chunks
        _, ptrs = self.native._plane_ptrs(planes)
        for si in over:
            ln = self.lib.ffv1rt_replan_pcm(self.native.handle, si, ptrs,
                                            1 if keyframe else 0)
            if ln < 0:
                raise RuntimeError("PCM replan failed")
            mx = max(mx, int(ln))
            svs[si], bits[si], lens[si] = self._get_plan(si, mx)
        chunks, nbytes = self._code_slices(svs, bits, lens,
                                           return_nbytes=True)
        still = [si for si in over
                 if self._row_check_overflows(si, nbytes[:, si], budget)]
        if still:
            raise RuntimeError(f"slices {still} overflow even as PCM")
        return chunks

    def _row_check_overflows(self, si, nbytes_col, budget):
        """Replay the encoder's per-row budget check
        (ffv1_runtime.cpp: obuf.size() + w*35 > budget) against the lane
        coder's emitted-byte prefix at the planner's row marks."""
        cap = 4 * (self.p.height + 4)
        marks = np.empty(cap, dtype=np.int64)
        widths = np.empty(cap, dtype=np.int32)
        nrows = self.lib.ffv1rt_get_plan_rows(
            self.native.handle, si, _ptr(marks, ctypes.c_int64),
            _ptr(widths, ctypes.c_int32), cap)
        if nrows < 0 or nrows > cap:
            raise RuntimeError("row marks unavailable")
        prefix = np.concatenate([[0], np.cumsum(nbytes_col)])
        m = marks[:nrows]
        return bool(np.any(prefix[m] + 35 * widths[:nrows].astype(np.int64)
                           > budget))

    def _trail(self, si, data):
        if si > 0 or self.p.version > 2:
            if len(data) >= 1 << 24:
                raise RuntimeError("slice exceeds the 24-bit size field")
            data += len(data).to_bytes(3, "big")
            if self.p.ec:
                data += b"\x00"
                data += crc32_trailer(data)
        return data
