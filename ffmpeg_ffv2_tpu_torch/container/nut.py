"""Copy of ``ffmpeg_ffv2_tpu/container/nut.py``.

NUT muxer/demuxer (FFmpeg's native container; libavformat/nut{enc,dec}.c).

FATE's lossless tests ride AVI, but NUT is the reference project's own
container and the third one its FFV1 path supports (SURVEY §2.4).  The
muxer writes a minimal-but-valid v3 document — main header with a
two-run framecode table (code 0 = FLAG_CODED, everything else invalid),
one video stream header, and a syncpoint before every frame — that the
reference demuxer accepts.  The demuxer parses general reference-muxed
files: full framecode table semantics (runs, 'N' skip, size_mul/lsb),
elision headers, syncpoints, and both table-driven and coded frame flags
(nutdec.c:decode_main_header / decode_frame_header).

Checksums are CRC-32/IEEE msb-first (ff_crc04C11DB7_update == our
core.crc.crc32_ieee), stored little-endian.

The muxer also writes the trailing INDEX packet (nutenc.c:write_index
layout: max_pts, syncpoint >>4 position deltas, per-stream run-coded
keyframe pts, 8-byte index_ptr) — verified parsed and used for seeking
by the reference demuxer (nutdec.c:find_and_decode_index).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..core.crc import crc32_ieee

ID_STRING = b"nut/multimedia container\x00"

MAIN_STARTCODE = 0x7A561F5F04AD + ((ord("N") << 8 | ord("M")) << 48)
STREAM_STARTCODE = 0x11405BF2F9DB + ((ord("N") << 8 | ord("S")) << 48)
SYNCPOINT_STARTCODE = 0xE4ADEECA4569 + ((ord("N") << 8 | ord("K")) << 48)
INDEX_STARTCODE = 0xDD672F23E64E + ((ord("N") << 8 | ord("X")) << 48)
INFO_STARTCODE = 0xAB68B596BA78 + ((ord("N") << 8 | ord("I")) << 48)
_STARTCODES = {MAIN_STARTCODE, STREAM_STARTCODE, SYNCPOINT_STARTCODE,
               INDEX_STARTCODE, INFO_STARTCODE}

FLAG_KEY = 1
FLAG_EOR = 2
FLAG_CODED_PTS = 8
FLAG_STREAM_ID = 16
FLAG_SIZE_MSB = 32
FLAG_CHECKSUM = 64
FLAG_RESERVED = 128
FLAG_SM_DATA = 256
FLAG_HEADER_IDX = 1024
FLAG_MATCH_TIME = 2048
FLAG_CODED = 4096
FLAG_INVALID = 8192

MAX_DISTANCE = 1024 * 32 - 1


def put_v(n: int) -> bytes:
    """ff_put_v: 7-bit groups, MSB first, high bit = continuation."""
    out = bytearray([n & 0x7F])
    n >>= 7
    while n:
        out.append(0x80 | (n & 0x7F))
        n >>= 7
    return bytes(reversed(out))


def put_s(v: int) -> bytes:
    return put_v(2 * v - 1 if v > 0 else -2 * v)


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.d = data
        self.pos = pos

    def u8(self) -> int:
        b = self.d[self.pos]
        self.pos += 1
        return b

    def get_v(self) -> int:
        v = 0
        while True:
            b = self.u8()
            v = (v << 7) | (b & 0x7F)
            if not (b & 0x80):
                return v

    def get_s(self) -> int:
        t = self.get_v()
        return (t + 1) // 2 if t & 1 else -(t // 2)

    def bytes_(self, n: int) -> bytes:
        b = self.d[self.pos:self.pos + n]
        self.pos += n
        return b


# ---------------------------------------------------------------------------
# Muxer
# ---------------------------------------------------------------------------

class NutWriter:
    def __init__(self, width: int, height: int, fourcc: str = "FFV1",
                 rate=(25, 1), extradata: bytes = b""):
        self.width = width
        self.height = height
        self.fourcc = fourcc
        self.rate = rate
        self.extradata = extradata
        self.packets: list[tuple[bytes, int, bool]] = []

    def write_packet(self, data: bytes, keyframe: bool = True,
                     pts: int | None = None):
        if pts is None:
            pts = len(self.packets)
        self.packets.append((bytes(data), pts, keyframe))

    @staticmethod
    def _packet(startcode: int, payload: bytes) -> bytes:
        """put_packet with calculate_checksum=1: trailing CRC over the
        payload; a header CRC when forward_ptr > 4096."""
        fwd = len(payload) + 4
        head = struct.pack(">Q", startcode) + put_v(fwd)
        if fwd > 4096:
            head += crc32_ieee(head).to_bytes(4, "little")
        tail = crc32_ieee(payload).to_bytes(4, "little")
        return head + payload + tail

    def _main_header(self) -> bytes:
        num, den = self.rate
        import math
        g = math.gcd(den, num)
        p = put_v(3)                      # version (3: no minor/flags)
        p += put_v(1)                     # stream_count
        p += put_v(MAX_DISTANCE)
        p += put_v(1)                     # time_base_count
        p += put_v(den // g) + put_v(num // g)   # time base = 1/fps
        # framecode table, 2 runs:
        #   code 0: FLAG_CODED (per-frame coded flags)
        #   codes 1..255: invalid ('N' is skipped inside the run)
        p += put_v(FLAG_CODED) + put_v(6)
        p += put_s(0) + put_v(1) + put_v(0) + put_v(0) + put_v(0) + put_v(1)
        p += put_v(FLAG_INVALID) + put_v(6)
        p += put_s(0) + put_v(1) + put_v(0) + put_v(0) + put_v(0) + put_v(254)
        p += put_v(0)                     # header_count - 1 (no elision)
        return p

    def _stream_header(self) -> bytes:
        p = put_v(0)                      # stream_id
        p += put_v(0)                     # class: video
        p += put_v(4) + self.fourcc.encode("ascii")[:4].ljust(4, b"\x00")
        p += put_v(0)                     # time_base_id
        p += put_v(7)                     # msb_pts_shift
        p += put_v(25)                    # max_pts_distance
        p += put_v(0)                     # decode_delay
        p += bytes([0])                   # stream flags
        p += put_v(len(self.extradata)) + self.extradata
        p += put_v(self.width) + put_v(self.height)
        p += put_v(0) + put_v(0)          # sample aspect ratio (unknown)
        p += put_v(0)                     # colorspace type
        return p

    def tobytes(self) -> bytes:
        out = bytearray(ID_STRING)
        out += self._packet(MAIN_STARTCODE, self._main_header())
        out += self._packet(STREAM_STARTCODE, self._stream_header())
        key_sp_pos = None
        sp_pos_list = []              # syncpoint byte positions
        for data, pts, key in self.packets:
            # syncpoint before every frame: global_key_pts + back_ptr to
            # the syncpoint of the latest keyframe (nutenc.c sp_pos logic)
            sp_pos = len(out)
            if key or key_sp_pos is None:
                key_sp_pos = sp_pos
            sp_pos_list.append(sp_pos)
            out += self._packet(SYNCPOINT_STARTCODE,
                                put_v(pts) + put_v((sp_pos - key_sp_pos) >> 4))
            flags = (FLAG_CODED_PTS | FLAG_STREAM_ID | FLAG_SIZE_MSB
                     | FLAG_CHECKSUM | (FLAG_KEY if key else 0))
            hdr = bytes([0])                        # frame_code 0
            hdr += put_v(FLAG_CODED ^ flags)        # coded_flags
            hdr += put_v(0)                         # stream_id
            hdr += put_v(pts + (1 << 7))            # full coded_pts escape
            hdr += put_v(len(data))                 # size_msb (mul=1, lsb=0)
            hdr += crc32_ieee(hdr).to_bytes(4, "little")
            out += hdr + data
        if sp_pos_list:
            # index entry j holds the keyframe recorded right AFTER
            # syncpoint j was counted (nutenc.c:1151 stores at the
            # post-increment sp_count), i.e. entry j describes frame j-1;
            # entry 0 stays empty (nutdec rejects "keyframe before first
            # syncpoint") and the final frame's entry falls off the end.
            n_sp = len(sp_pos_list)
            sp_key_pts = [None] * n_sp
            for j in range(1, n_sp):
                data, pts, key = self.packets[j - 1]
                if key:
                    sp_key_pts[j] = pts
            out += self._index(sp_pos_list, sp_key_pts)
        return bytes(out)

    def _index(self, sp_pos_list, sp_key_pts) -> bytes:
        """Trailing INDEX packet (nutenc.c:write_index): max_pts, the
        syncpoint positions as >>4 deltas, per-stream run-coded keyframe
        pts, and the 8-byte index_ptr (bytes from index start to EOF)."""
        max_pts = max(p for _, p, _ in self.packets)
        body = put_v(max_pts)                       # put_tt, 1 timebase
        body += put_v(len(sp_pos_list))
        last = 0
        for pos in sp_pos_list:
            body += put_v((pos >> 4) - (last >> 4))
            last = pos
        # single stream: runs of syncpoints with/without keyframe pts
        n_sp = len(sp_pos_list)
        j = 0
        last_pts = -1
        while j < n_sp:
            flag = (sp_key_pts[j] is not None) ^ (j + 1 == n_sp)
            n = 0
            while j < n_sp and (sp_key_pts[j] is not None) == flag:
                n += 1
                j += 1
            body += put_v(1 + 2 * flag + 4 * n)
            for k in range(j - n, min(j + 1, n_sp)):
                if sp_key_pts[k] is None:
                    continue
                body += put_v(sp_key_pts[k] - last_pts)
                last_pts = sp_key_pts[k]
            j += 1          # the run implicitly covers one !flag entry
        # index_ptr: distance from the index packet's first byte to EOF
        fwd = len(body) + 8 + 4
        ptr = 8 + fwd + len(put_v(fwd)) + (4 if fwd > 4096 else 0)
        body += struct.pack(">Q", ptr)
        return self._packet(INDEX_STARTCODE, body)

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(self.tobytes())


# ---------------------------------------------------------------------------
# Demuxer
# ---------------------------------------------------------------------------

@dataclass
class _FrameCode:
    flags: int = FLAG_INVALID
    pts_delta: int = 0
    stream_id: int = 0
    size_mul: int = 1
    size_lsb: int = 0
    reserved_count: int = 0
    header_idx: int = 0


@dataclass
class NutStream:
    stream_id: int = 0
    stream_class: int = 0
    fourcc: str = ""
    width: int = 0
    height: int = 0
    extradata: bytes = b""
    time_base: tuple = (1, 25)
    msb_pts_shift: int = 0
    max_pts_distance: int = 0
    last_pts: int = 0
    packets: list = field(default_factory=list)
    keyflags: list = field(default_factory=list)
    pts_list: list = field(default_factory=list)


class NutReader:
    def __init__(self, data: bytes):
        if not data.startswith(ID_STRING):
            raise ValueError("not a NUT file")
        self.frame_code = [_FrameCode() for _ in range(256)]
        self.elision_headers: list[bytes] = [b""]
        self.time_bases: list[tuple] = []
        self.streams: dict[int, NutStream] = {}
        self._parse(data, len(ID_STRING))

    @property
    def video(self) -> NutStream:
        for st in self.streams.values():
            if st.stream_class == 0:
                return st
        raise ValueError("no video stream")

    def _parse(self, d: bytes, pos: int):
        r = _Reader(d, pos)
        while r.pos < len(d):
            if d[r.pos] == 0x4E and r.pos + 8 <= len(d):    # 'N'
                sc = struct.unpack_from(">Q", d, r.pos)[0]
                if sc in _STARTCODES:
                    r.pos += 8
                    fwd = r.get_v()
                    if fwd > 4096:
                        r.bytes_(4)                         # header checksum
                    body_end = r.pos + fwd                  # incl. trailing crc
                    body = _Reader(d, r.pos)
                    if sc == MAIN_STARTCODE:
                        self._main_header(body)
                    elif sc == STREAM_STARTCODE:
                        self._stream_header(body)
                    # INFO/INDEX/SYNCPOINT payloads are skipped (frame
                    # parsing below doesn't depend on them)
                    r.pos = body_end
                    continue
            self._frame(r)

    def _main_header(self, r: _Reader):
        version = r.get_v()
        if version > 3:
            r.get_v()                                       # minor
        stream_count = r.get_v()
        r.get_v()                                           # max_distance
        tb_count = r.get_v()
        self.time_bases = [(r.get_v(), r.get_v()) for _ in range(tb_count)]
        tmp_pts, tmp_mul, tmp_stream, tmp_head = 0, 1, 0, 0
        i = 0
        while i < 256:
            tmp_flags = r.get_v()
            tmp_fields = r.get_v()
            if tmp_fields > 0:
                tmp_pts = r.get_s()
            if tmp_fields > 1:
                tmp_mul = r.get_v()
            if tmp_fields > 2:
                tmp_stream = r.get_v()
            tmp_size = r.get_v() if tmp_fields > 3 else 0
            tmp_res = r.get_v() if tmp_fields > 4 else 0
            count = r.get_v() if tmp_fields > 5 else tmp_mul - tmp_size
            if tmp_fields > 6:
                r.get_s()                                   # match
            if tmp_fields > 7:
                tmp_head = r.get_v()
            for _ in range(max(tmp_fields - 8, 0)):
                r.get_v()
            j = 0
            while j < count and i < 256:
                if i == 0x4E:                               # 'N'
                    self.frame_code[i].flags = FLAG_INVALID
                    i += 1
                    continue
                fc = self.frame_code[i]
                fc.flags = tmp_flags
                fc.pts_delta = tmp_pts
                fc.stream_id = tmp_stream
                fc.size_mul = tmp_mul
                fc.size_lsb = tmp_size + j
                fc.reserved_count = tmp_res
                fc.header_idx = tmp_head
                i += 1
                j += 1
        header_count = r.get_v() + 1
        for _ in range(1, header_count):
            n = r.get_v()
            self.elision_headers.append(r.bytes_(n))
        _ = version, stream_count

    def _stream_header(self, r: _Reader):
        st = NutStream()
        st.stream_id = r.get_v()
        st.stream_class = r.get_v()
        n = r.get_v()
        st.fourcc = r.bytes_(n).decode("ascii", "replace").rstrip("\x00")
        tb_id = r.get_v()
        st.time_base = self.time_bases[tb_id] if self.time_bases else (1, 25)
        st.msb_pts_shift = r.get_v()
        st.max_pts_distance = r.get_v()
        r.get_v()                                           # decode_delay
        r.u8()                                              # stream flags
        n = r.get_v()
        st.extradata = r.bytes_(n)
        if st.stream_class == 0:
            st.width = r.get_v()
            st.height = r.get_v()
            r.get_v(); r.get_v()                            # SAR
            r.get_v()                                       # csp
        self.streams[st.stream_id] = st

    def _frame(self, r: _Reader):
        code = r.u8()
        fc = self.frame_code[code]
        flags = fc.flags
        if flags & FLAG_INVALID:
            raise ValueError(f"invalid frame code {code} at {r.pos - 1}")
        if flags & FLAG_CODED:
            flags ^= r.get_v()
        stream_id = fc.stream_id
        if flags & FLAG_STREAM_ID:
            stream_id = r.get_v()
        st = self.streams[stream_id]
        if flags & FLAG_CODED_PTS:
            coded = r.get_v()
            if coded < (1 << st.msb_pts_shift):             # lsb mode
                mask = (1 << st.msb_pts_shift) - 1
                delta = st.last_pts - mask // 2
                pts = ((coded - delta) & mask) + delta
            else:
                pts = coded - (1 << st.msb_pts_shift)
        else:
            pts = st.last_pts + fc.pts_delta
        size = fc.size_lsb
        if flags & FLAG_SIZE_MSB:
            size += fc.size_mul * r.get_v()
        if flags & FLAG_MATCH_TIME:
            r.get_s()
        header_idx = fc.header_idx
        if flags & FLAG_HEADER_IDX:
            header_idx = r.get_v()
        res = fc.reserved_count
        if flags & FLAG_RESERVED:
            res = r.get_v()
        for _ in range(res):
            r.get_v()
        if size > 4096:
            header_idx = 0
        size -= len(self.elision_headers[header_idx])
        if flags & FLAG_CHECKSUM:
            r.bytes_(4)
        data = self.elision_headers[header_idx] + r.bytes_(size)
        st.last_pts = pts
        if not (flags & FLAG_EOR):
            st.packets.append(data)
            st.keyflags.append(bool(flags & FLAG_KEY))
            st.pts_list.append(pts)
