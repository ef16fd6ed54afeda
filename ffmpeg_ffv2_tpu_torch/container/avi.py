"""Copy of ``ffmpeg_ffv2_tpu/container/avi.py``.

AVI reader/writer for FFV1/FFV2 interop.

The writer reproduces the reference mux layout byte-for-byte
(libavformat/avienc.c + riffenc.c under -fflags +bitexact): hdrl with avih,
strl {strh, strf(BITMAPINFOHEADER+extradata), JUNK master-ODML placeholder},
an odml/dmlh JUNK, 1016 bytes of tag-editing JUNK padding, the movi list
with odd-byte chunk alignment, and an idx1 index — so FATE's committed
container md5s are met exactly.

The reader handles the same layout (and anything chunk-wise compatible).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

AVIF_HASINDEX = 0x10
AVIF_ISINTERLEAVED = 0x100
AVIF_TRUSTCKTYPE = 0x800

MASTER_INDEX_ENTRIES = 256  # AVI_MASTER_INDEX_SIZE_DEFAULT


def _u32(b, off):
    return struct.unpack_from("<I", b, off)[0]


@dataclass
class AviStream:
    fcc_type: str = ""
    fcc_handler: str = ""
    width: int = 0
    height: int = 0
    rate: int = 25
    scale: int = 1
    extradata: bytes = b""
    packets: list = field(default_factory=list)
    keyflags: list = field(default_factory=list)


class AviReader:
    def __init__(self, data: bytes):
        self.data = data
        self.streams: list[AviStream] = []
        self._parse()

    def _parse(self):
        d = self.data
        if d[0:4] != b"RIFF" or d[8:12] != b"AVI ":
            raise ValueError("not an AVI file")
        self._walk(12, len(d))

    def _walk(self, off: int, end: int):
        d = self.data
        while off + 8 <= end:
            fourcc = d[off:off + 4]
            size = _u32(d, off + 4)
            body = off + 8
            if fourcc == b"LIST":
                list_type = d[body:body + 4]
                if list_type == b"strl":
                    st = AviStream()
                    self.streams.append(st)
                    self._parse_strl(body + 4, body + size, st)
                elif list_type == b"movi":
                    self._parse_movi(body + 4, body + size)
                else:
                    self._walk(body + 4, body + size)
            elif fourcc == b"idx1":
                self._parse_idx1(body, body + size)
            off = body + size + (size & 1)

    def _parse_strl(self, off: int, end: int, st: AviStream):
        d = self.data
        while off + 8 <= end:
            fourcc = d[off:off + 4]
            size = _u32(d, off + 4)
            body = off + 8
            if fourcc == b"strh":
                st.fcc_type = d[body:body + 4].decode("ascii", "replace")
                st.fcc_handler = d[body + 4:body + 8].decode("ascii",
                                                             "replace")
                st.scale = _u32(d, body + 20)
                st.rate = _u32(d, body + 24)
            elif fourcc == b"strf" and st.fcc_type == "vids":
                # biSize = 40 + unpadded extradata size (riffenc.c); the
                # chunk may carry one extra alignment byte beyond it
                bi_size = _u32(d, body)
                st.width = struct.unpack_from("<i", d, body + 4)[0]
                st.height = abs(struct.unpack_from("<i", d, body + 8)[0])
                ed_end = min(body + max(bi_size, 40), body + size)
                if ed_end > body + 40:
                    st.extradata = d[body + 40:ed_end]
            off = body + size + (size & 1)

    def _parse_movi(self, off: int, end: int):
        d = self.data
        while off + 8 <= end:
            fourcc = d[off:off + 4]
            size = _u32(d, off + 4)
            body = off + 8
            if fourcc == b"LIST":
                self._parse_movi(body + 4, body + size)
            elif len(fourcc) == 4 and fourcc[2:4] in (b"dc", b"db", b"wb"):
                try:
                    sid = int(fourcc[0:2])
                except ValueError:
                    sid = -1
                if sid >= 0:
                    while len(self.streams) <= sid:
                        self.streams.append(AviStream())
                    self.streams[sid].packets.append(d[body:body + size])
            off = body + size + (size & 1)

    def _parse_idx1(self, off: int, end: int):
        d = self.data
        counts = {}
        while off + 16 <= end:
            tag = d[off:off + 4]
            flags = _u32(d, off + 4)
            try:
                sid = int(tag[0:2])
            except ValueError:
                sid = -1
            if 0 <= sid < len(self.streams):
                self.streams[sid].keyflags.append(bool(flags & 0x10))
            off += 16

    def keyframe_before(self, idx: int, stream: int = 0) -> int:
        """Index of the nearest keyframe at or before packet ``idx``
        (seek support; mirrors the idx1-driven seek of the reference's
        AVI demuxer used by fate-seek)."""
        st = self.streams[stream]
        flags = st.keyflags or [True] * len(st.packets)
        idx = max(0, min(idx, len(st.packets) - 1))
        while idx > 0 and not flags[idx]:
            idx -= 1
        return idx

    @property
    def video(self) -> AviStream:
        for s in self.streams:
            if s.fcc_type == "vids" or s.packets:
                return s
        raise ValueError("no video stream")


class AviWriter:
    """Single-video-stream AVI writer, byte-exact with the reference muxer."""

    def __init__(self, width: int, height: int, fourcc: str = "FFV1",
                 fps: tuple[int, int] = (25, 1), extradata: bytes = b"",
                 bit_rate: int = 200000, bits_per_coded_sample: int = 24):
        self.width = width
        self.height = height
        self.fourcc = fourcc.encode("ascii")
        self.rate, self.scale = fps
        self.extradata = extradata
        self.bit_rate = bit_rate
        self.bpcs = bits_per_coded_sample
        self.packets: list[tuple[bytes, bool]] = []

    def write_packet(self, data: bytes, keyframe: bool = True):
        self.packets.append((data, keyframe))

    @staticmethod
    def _chunk(fourcc: bytes, body: bytes) -> bytes:
        pad = b"\x00" if len(body) & 1 else b""
        return fourcc + struct.pack("<I", len(body)) + body + pad

    def _avih(self) -> bytes:
        n = len(self.packets)
        us_per_frame = 1000000 * self.scale // self.rate
        flags = AVIF_TRUSTCKTYPE | AVIF_HASINDEX | AVIF_ISINTERLEAVED
        return struct.pack(
            "<14I", us_per_frame, self.bit_rate // 8, 0, flags,
            n, 0, 1, 1024 * 1024, self.width, self.height, 0, 0, 0, 0)

    def _strh(self) -> bytes:
        n = len(self.packets)
        max_size = max((len(p) for p, _ in self.packets), default=0)
        # video rate/scale, clamped like ff_parse_specific_params callers
        au_scale, au_rate = self.scale, self.rate
        if au_rate > 1000 * au_scale:
            au_rate, au_scale = 600, 1
        return (b"vids" + self.fourcc
                + struct.pack("<IHHIIIIIIiII", 0, 0, 0, 0, au_scale, au_rate,
                              0, n, max_size, -1, 0, 0)
                + struct.pack("<HH", self.width, self.height))

    def _strf(self) -> bytes:
        bih = struct.pack(
            "<IiiHH4sIiiII",
            40 + len(self.extradata), self.width, self.height, 1, self.bpcs,
            self.fourcc, (self.width * self.height * self.bpcs + 7) // 8,
            0, 0, 0, 0)
        body = bih + self.extradata
        if len(self.extradata) & 1:
            body += b"\x00"
        return body

    @staticmethod
    def _master_index_junk() -> bytes:
        body = struct.pack("<HBBI", 4, 0, 0, 0) + b"00dc" \
            + struct.pack("<QI", 0, 0) \
            + b"\x00" * (MASTER_INDEX_ENTRIES * 2 * 8)
        return body

    def getvalue(self) -> bytes:
        strl_body = (b"strl"
                     + self._chunk(b"strh", self._strh())
                     + self._chunk(b"strf", self._strf())
                     + self._chunk(b"JUNK", self._master_index_junk()))
        odml_junk = b"odml" + b"dmlh" + struct.pack("<I", 248) + b"\x00" * 248
        hdrl_body = (b"hdrl"
                     + self._chunk(b"avih", self._avih())
                     + self._chunk(b"LIST", strl_body)
                     + self._chunk(b"JUNK", odml_junk))

        pad_junk = self._chunk(b"JUNK", b"\x00" * 1016)

        movi_body = b"movi"
        idx_entries = []
        pos = 4
        for data, key in self.packets:
            idx_entries.append((0x10 if key else 0, pos, len(data)))
            chunk = self._chunk(b"00dc", data)
            movi_body += chunk
            pos += len(chunk)
        movi = self._chunk(b"LIST", movi_body)

        idx = b"".join(b"00dc" + struct.pack("<III", fl, po, ln)
                       for fl, po, ln in idx_entries)
        idx1 = self._chunk(b"idx1", idx)

        riff_body = (b"AVI " + self._chunk(b"LIST", hdrl_body) + pad_junk
                     + movi + idx1)
        return b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(self.getvalue())
