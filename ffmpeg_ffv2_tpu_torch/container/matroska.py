"""Copy of ``ffmpeg_ffv2_tpu/container/matroska.py``.

Matroska muxer/demuxer for FFV1/FFV2 interop.

The reference ships FFV2 only with a Matroska mapping (libavformat/
matroska.c:83 ``{"V_FFV2", AV_CODEC_ID_FFV2}``), so .mkv is the interop
container for FFV2 streams (AVI has no FFV2 RIFF tag).  FFV1 rides as
``V_FFV1`` with the extradata in CodecPrivate.

The writer emits a minimal-but-valid EBML document (EBML header, Segment
with SeekHead, Info/Tracks, one Cluster per 30s of SimpleBlocks, and a
Cues index over the keyframes — matroskaenc.c mkv_add_cuepoint's
counterpart, verified seekable by the reference demuxer); the reader parses
any Matroska the reference muxer (libavformat/matroskaenc.c) produces for
these codecs, including Void/CRC skipping, BlockGroups with ReferenceBlock
keyframe inference, and all three lacing modes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

# EBML / Matroska element IDs (stored with the length marker, as read)
EBML_HEADER = 0x1A45DFA3
EBML_VERSION = 0x4286
EBML_READ_VERSION = 0x42F7
EBML_MAX_ID_LENGTH = 0x42F2
EBML_MAX_SIZE_LENGTH = 0x42F3
DOCTYPE = 0x4282
DOCTYPE_VERSION = 0x4287
DOCTYPE_READ_VERSION = 0x4285

SEGMENT = 0x18538067
SEEKHEAD = 0x114D9B74
VOID = 0xEC
CRC32 = 0xBF
INFO = 0x1549A966
TIMECODE_SCALE = 0x2AD7B1
MUXING_APP = 0x4D80
WRITING_APP = 0x5741
SEGMENT_UID = 0x73A4
DURATION = 0x4489
TRACKS = 0x1654AE6B
TRACK_ENTRY = 0xAE
TRACK_NUMBER = 0xD7
TRACK_UID = 0x73C5
TRACK_TYPE = 0x83
FLAG_LACING = 0x9C
LANGUAGE = 0x22B59C
CODEC_ID = 0x86
CODEC_PRIVATE = 0x63A2
DEFAULT_DURATION = 0x23E383
VIDEO = 0xE0
PIXEL_WIDTH = 0xB0
PIXEL_HEIGHT = 0xBA
CLUSTER = 0x1F43B675
CLUSTER_TIMECODE = 0xE7
SIMPLE_BLOCK = 0xA3
BLOCK_GROUP = 0xA0
BLOCK = 0xA1
REFERENCE_BLOCK = 0xFB
CUES = 0x1C53BB6B
CUE_POINT = 0xBB
CUE_TIME = 0xB3
CUE_TRACK_POSITIONS = 0xB7
CUE_TRACK = 0xF7
CUE_CLUSTER_POSITION = 0xF1
SEEK = 0x4DBB
SEEK_ID = 0x53AB
SEEK_POSITION = 0x53AC
TAGS = 0x1254C367
CHAPTERS = 0x1043A770
ATTACHMENTS = 0x1941A469

_TOP_LEVEL = {SEEKHEAD, INFO, TRACKS, CLUSTER, CUES, TAGS, CHAPTERS,
              ATTACHMENTS}


def _id_bytes(eid: int) -> bytes:
    n = 1
    while eid >> (8 * n):
        n += 1
    return eid.to_bytes(n, "big")


def _vint(n: int) -> bytes:
    """EBML size coding: length-marker bit + value."""
    for length in range(1, 9):
        if n < (1 << (7 * length)) - 1:
            return ((1 << (7 * length)) | n).to_bytes(length, "big")
    raise ValueError("size too large for EBML vint")


def _elem(eid: int, payload: bytes) -> bytes:
    return _id_bytes(eid) + _vint(len(payload)) + payload


def _uint_payload(v: int) -> bytes:
    n = 1
    while v >> (8 * n):
        n += 1
    return v.to_bytes(n, "big")


def _uint(eid: int, v: int) -> bytes:
    return _elem(eid, _uint_payload(v))


def _float(eid: int, v: float) -> bytes:
    return _elem(eid, struct.pack(">d", v))


def _string(eid: int, s: str) -> bytes:
    return _elem(eid, s.encode())


class MatroskaWriter:
    def __init__(self, width: int, height: int, codec_id: str,
                 rate=(25, 1), extradata: bytes = b""):
        self.width = width
        self.height = height
        self.codec_id = codec_id
        self.rate = rate
        self.extradata = extradata
        self.packets: list[tuple[bytes, int, bool]] = []  # data, pts_ms, key

    def write_packet(self, data: bytes, keyframe: bool = True,
                     pts_ms: int | None = None):
        if pts_ms is None:
            num, den = self.rate
            pts_ms = len(self.packets) * 1000 * den // num
        self.packets.append((bytes(data), pts_ms, keyframe))

    def _track_entry(self) -> bytes:
        num, den = self.rate
        e = (_uint(TRACK_NUMBER, 1) + _uint(TRACK_UID, 1)
             + _uint(FLAG_LACING, 0) + _string(LANGUAGE, "und")
             + _string(CODEC_ID, self.codec_id) + _uint(TRACK_TYPE, 1)
             + _uint(DEFAULT_DURATION, 1_000_000_000 * den // num))
        if self.extradata:
            e += _elem(CODEC_PRIVATE, self.extradata)
        e += _elem(VIDEO, _uint(PIXEL_WIDTH, self.width)
                   + _uint(PIXEL_HEIGHT, self.height))
        return _elem(TRACK_ENTRY, e)

    def tobytes(self) -> bytes:
        head = _elem(EBML_HEADER,
                     _uint(EBML_VERSION, 1) + _uint(EBML_READ_VERSION, 1)
                     + _uint(EBML_MAX_ID_LENGTH, 4)
                     + _uint(EBML_MAX_SIZE_LENGTH, 8)
                     + _string(DOCTYPE, "matroska")
                     + _uint(DOCTYPE_VERSION, 4)
                     + _uint(DOCTYPE_READ_VERSION, 2))
        dur = max((p[1] for p in self.packets), default=0)
        num, den = self.rate
        info = _elem(INFO, _uint(TIMECODE_SCALE, 1_000_000)
                     + _string(MUXING_APP, "ffmpeg_ffv2_tpu")
                     + _string(WRITING_APP, "ffmpeg_ffv2_tpu")
                     + _float(DURATION, dur + 1000 * den / num))
        tracks = _elem(TRACKS, self._track_entry())

        # clusters; remember (keyframe time, cluster offset within the
        # cluster run) for the cue index (matroskaenc.c mkv_add_cuepoint)
        clusters = b""
        cl_payload = b""
        cl_base = 0
        cl_off = 0
        cue_entries = []       # (time_ms, cluster offset in `clusters`)
        for i, (data, pts, key) in enumerate(self.packets):
            if i == 0 or pts - cl_base > 30_000:
                if cl_payload:
                    clusters += _elem(CLUSTER, cl_payload)
                cl_base = pts
                cl_off = len(clusters)
                cl_payload = _uint(CLUSTER_TIMECODE, cl_base)
            if key:
                cue_entries.append((pts, cl_off))
            blk = (b"\x81" + struct.pack(">h", pts - cl_base)
                   + (b"\x80" if key else b"\x00") + data)
            cl_payload += _elem(SIMPLE_BLOCK, blk)
        if cl_payload:
            clusters += _elem(CLUSTER, cl_payload)

        # SeekHead (at segment start) + Cues (after the clusters); all
        # SeekPosition/CueClusterPosition values are relative to the
        # segment payload start.  SeekPositions use fixed 8-byte uints so
        # the SeekHead's own size is position-independent.
        def _uint8(eid, v):
            return _elem(eid, struct.pack(">Q", v))

        def seek_entry(eid, pos):
            return _elem(SEEK, _elem(SEEK_ID, _id_bytes(eid))
                         + _uint8(SEEK_POSITION, pos))

        sh_payload0 = (seek_entry(INFO, 0) + seek_entry(TRACKS, 0)
                       + seek_entry(CUES, 0))
        sh_len = len(_elem(SEEKHEAD, sh_payload0))
        info_pos = sh_len
        tracks_pos = info_pos + len(info)
        clusters_pos = tracks_pos + len(tracks)
        cues_pos = clusters_pos + len(clusters)
        seekhead = _elem(SEEKHEAD,
                         seek_entry(INFO, info_pos)
                         + seek_entry(TRACKS, tracks_pos)
                         + seek_entry(CUES, cues_pos))
        assert len(seekhead) == sh_len

        cues = b"".join(
            _elem(CUE_POINT, _uint(CUE_TIME, t)
                  + _elem(CUE_TRACK_POSITIONS,
                          _uint(CUE_TRACK, 1)
                          + _uint(CUE_CLUSTER_POSITION,
                                  clusters_pos + off)))
            for (t, off) in cue_entries)
        cues = _elem(CUES, cues)

        return head + _elem(SEGMENT,
                            seekhead + info + tracks + clusters + cues)

    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(self.tobytes())


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

@dataclass
class MkvTrack:
    number: int = 1
    codec_id: str = ""
    width: int = 0
    height: int = 0
    extradata: bytes = b""
    default_duration_ns: int = 0
    packets: list = field(default_factory=list)
    keyflags: list = field(default_factory=list)
    times_ms: list = field(default_factory=list)


class _Parser:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.d)

    def read_id(self) -> int:
        b0 = self.d[self.pos]
        length = 1
        mask = 0x80
        while length <= 4 and not (b0 & mask):
            mask >>= 1
            length += 1
        if length > 4:
            raise ValueError(f"bad EBML ID at {self.pos}")
        v = int.from_bytes(self.d[self.pos:self.pos + length], "big")
        self.pos += length
        return v

    def read_size(self) -> int | None:
        """Returns None for the unknown-size marker."""
        b0 = self.d[self.pos]
        length = 1
        mask = 0x80
        while length <= 8 and not (b0 & mask):
            mask >>= 1
            length += 1
        if length > 8:
            raise ValueError(f"bad EBML size at {self.pos}")
        raw = int.from_bytes(self.d[self.pos:self.pos + length], "big")
        self.pos += length
        val = raw - (1 << (7 * length))
        if val == (1 << (7 * length)) - 1:
            return None
        return val


def _vint_at(d: bytes, pos: int) -> tuple[int, int]:
    b0 = d[pos]
    length = 1
    mask = 0x80
    while length <= 8 and not (b0 & mask):
        mask >>= 1
        length += 1
    v = int.from_bytes(d[pos:pos + length], "big") - (1 << (7 * length))
    return v, pos + length


def _svint_at(d: bytes, pos: int) -> tuple[int, int]:
    v, npos = _vint_at(d, pos)
    length = npos - pos
    return v - ((1 << (7 * length - 1)) - 1), npos


def _parse_lace(d: bytes, pos: int, flags: int) -> list[bytes]:
    mode = (flags >> 1) & 3
    if mode == 0:
        return [d[pos:]]
    nframes = d[pos] + 1
    pos += 1
    sizes = []
    if mode == 2:  # fixed
        total = len(d) - pos
        sizes = [total // nframes] * nframes
    elif mode == 1:  # Xiph
        for _ in range(nframes - 1):
            s = 0
            while d[pos] == 255:
                s += 255
                pos += 1
            s += d[pos]
            pos += 1
            sizes.append(s)
        sizes.append(len(d) - pos - sum(sizes))
    else:  # EBML
        s, pos = _vint_at(d, pos)
        sizes.append(s)
        for _ in range(nframes - 2):
            delta, pos = _svint_at(d, pos)
            s += delta
            sizes.append(s)
        sizes.append(len(d) - pos - sum(sizes))
    out = []
    for s in sizes:
        out.append(d[pos:pos + s])
        pos += s
    return out


class MatroskaReader:
    def __init__(self, data: bytes):
        self.tracks: dict[int, MkvTrack] = {}
        self.timecode_scale = 1_000_000
        self.cues: list[tuple[int, int]] = []    # (time_ms, segment pos)
        p = _Parser(data)
        eid = p.read_id()
        size = p.read_size()
        if eid != EBML_HEADER:
            raise ValueError("not an EBML/Matroska file")
        p.pos += size
        eid = p.read_id()
        size = p.read_size()
        if eid != SEGMENT:
            raise ValueError("no Segment element")
        end = len(data) if size is None else p.pos + size
        self._parse_segment(p, end)

    @property
    def video(self) -> MkvTrack:
        for t in self.tracks.values():
            if t.codec_id.startswith("V_"):
                if t.codec_id == "V_MS/VFW/FOURCC" and len(t.extradata) >= 40:
                    # VFW fallback: CodecPrivate is a BITMAPINFOHEADER
                    # (fourcc at offset 16, real extradata after biSize=40)
                    fourcc = t.extradata[16:20].decode("ascii", "replace")
                    t.codec_id = "V_" + fourcc.strip("\x00 ").upper()
                    t.extradata = t.extradata[40:]
                return t
        raise ValueError("no video track")

    def _parse_segment(self, p: _Parser, end: int):
        while p.pos < end and not p.eof():
            eid = p.read_id()
            size = p.read_size()
            if size is None:
                if eid == CLUSTER:
                    size = self._unknown_cluster_extent(p)
                else:
                    raise ValueError("unknown-size non-cluster element")
            nxt = p.pos + size
            if eid == INFO:
                self._parse_info(p, nxt)
            elif eid == TRACKS:
                self._parse_tracks(p, nxt)
            elif eid == CLUSTER:
                self._parse_cluster(p, nxt)
            elif eid == CUES:
                self._parse_cues(p, nxt)
            p.pos = nxt

    def _parse_cues(self, p: _Parser, end: int):
        q = _Parser(p.d)
        q.pos = p.pos
        while q.pos < end:
            eid = q.read_id()
            size = q.read_size() or 0
            if eid == CUE_POINT:
                t, pos, sub = -1, -1, _Parser(q.d)
                sub.pos = q.pos
                stop = q.pos + size
                while sub.pos < stop:
                    e2 = sub.read_id()
                    s2 = sub.read_size() or 0
                    if e2 == CUE_TIME:
                        t = int.from_bytes(sub.d[sub.pos:sub.pos + s2],
                                           "big")
                        sub.pos += s2
                    elif e2 == CUE_TRACK_POSITIONS:
                        s3 = _Parser(sub.d)
                        s3.pos = sub.pos
                        while s3.pos < sub.pos + s2:
                            e3 = s3.read_id()
                            sz3 = s3.read_size() or 0
                            if e3 == CUE_CLUSTER_POSITION:
                                pos = int.from_bytes(
                                    s3.d[s3.pos:s3.pos + sz3], "big")
                            s3.pos += sz3
                        sub.pos += s2
                    else:
                        sub.pos += s2
                if t >= 0:
                    self.cues.append((t, pos))
            q.pos += size

    def seek_index(self, track: "MkvTrack", ms: int) -> int:
        """Packet index of the last keyframe at/before ms (the cue-seek
        target an indexed demuxer would pick)."""
        best = 0
        for i, (t, k) in enumerate(zip(track.times_ms, track.keyflags)):
            if k and t <= ms:
                best = i
        return best

    def _unknown_cluster_extent(self, p: _Parser) -> int:
        """Size of an unknown-length cluster: scan to the next top-level."""
        probe = _Parser(p.d)
        probe.pos = p.pos
        while not probe.eof():
            save = probe.pos
            try:
                eid = probe.read_id()
                size = probe.read_size()
            except (ValueError, IndexError):
                break
            if eid in _TOP_LEVEL:
                return save - p.pos
            probe.pos += 0 if size is None else size
        return len(p.d) - p.pos

    def _parse_info(self, p: _Parser, end: int):
        while p.pos < end:
            eid = p.read_id()
            size = p.read_size() or 0
            if eid == TIMECODE_SCALE:
                self.timecode_scale = int.from_bytes(
                    p.d[p.pos:p.pos + size], "big")
            p.pos += size

    def _parse_tracks(self, p: _Parser, end: int):
        while p.pos < end:
            eid = p.read_id()
            size = p.read_size() or 0
            if eid == TRACK_ENTRY:
                t = self._parse_track_entry(p, p.pos + size)
                self.tracks[t.number] = t
            p.pos += size

    def _parse_track_entry(self, p: _Parser, end: int) -> MkvTrack:
        t = MkvTrack()
        pos = p.pos
        q = _Parser(p.d)
        q.pos = pos
        while q.pos < end:
            eid = q.read_id()
            size = q.read_size() or 0
            body = q.d[q.pos:q.pos + size]
            if eid == TRACK_NUMBER:
                t.number = int.from_bytes(body, "big")
            elif eid == CODEC_ID:
                t.codec_id = body.decode("ascii", "replace").rstrip("\x00")
            elif eid == CODEC_PRIVATE:
                t.extradata = bytes(body)
            elif eid == DEFAULT_DURATION:
                t.default_duration_ns = int.from_bytes(body, "big")
            elif eid == VIDEO:
                r = _Parser(q.d)
                r.pos = q.pos
                vend = q.pos + size
                while r.pos < vend:
                    vid = r.read_id()
                    vsz = r.read_size() or 0
                    vb = r.d[r.pos:r.pos + vsz]
                    if vid == PIXEL_WIDTH:
                        t.width = int.from_bytes(vb, "big")
                    elif vid == PIXEL_HEIGHT:
                        t.height = int.from_bytes(vb, "big")
                    r.pos += vsz
            q.pos += size
        return t

    def _add_block(self, body: bytes, cluster_tc: int, keyframe: bool):
        tnum, pos = _vint_at(body, 0)
        rel = struct.unpack_from(">h", body, pos)[0]
        flags = body[pos + 2]
        frames = _parse_lace(body, pos + 3, flags)
        t = self.tracks.get(tnum)
        if t is None:
            return
        ms = (cluster_tc + rel) * self.timecode_scale // 1_000_000
        for fr in frames:
            t.packets.append(fr)
            t.keyflags.append(keyframe)
            t.times_ms.append(ms)

    def _parse_cluster(self, p: _Parser, end: int):
        tc = 0
        q = _Parser(p.d)
        q.pos = p.pos
        while q.pos < end:
            eid = q.read_id()
            size = q.read_size() or 0
            body = q.d[q.pos:q.pos + size]
            if eid == CLUSTER_TIMECODE:
                tc = int.from_bytes(body, "big")
            elif eid == SIMPLE_BLOCK:
                self._add_block(body, tc, bool(body and
                                               body[_vint_at(body, 0)[1] + 2]
                                               & 0x80))
            elif eid == BLOCK_GROUP:
                blk = None
                has_ref = False
                r = _Parser(q.d)
                r.pos = q.pos
                gend = q.pos + size
                while r.pos < gend:
                    gid = r.read_id()
                    gsz = r.read_size() or 0
                    if gid == BLOCK:
                        blk = r.d[r.pos:r.pos + gsz]
                    elif gid == REFERENCE_BLOCK:
                        has_ref = True
                    r.pos += gsz
                if blk is not None:
                    self._add_block(blk, tc, not has_ref)
            q.pos += size
