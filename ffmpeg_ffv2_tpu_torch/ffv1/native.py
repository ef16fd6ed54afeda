"""Copy of ``ffmpeg_ffv2_tpu/ffv1/native.py``: the ``NativeFFV1Codec``
ctypes wrapper (encode, decode, the frame-pipelined decode, the
damaged-slice query, the encode from precomputed symbols and pass-1
statistics) and the signatures of the runtime's planner and 2-pass
entry points; and, the port's own, ``crc32`` and ``crc32_trailer``, the
runtime's slice CRC, which the port's encoders put in their trailers
(``core/crc.py`` keeps the plain Python loop).

The C++ FFV1 codec (``native/ffv1_runtime.cpp``, a copy of the JAX
package's runtime) is the port's byte-exactness oracle: the same bitstream
as the scalar Python oracle, slice-threaded.  It links into one library
with the FFV2 runtime (``native/ffv2_runtime.cpp``, bound by
``ffv2/native.py``), as the JAX package's ``native/Makefile`` links the
two.  The library builds with g++ on first use into
``build/native/<hash>/`` at the root of the checkout, keyed by a hash of
the sources, the flags and the compiler's version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from .params import FFV1Params

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = [os.path.join(_PKG, "native", f)
        for f in ("ffv1_runtime.cpp", "ffv2_runtime.cpp")]
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "native")
# -fno-peephole2: g++ 13.3's peephole2 pass (x86-64, -O3) rewrote the
# absolute value in put_symbol_stats, {bp = v; bp = -bp; bp = bp >= 0 ? bp :
# v}, into {dx = -dx; bp = dx; bp = dx >= 0 ? dx : bp}, which copies v
# after its negation, so |v| came out as -v for every positive residual
# (a 1080p yuv420p key frame of 1317490 bytes for 772012 with pass-1
# statistics on).  Whether the pattern forms depends on register
# allocation, which other flags only move (-fno-strict-aliasing among
# them), so the pass is off; tools/native_check.py holds builds against
# -O0.
_CXX_FLAGS = ["-O3", "-fno-peephole2", "-std=c++17", "-fPIC", "-shared",
              "-pthread"]

_lib = None
_lib_lock = threading.Lock()


class FFV1ParamsC(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int32),
        ("micro_version", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("colorspace", ctypes.c_int32),
        ("bits", ctypes.c_int32),
        ("chroma_planes", ctypes.c_int32),
        ("chroma_h_shift", ctypes.c_int32),
        ("chroma_v_shift", ctypes.c_int32),
        ("transparency", ctypes.c_int32),
        ("ac", ctypes.c_int32),
        ("ec", ctypes.c_int32),
        ("intra", ctypes.c_int32),
        ("context_model", ctypes.c_int32),
        ("num_h_slices", ctypes.c_int32),
        ("num_v_slices", ctypes.c_int32),
        ("plane_count", ctypes.c_int32),
        ("use32bit", ctypes.c_int32),
        ("quant_table_count", ctypes.c_int32),
        ("context_counts", ctypes.c_int32 * 8),
        ("quant_tables", ctypes.c_int16 * (8 * 5 * 256)),
        ("state_transition", ctypes.c_uint8 * 256),
    ]


@functools.lru_cache(maxsize=None)
def _compiler_id() -> str:
    """``g++ --version``'s first line: a build is keyed by its compiler
    too, so that a checkout copied to a host with another g++ builds
    anew rather than loading the other compiler's library."""
    res = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True)
    return res.stdout.split("\n", 1)[0]


def library_path(flags=_CXX_FLAGS, srcs=_SRC) -> str:
    h = hashlib.sha256(" ".join([_compiler_id(), *flags]).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], "libffv1rt.so")


def build(flags=_CXX_FLAGS, srcs=_SRC) -> str:
    """Compile the runtime unless this hash is built; returns its path.
    ``flags`` and ``srcs`` other than the defaults build a variant beside
    it (``tools/native_check.py`` holds builds at other flags against
    each other)."""
    path = library_path(flags, srcs)
    if os.path.exists(path):
        return path
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        res = subprocess.run(["g++", *flags, "-o", tmp, *srcs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("g++ failed:\n" + res.stdout + res.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def get_lib():
    """The runtime built at the default flags, loaded and bound once."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def load(path):
    """Load a build of the runtime and bind its FFV1 entry points."""
    lib = ctypes.CDLL(path)
    lib.ffv1rt_create.restype = ctypes.c_void_p
    lib.ffv1rt_create.argtypes = [ctypes.POINTER(FFV1ParamsC),
                                  ctypes.c_int]
    lib.ffv1rt_destroy.argtypes = [ctypes.c_void_p]
    lib.ffv1rt_encode.restype = ctypes.c_int64
    lib.ffv1rt_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.ffv1rt_decode.restype = ctypes.c_int32
    lib.ffv1rt_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.ffv1rt_decode_pipelined.restype = ctypes.c_int32
    lib.ffv1rt_decode_pipelined.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    lib.ffv1rt_slice_damaged.restype = ctypes.c_int32
    lib.ffv1rt_slice_damaged.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ffv1rt_set_initial_states.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.ffv1rt_encode_sym.restype = ctypes.c_int64
    lib.ffv1rt_encode_sym.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.ffv1rt_set_stats_mode.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.ffv1rt_get_stats.restype = ctypes.c_int32
    lib.ffv1rt_get_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
    lib.ffv1rt_sort_stt.restype = ctypes.c_int32
    lib.ffv1rt_sort_stt.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8)]
    lib.ffv1rt_find_best_state.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
    # the hybrid lane coder's planners (tpu_coder.py)
    planner = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
               ctypes.c_int]
    lib.ffv1rt_plan.restype = ctypes.c_int64
    lib.ffv1rt_plan.argtypes = planner
    lib.ffv1rt_plan_golomb.restype = ctypes.c_int64
    lib.ffv1rt_plan_golomb.argtypes = planner
    lib.ffv1rt_get_plan.restype = ctypes.c_int64
    lib.ffv1rt_get_plan.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64]
    lib.ffv1rt_get_plan_bits.restype = ctypes.c_int64
    lib.ffv1rt_get_plan_bits.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64]
    lib.ffv1rt_get_plan_rows.restype = ctypes.c_int64
    lib.ffv1rt_get_plan_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64]
    lib.ffv1rt_replan_pcm.restype = ctypes.c_int64
    lib.ffv1rt_replan_pcm.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    lib.ffv1rt_set_budget_override.argtypes = [
        ctypes.c_void_p, ctypes.c_int64]
    lib.ffv1rt_crc32.restype = ctypes.c_uint32
    lib.ffv1rt_crc32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_uint32]
    return lib


def crc32(data: bytes, crc: int = 0) -> int:
    """CRC-32/IEEE of ``data`` from ``crc`` in the runtime's table loop
    (``ffv1rt_crc32``): the value of ``core.crc.crc32_ieee``."""
    data = bytes(data)
    return get_lib().ffv1rt_crc32(data, len(data), crc & 0xFFFFFFFF)


def crc32_trailer(data: bytes) -> bytes:
    """4-byte little-endian CRC trailer, ``core.crc.crc32_trailer`` in
    the runtime's table loop; crc32_ieee(data + trailer) == 0."""
    return crc32(data).to_bytes(4, "little")


def params_to_c(p: FFV1Params) -> FFV1ParamsC:
    pc = FFV1ParamsC()
    pc.version = p.version
    pc.micro_version = p.micro_version
    pc.width = p.width
    pc.height = p.height
    pc.colorspace = p.colorspace
    pc.bits = p.bits
    pc.chroma_planes = int(p.chroma_planes)
    pc.chroma_h_shift = p.chroma_h_shift
    pc.chroma_v_shift = p.chroma_v_shift
    pc.transparency = int(p.transparency)
    pc.ac = p.ac
    pc.ec = p.ec
    pc.intra = p.intra
    pc.context_model = p.context_model
    pc.num_h_slices = p.num_h_slices
    pc.num_v_slices = p.num_v_slices
    pc.plane_count = p.plane_count
    pc.use32bit = int(p.use32bit)
    nqt = len(p.context_counts)
    pc.quant_table_count = nqt
    for i, cc in enumerate(p.context_counts):
        pc.context_counts[i] = cc
    qt = np.zeros((8, 5, 256), dtype=np.int16)
    qt[:nqt] = p.quant_tables[:nqt]
    ctypes.memmove(pc.quant_tables, qt.ctypes.data, qt.nbytes)
    st = np.ascontiguousarray(p.state_transition, dtype=np.uint8)
    ctypes.memmove(pc.state_transition, st.ctypes.data, 256)
    return pc


class NativeFFV1Codec:
    """Encoder/decoder session backed by the C++ runtime.

    Planes are int32 numpy arrays in coding order (YUV: y,u,v,(a);
    RGB: g,b,r,(a)).
    """

    def __init__(self, p: FFV1Params, n_threads: int = 0, lib=None):
        self.p = p
        self.lib = lib if lib is not None else get_lib()
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, p.slice_count)
        pc = params_to_c(p)
        self.handle = self.lib.ffv1rt_create(ctypes.byref(pc), n_threads)
        if not self.handle:
            raise RuntimeError("ffv1rt_create failed")
        if p.initial_states:
            for qt, init in enumerate(p.initial_states):
                if init is not None:
                    arr = np.ascontiguousarray(init, dtype=np.uint8)
                    self.lib.ffv1rt_set_initial_states(
                        self.handle, qt,
                        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                        arr.nbytes)

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.ffv1rt_destroy(self.handle)
            self.handle = None

    def _plane_ptrs(self, planes):
        arrs = [np.ascontiguousarray(pl, dtype=np.int32) for pl in planes]
        ptrs = (ctypes.c_void_p * len(arrs))(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in arrs])
        return arrs, ptrs

    def encode(self, planes, keyframe: bool) -> bytes:
        arrs, ptrs = self._plane_ptrs(planes)
        cap = 16384 + 4 * 37 * self.p.width * self.p.height
        out = np.empty(cap, dtype=np.uint8)
        n = self.lib.ffv1rt_encode(
            self.handle, ptrs, 1 if keyframe else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise RuntimeError("native encode failed")
        return out[:n].tobytes()

    def encode_sym(self, planes, ctx_streams, diff_streams,
                   keyframe: bool) -> bytes:
        """Phase-B entropy coding over precomputed (context, diff) streams
        (one int32 [h, w] pair per coded plane, from the card's phase A in
        tpu_encoder.py)."""
        arrs, ptrs = self._plane_ptrs(planes)
        carrs, cptrs = self._plane_ptrs(ctx_streams)
        darrs, dptrs = self._plane_ptrs(diff_streams)
        cap = 16384 + 4 * 37 * self.p.width * self.p.height
        out = np.empty(cap, dtype=np.uint8)
        n = self.lib.ffv1rt_encode_sym(
            self.handle, ptrs, cptrs, dptrs, len(carrs),
            1 if keyframe else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise RuntimeError("native encode_sym failed")
        return out[:n].tobytes()

    def enable_stats(self):
        """Tally pass-1 statistics in every later encode of this session
        (read them with twopass.collect_stats)."""
        self.lib.ffv1rt_set_stats_mode(self.handle, 1)

    def decode(self, packet: bytes):
        outs = [np.zeros(s, dtype=np.int32) for s in self._plane_shapes()]
        ptrs = (ctypes.c_void_p * len(outs))(
            *[a.ctypes.data_as(ctypes.c_void_p) for a in outs])
        buf = np.frombuffer(packet, dtype=np.uint8)
        ret = self.lib.ffv1rt_decode(
            self.handle,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(packet), ptrs)
        if ret < 0:
            raise ValueError(f"native decode failed ({ret})")
        return outs

    def _plane_shapes(self):
        p = self.p
        if p.colorspace == 0:
            shapes = [(p.height, p.width)]
            if p.chroma_planes:
                cw = -(-p.width >> p.chroma_h_shift)
                ch = -(-p.height >> p.chroma_v_shift)
                shapes += [(ch, cw), (ch, cw)]
            if p.transparency:
                shapes.append((p.height, p.width))
            return shapes
        return [(p.height, p.width)] * (3 + (1 if p.transparency else 0))

    def decode_pipelined(self, packets):
        """Frame-pipelined decode of a packet sequence (the reference's
        frame-thread analogue, pthread_frame.c:473/558 + ffv1dec.c
        per-slice progress): the native runtime streams each slice
        column through all frames, so consecutive inter frames decode
        concurrently on min(threads, slices) cores — no GOP boundaries
        needed.  Keyframe flags are read from the bitstream itself.
        Returns a list of frames (list of int32 planes each)."""
        n = len(packets)
        shapes = self._plane_shapes()
        np_ = len(shapes)
        outs = [[np.zeros(s, dtype=np.int32) for s in shapes]
                for _ in range(n)]
        bufs = [np.frombuffer(pk, dtype=np.uint8) for pk in packets]
        pkt_ptrs = (ctypes.c_void_p * n)(
            *[b.ctypes.data_as(ctypes.c_void_p) for b in bufs])
        sizes = (ctypes.c_int64 * n)(*[len(pk) for pk in packets])
        plane_ptrs = (ctypes.c_void_p * (n * np_))(
            *[a.ctypes.data_as(ctypes.c_void_p)
              for fr in outs for a in fr])
        status = (ctypes.c_int32 * n)()
        ret = self.lib.ffv1rt_decode_pipelined(
            self.handle,
            ctypes.cast(pkt_ptrs, ctypes.POINTER(ctypes.c_void_p)),
            sizes, n,
            ctypes.cast(plane_ptrs, ctypes.POINTER(ctypes.c_void_p)),
            np_, status)
        if ret < 0:
            raise ValueError(f"native pipelined decode failed ({ret})")
        self.last_status = list(status)
        return outs

    def slice_damaged(self, si: int) -> bool:
        return bool(self.lib.ffv1rt_slice_damaged(self.handle, si))
