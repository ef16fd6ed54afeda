"""Build, bind and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own nvcc process, all started
together, and the objects link into ONE shared library with a plain C
interface (every launcher is ``extern "C"`` and returns its
``cudaError_t``), loaded with ctypes.  The build happens on first use,
into ``build/torch_kernels/<hash>/`` at the root of the checkout, keyed by
a hash of the sources and the flags, so a fresh checkout builds
everything it runs.  Importing this module builds nothing: the CPU tests
import every module on machines with no nvcc.

Each kernel is a :class:`Kernel`: its wrapper calls it only for CUDA
tensors, and ``launches`` counts the launches that the launcher accepted.
``plain_calls`` counts the wrapper's calls that took the plain PyTorch
version, which it does only for CPU tensors.  The library also answers a
few plain C queries (``_QUERIES``): the ladder's scratch size and chunk,
K18's class of a band length, and the device launches that the launchers
of several kernels made (``device_launches``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from .utils import metrics

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libffv2_torch_kernels.so"

P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_longlong

_lock = threading.Lock()
_lib = None
# the library's plain C queries: (symbol, argtypes, restype)
_QUERIES = (("ffv2_kernel_launches", [], I64),
            ("ffv2_ladder_scratch_bytes", [I, I], I64),
            ("ffv2_ladder_chunk", [], I),
            ("ffv2_pvq_class_of", [I], I),
            ("ffv2_pvq_class_items", [I], I))


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path() -> str:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def build() -> str:
    """Compile the library unless this hash is built; returns its path.
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside it as build.log."""
    path = library_path()
    if os.path.exists(path):
        return path
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    cu = [s for s in _sources() if s.endswith(".cu")]
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        so = os.path.join(tmp, LIB_NAME)
        if all(p.returncode == 0 for p in procs):
            res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so,
                                  *objs], capture_output=True, text=True)
            logs.append(res.stdout + res.stderr)
        log = "".join(logs)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(log)
        if not os.path.exists(so):
            raise RuntimeError("nvcc failed:\n" + log)
        os.replace(so, path)
    return path


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process and bind
    every kernel's launcher onto its ``Kernel``.  The first load is a call
    record ``library load`` on ``metrics.TRACE``: a stage ``build`` when
    nvcc runs, then ``library bind``."""
    global _lib
    with _lock:
        if _lib is None:
            with metrics.TRACE.call("library load", 0):
                path = library_path()
                if not os.path.exists(path):
                    build()
                    metrics.TRACE("build")
                lib = ctypes.CDLL(path)
                lib.ffv2_error_string.argtypes = [I]
                lib.ffv2_error_string.restype = ctypes.c_char_p
                for name, args, res in _QUERIES:
                    fn = getattr(lib, name)
                    fn.argtypes = args
                    fn.restype = res
                for k in KERNELS.values():
                    k.bind(lib)
                _lib = lib
                metrics.TRACE("library bind")
        return _lib


class Kernel:
    """One launcher of the library, with its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: list,
                 source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.plain_calls = 0
        self._fn = None              # the bound launcher, set by bind()

    def bind(self, lib):
        """Bind the launcher of ``lib`` (its argument and result types)
        onto this kernel; returns it."""
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = I
        self._fn = fn
        return fn

    def plain_for(self, device) -> bool:
        """Whether the wrapper takes the plain version: True (and counted)
        for CPU tensors, False for CUDA tensors; other devices raise."""
        if device.type == "cpu":
            self.plain_calls += 1
            return True
        if device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {device}")
        return False

    def check(self, name: str, t, shape, device, dtype=torch.int32):
        """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
        on ``device``."""
        if (t.dtype != dtype or t.shape != tuple(shape) or t.device != device
                or not t.is_contiguous()):
            raise ValueError(
                f"{self.name}: {name} must be a contiguous {dtype} "
                f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous: "
                f"{t.is_contiguous()})")

    def launch(self, *args) -> None:
        """Call the launcher (pointers and the stream as ints); raise if
        CUDA refused the launch.  Once bound, a launch takes no lock and
        no lookup."""
        fn = self._fn or self.bind(load())
        err = fn(*args)
        if err:
            msg = load().ffv2_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel: CUDA error {err}: {msg}")
        self.launches += 1


KERNELS = {k.name: k for k in (
    Kernel("phase_a", "ffv2_phase_a",
           [P, I, I, P, P, P, P, I64, I64, I64, I64, I, I, I, P, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/phase_a.cu",
           "none, ffmpeg_ffv2_tpu/ffv1/tpu.py:122 plane_context_diff (XLA, "
           "no Pallas body)"),
    Kernel("place", "ffv2_place_cells",
           [P, P, P, I, P, P, P, I, P, P, P, I, I, P, P, P, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/place.cu",
           "ffmpeg_ffv2_tpu/ops/place_pallas.py:63"),
    Kernel("adapt", "ffv2_adapt", [P, P, P, P, P, P, P, I, I, I, P, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/adapt.cu",
           "ffmpeg_ffv2_tpu/ffv1/adapt_pallas.py:189"),
    Kernel("adapt_emission", "ffv2_adapt_emission",
           [P, P, P, P, P, P, P, I, I, I, I, P, P, P, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/adapt.cu",
           "ffmpeg_ffv2_tpu/ffv1/adapt_pallas.py:36"),
    Kernel("emission_pack", "ffv2_emission_pack",
           [P, P, P, P, I, I, I, I, P, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/adapt.cu",
           "ffmpeg_ffv2_tpu/ffv1/device_coder.py:255 (repack_emission_order "
           "under _repack_jit :321, XLA; no Pallas counterpart)"),
    Kernel("expand", "ffv2_expand",
           [P, I, P, P, P, P, I, I, I, I, P, P, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/expand.cu",
           "ffmpeg_ffv2_tpu/ffv1/expand_pallas.py:130"),
    Kernel("rac_render", "ffv2_rac_render", [P, I, I, I, P, I, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/rac_render.cu",
           "ffmpeg_ffv2_tpu/ffv1/pallas_coder.py:109 + "
           "ffmpeg_ffv2_tpu/ffv1/render_pallas.py:62,163"),
    Kernel("vlc", "ffv2_vlc", [P, P, P, P, P, P, I, I, I, I, P, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/vlc.cu",
           "ffmpeg_ffv2_tpu/ffv1/device_rice.py:448"),
    Kernel("ladder", "ffv2_ladder", [P, P, P, P, P, I, I, P, P, I64, P],
           "ffmpeg_ffv2_tpu_torch/csrc/ladder.cu",
           "ffmpeg_ffv2_tpu/ffv1/device_rice.py:124 (a lax.scan; no Pallas "
           "counterpart)"),
    Kernel("rac_lanes", "ffv2_rac_lanes", [P, P, P, I, I, P, P, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/rac_lanes.cu",
           "ffmpeg_ffv2_tpu/ffv1/pallas_coder.py:31"),
    Kernel("pvq", "ffv2_pvq", [P, I, I, P, I, I, P, P, P, I, P],
           "ffmpeg_ffv2_tpu_torch/csrc/ffv2_quant.cu",
           "ffmpeg_ffv2_tpu/ffv2/tpu.py:233 _pvq_band_device + :293 "
           "_quantize_streams (XLA, a lax.scan; no Pallas counterpart)"),
    Kernel("lap_pre", "ffv2_lap_pre", [P, P, I, I, I, I, P],
           "ffmpeg_ffv2_tpu_torch/csrc/ffv2_lap.cu",
           "ffmpeg_ffv2_tpu/ffv2/tpu.py:77 _jx_lap_prefilter (as "
           "_jx_frame_hor/_jx_frame_ver :122-150 apply it; XLA, no Pallas "
           "counterpart)"),
    Kernel("lap_post", "ffv2_lap_post", [P, P, I, I, I, I, P],
           "ffmpeg_ffv2_tpu_torch/csrc/ffv2_lap.cu",
           "ffmpeg_ffv2_tpu/ffv2/tpu.py:100 _jx_lap_postfilter (as "
           "_jx_frame_ver/_jx_frame_hor :122-150 apply it; XLA, no Pallas "
           "counterpart)"),
    Kernel("sort", "ffv2_sort",
           [P, P, I, I, I, I, I, I, P, I, P, P, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/sort.cu",
           "ffmpeg_ffv2_tpu/ops/sort_pallas.py:90"),
    Kernel("rowsort", "ffv2_rowsort",
           [P, P, I, I, I, I, I, I, P, I, P, P, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/sort.cu",
           "ffmpeg_ffv2_tpu/ops/sort_pallas.py:261"),
    Kernel("roll", "ffv2_roll", [P, I, I, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/prims.cu",
           "tools/microbench_pallas.py:35"),
    Kernel("rowcx", "ffv2_rowcx", [P, I, I, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/prims.cu",
           "tools/microbench_pallas.py:42"),
    Kernel("transpose", "ffv2_transpose", [P, I, I, I, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/prims.cu",
           "tools/microbench_pallas.py:55"),
    Kernel("probe_scalar_extract", "ffv2_probe_scalar_extract", [P, I, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/probes.cu",
           "tools/probe_mosaic.py:33"),
    Kernel("probe_scalar_in_ds", "ffv2_probe_scalar_in_ds", [P, I, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/probes.cu",
           "tools/probe_mosaic.py:46"),
    Kernel("probe_big_prefetch", "ffv2_probe_big_prefetch",
           [P, I, P, I, P, P], "ffmpeg_ffv2_tpu_torch/csrc/probes.cu",
           "tools/probe_mosaic.py:63"),
    Kernel("probe_roll_dynamic", "ffv2_probe_roll_dynamic", [P, I, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/probes.cu",
           "tools/probe_mosaic.py:86"),
    Kernel("probe_taa_rows", "ffv2_probe_taa_rows", [P, P, I, P, P],
           "ffmpeg_ffv2_tpu_torch/csrc/probes.cu",
           "tools/probe_mosaic.py:99"),
)}


def device_launches(fn) -> int:
    """The kernel launches that the multi-kernel launchers (ladder, pvq)
    made while fn() ran, as the library counts them."""
    lib = load()
    before = lib.ffv2_kernel_launches()
    fn()
    return lib.ffv2_kernel_launches() - before


def reset_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.plain_calls = 0


def stream_handle(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as an int.  The
    device's index, not its ``torch.device``, is the cheaper public route
    (``tools/kernel_times.py``'s host split, PERF.md §6)."""
    return torch.cuda.current_stream(t.get_device()).cuda_stream
