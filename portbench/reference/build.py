"""Build coder.c with the host's C compiler and bind it with ctypes.

The library lands in ``build/portbench_ref/<hash>/`` at the root of the
checkout, keyed by the source, the flags and the compiler's version, so
only a checkout's first run compiles it.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "coder.c")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "portbench_ref")
FLAGS = ["-O1", "-std=c99", "-fPIC", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_lock = threading.Lock()
_lib = None


def _compiler_id() -> str:
    """``cc --version``'s first line: a build is keyed by its compiler."""
    res = subprocess.run(["cc", "--version"], capture_output=True, text=True,
                         check=True)
    return res.stdout.splitlines()[0]


def library_path(cc_id: str) -> str:
    h = hashlib.sha256(" ".join([cc_id, *FLAGS]).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libpbref.so")


def build() -> str:
    path = library_path(_compiler_id())
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        res = subprocess.run(["cc", *FLAGS, "-o", tmp, SRC],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("cc failed:\n" + res.stdout + res.stderr)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def lib() -> ctypes.CDLL:
    """The coder library, built if needed, loaded once a process."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            so.ref_rac_slice.argtypes = [_P, _P, _I, _P, _I, _P, _P, _I64,
                                         _P, _P, _I64, _P]
            so.ref_rac_slice.restype = _I64
            so.ref_rice_slice.argtypes = [_P, _P, _I, _P, _I, _I, _P, _P,
                                          _P, _P, _P, _P, _I, _P, _P, _I64, _P]
            so.ref_rice_slice.restype = _I64
            _lib = so
        return _lib
