"""SM cycles a link of the dependent chains that bound the serial kernels
(``latency.cu``): K2's and K6's table lookup, K4's coder step (K7's
too), a branch on a value just computed, K5's row, the ladder's climb and
a level of K18's argmax butterfly.  ``build()``
compiles ``latency.cu`` with nvcc into ``build/latency/`` (keyed by its
source and flags); ``measure()`` runs each chain for 2^14 links in one
warp and returns the cycles a link by chain.  Needs a CUDA card;
``chip_smoke.py`` calls both.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

CHAINS = ("IADD3 LDS.U8", "IMAD IADD SHF LOP3", "IMAD ISETP BRA",
          "K5 row", "ladder climb", "K18 argmax level")
LOOKUP, K4_STEP, BRANCH, K5_ROW, LADDER_CLIMB, K18_LEVEL = CHAINS
LINKS = 1 << 14


def build() -> str:
    """The path of the built ``liblatency.so``."""
    from .. import _build
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "latency.cu")
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_build.NVCC_FLAGS).encode())
    out = os.path.join(os.path.dirname(_build.BUILD_ROOT), "latency",
                       key.hexdigest()[:16])
    so = os.path.join(out, "liblatency.so")
    if not os.path.exists(so):
        os.makedirs(out, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        so, src], check=True, capture_output=True)
    return so


def measure() -> dict:
    """Cycles a link of each chain of ``CHAINS``, one warp."""
    import ctypes
    import torch
    fn = ctypes.CDLL(build()).ffv2_latency
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator().manual_seed(0)
    inp = torch.randint(0, 1 << 30, (1024,), generator=g,
                        dtype=torch.int32)
    inp[64], inp[65], inp[66] = 1, 3, 0x100
    inp = inp.cuda()
    cyc = torch.zeros(len(CHAINS), dtype=torch.int64, device="cuda")
    sink = torch.zeros(128, dtype=torch.int32, device="cuda")
    for _ in range(2):      # the second run is the one kept
        if fn(inp.data_ptr(), LINKS, cyc.data_ptr(), sink.data_ptr(),
              torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("latency: launch failed")
        torch.cuda.synchronize()
    return {k: v / LINKS for k, v in zip(CHAINS, cyc.tolist())}
