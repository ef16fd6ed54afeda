"""Op-stream expansion: per-pixel sv words -> per-slice rac op words.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/expand_pallas.py:
expand_ops_reference`` and of the TPU kernel ``expand_pallas``
(``_expand_kernel``).  ``expand`` launches the CUDA kernel
``csrc/expand.cu`` (K3) on CUDA tensors and takes the plain
``expand_plain`` on CPU tensors.

Op words are ``[mode:2 | bit:1 | sv:8]`` (bits [10:9], [8], [7:0]).  Slice
s holds its prefix ops (keyframe bit, headers) at positions < hlen[s],
NOPs up to hpad, then every pixel's put_symbol ops in emission order, the
terminator (sv 129, bit 0) at total[s] and the two flush ops after it.
"""

from __future__ import annotations

import torch

from .. import _build
from .host import TERMINATOR_SV
from .symbols import event_count, exponent

MODE_NOP, MODE_OP, MODE_FLUSH1, MODE_FLUSH2 = 0, 1, 2, 3
_K = _build.KERNELS["expand"]
CHUNK = 1024        # pixels a block of the kernel (csrc/expand.cu CHUNK)


def op_bases(diff, hpad: int):
    """(base, total): each pixel's first op position, hpad + the exclusive
    cumsum of the op counts per slice, and the slice's op count before
    the tail ops."""
    counts = event_count(diff)
    csum = torch.cumsum(counts, dim=1, dtype=torch.int32)
    return hpad + csum - counts, hpad + csum[:, -1]


def expand_plain(words, diff, svp, btp, hlen, op_cap: int):
    """Plain version built on repeat_interleave and cumsum.

    words (W, S, npix) int32 emission-order packed sv words (byte k of
    word k >> 2 is the sv of the pixel's k-th op); diff (S, npix);
    svp/btp (S, hpad) prefix ops; hlen (S,).  Returns (opw (S, op_cap)
    int32, n_ops (S,) = total + 3)."""
    W, S, npix = words.shape
    dev = diff.device
    base, total = op_bases(diff, svp.shape[1])
    counts = event_count(diff).reshape(-1)
    rec = torch.repeat_interleave(torch.arange(S * npix, device=dev),
                                  counts.long())
    first = (torch.cumsum(counts, 0, dtype=torch.int32) - counts)[rec]
    k = torch.arange(rec.shape[0], dtype=torch.int32, device=dev) - first
    d = diff.reshape(-1)[rec]
    a = d.abs()
    e = exponent(a)
    mant = torch.clamp(2 * e + 1 - k, min=0)
    bit = torch.where(
        k == 0, (d == 0).to(torch.int32),
        torch.where(k <= e, 1,
                    torch.where(k == e + 1, 0,
                                torch.where(k <= 2 * e + 1, (a >> mant) & 1,
                                            (d < 0).to(torch.int32)))))
    wsel = (k >> 2).long()
    src = words.reshape(W, -1)[wsel.clamp(max=W - 1), rec]
    sv = torch.where(wsel < W, (src >> ((k & 3) * 8)) & 0xFF, 0)
    pos = base.reshape(-1)[rec] + k
    keep = pos < op_cap
    opw = torch.zeros((S, op_cap), dtype=torch.int32, device=dev)
    opw[(rec // npix)[keep], pos[keep].long()] = (
        sv | (bit << 8) | (MODE_OP << 9))[keep].to(torch.int32)
    hpad = svp.shape[1]
    r = torch.arange(hpad, dtype=torch.int32, device=dev)[None, :]
    hdr = torch.where(r < hlen[:, None],
                      (svp & 0xFF) | (btp << 8) | (MODE_OP << 9), 0)
    n = min(hpad, op_cap)
    opw[:, :n] = hdr[:, :n]             # pixel ops start at hpad
    rows = torch.arange(S, device=dev)
    for j, word in enumerate((TERMINATOR_SV | (MODE_OP << 9),
                              MODE_FLUSH1 << 9, MODE_FLUSH2 << 9)):
        pos = (total + j).long()
        ok = pos < op_cap
        opw[rows[ok], pos[ok]] = word
    return opw, total + 3


def expand(words, diff, svp, btp, hlen, op_cap: int):
    """K3 wrapper: (opw (S, op_cap) int32, n_ops (S,) int32).  The kernel
    writes every word of opw and n_ops itself."""
    W, S, npix = words.shape
    dev = diff.device
    hpad = svp.shape[1]
    _K.check("words", words, (W, S, npix), dev)
    _K.check("diff", diff, (S, npix), dev)
    _K.check("svp", svp, (S, hpad), dev)
    _K.check("btp", btp, (S, hpad), dev)
    _K.check("hlen", hlen, (S,), dev)
    if _K.plain_for(dev):
        return expand_plain(words, diff, svp, btp, hlen, op_cap)
    # n_ops, then the kernel's per-chunk op counts
    n_ops = torch.empty(S * (1 + max(1, -(-npix // CHUNK))),
                        dtype=torch.int32, device=dev)
    opw = torch.empty((S, op_cap), dtype=torch.int32, device=dev)
    _K.launch(words.data_ptr(), W, diff.data_ptr(), svp.data_ptr(),
              btp.data_ptr(), hlen.data_ptr(), S, npix, hpad, op_cap,
              n_ops.data_ptr() + 4 * S, opw.data_ptr(), n_ops.data_ptr(),
              _build.stream_handle(diff))
    return opw, n_ops[:S]
