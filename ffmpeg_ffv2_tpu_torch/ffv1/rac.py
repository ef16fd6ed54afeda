"""Range coding and packet-byte rendering of every slice's op stream.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/tpu_coder.py:rac_scan_lanes``,
``ffmpeg_ffv2_tpu/ffv1/device_coder.py:render_bytes_fast`` /
``render_bytes`` and of the TPU kernels ``pallas_coder.py:
rac_pallas_packed`` (``_coder_kernel_packed``) and ``render_pallas.py:
render_bytes_pallas`` (``_compact_kernel``, ``_place_bytes_kernel``).
``rac_render`` launches the CUDA kernel ``csrc/rac_render.cu`` (K4), which
codes and renders in one pass, on CUDA tensors and takes the plain
``rac_render_plain`` on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from .expand import MODE_OP, MODE_FLUSH1, MODE_FLUSH2

_K = _build.KERNELS["rac_render"]


def rac_scan_lanes(sv, bit, mode):
    """Plain coder: the range-coder recursion for all lanes, one Python
    step per op.  sv/bit/mode int32 (steps, lanes) -> staged events
    (first byte, -1 = none; fill count; fill value), each (steps, lanes)
    int32."""
    steps, lanes = sv.shape
    dev = sv.device
    i32 = torch.int32
    low = torch.zeros(lanes, dtype=i32, device=dev)
    rng = torch.full((lanes,), 0xFF00, dtype=i32, device=dev)
    pending = torch.full((lanes,), -1, dtype=i32, device=dev)
    pcount = torch.zeros(lanes, dtype=i32, device=dev)
    first, fcount, fval = [], [], []
    for i in range(steps):
        s, b, m = sv[i], bit[i], mode[i]
        is_op = m == MODE_OP
        is_flush1 = m == MODE_FLUSH1
        is_flush = is_flush1 | (m == MODE_FLUSH2)
        r1 = (rng * s) >> 8
        low_op = torch.where(b != 0, low + rng - r1, low)
        rng_op = torch.where(b != 0, r1, rng - r1)
        low1 = torch.where(is_op, low_op,
                           torch.where(is_flush1, low + 0xFF, low))
        rng1 = torch.where(is_op, rng_op, torch.where(is_flush, 0xFF, rng))
        renorm = (rng1 < 0x100) & (is_op | is_flush)
        case_b = pending < 0
        case_c = low1 <= 0xFF00
        case_d = low1 >= 0x10000
        emit = renorm & ~case_b & (case_c | case_d)
        first.append(torch.where(
            emit, torch.where(case_c, pending, pending + 1) & 0xFF, -1))
        fcount.append(torch.where(emit, pcount, 0))
        fval.append(torch.where(case_c, 0xFF, 0x00))
        pending = torch.where(
            renorm,
            torch.where(case_b | case_c, low1 >> 8,
                        torch.where(case_d, (low1 >> 8) & 0xFF, pending)),
            pending)
        pcount = torch.where(
            renorm,
            torch.where(case_b | case_c | case_d,
                        torch.where(case_b, pcount, 0), pcount + 1),
            pcount)
        low = torch.where(renorm, (low1 & 0xFF) << 8, low1)
        rng = torch.where(renorm, rng1 << 8, rng1)
    if not steps:
        return (torch.empty((0, lanes), dtype=i32, device=dev),) * 3
    return (torch.stack(first).to(i32), torch.stack(fcount).to(i32),
            torch.stack(fval).to(i32))


def render_bytes(first, fcount, fval, buf_cap: int):
    """Plain render: staged events (n_slices, steps) -> (bytes uint8
    (n_slices, buf_cap), lengths int32 (n_slices,)).  Each emitting step
    appends its first byte, then fcount copies of fval; bytes at or past
    a slice's length are 0.  Byte p comes from the event whose span
    holds p, found by a searchsorted over the events' end offsets."""
    emit = first >= 0
    nbytes = torch.where(emit, 1 + fcount, 0).to(torch.int64)
    endo = torch.cumsum(nbytes, dim=-1)
    total = endo[:, -1]
    pos = torch.arange(buf_cap, dtype=torch.int64, device=first.device)
    pos = pos.expand(first.shape[0], buf_cap).contiguous()
    j = torch.searchsorted(endo, pos, right=True).clamp(
        max=first.shape[1] - 1)
    at_first = pos == (endo - nbytes).gather(1, j)
    byte = torch.where(at_first, first.gather(1, j), fval.gather(1, j))
    byte = torch.where(pos < total[:, None], byte & 0xFF, 0)
    return byte.to(torch.uint8), total.to(torch.int32)


def rac_render_plain(opw, steps: int, buf_cap: int):
    """Plain version of K4: the coder over the first ``steps`` op words of
    each slice, then the render.  The trailing NOP ops change nothing, so
    the coder stops after the last op of the longest slice."""
    live = (opw[:, :steps] != 0).any(dim=0).nonzero()
    steps = int(live[-1]) + 1 if live.numel() else 1
    opT = opw[:, :steps].T
    f, c, v = rac_scan_lanes(opT & 0xFF, (opT >> 8) & 1, (opT >> 9) & 3)
    return render_bytes(f.T, c.T, v.T, buf_cap)


def rac_render(opw, steps: int, buf_cap: int):
    """K4 wrapper: code the first ``steps`` op words of each slice of opw
    (S, op_cap) int32 and render them: (bytes uint8 (S, buf_cap),
    lengths int32 (S,)); a length above buf_cap means the row was cut."""
    S, op_cap = opw.shape
    dev = opw.device
    _K.check("opw", opw, (S, op_cap), dev)
    if not 0 < steps <= op_cap:
        raise ValueError(f"rac_render: need 0 < steps <= {op_cap}, got "
                         f"{steps}")
    if _K.plain_for(dev):
        return rac_render_plain(opw, steps, buf_cap)
    out = torch.zeros((S, buf_cap), dtype=torch.uint8, device=dev)
    lengths = torch.empty(S, dtype=torch.int32, device=dev)
    _K.launch(opw.data_ptr(), op_cap, steps, S, out.data_ptr(), buf_cap,
              lengths.data_ptr(), _build.stream_handle(opw))
    return out, lengths
