"""Range coding and packet-byte rendering of every slice's op stream.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/tpu_coder.py:rac_scan_lanes``,
``ffmpeg_ffv2_tpu/ffv1/device_coder.py:render_bytes_fast`` /
``render_bytes`` and of the TPU kernels ``pallas_coder.py:
rac_pallas_packed`` (``_coder_kernel_packed``) and ``render_pallas.py:
render_bytes_pallas`` (``_compact_kernel``, ``_place_bytes_kernel``).
``rac_render`` launches the CUDA kernel ``csrc/rac_render.cu`` (K4), which
codes and renders in one pass, on CUDA tensors and takes the plain
``rac_render_plain`` on CPU tensors.

``rac_lanes`` is the counterpart of the TPU kernel ``pallas_coder.py:
rac_pallas_lanes`` (``_coder_kernel``), the lane coder of the hybrid
encoder over unpacked (sv, bit, mode) ops: it launches ``csrc/
rac_lanes.cu`` (K7) on CUDA tensors and takes the plain ``rac_scan_lanes``
on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from .expand import MODE_OP, MODE_FLUSH1, MODE_FLUSH2

_K = _build.KERNELS["rac_render"]
_K7 = _build.KERNELS["rac_lanes"]


def rac_scan_lanes(sv, bit, mode):
    """Plain coder: the range-coder recursion for all lanes, one Python
    step per op.  sv/bit/mode int32 (steps, lanes) -> staged events
    (first byte, -1 = none; fill count; fill value), each (steps, lanes)
    int32.

    The step's case masks (op with bit 1 or 0, flush 1, any flush) come
    from the modes of all steps at once; per step, an emission needs
    low <= 0xFF00 (case c: fill 0xFF, first byte = pending) or
    low >= 0x10000 (case d: fill 0, first byte = pending + 1), and a
    pending byte (pending >= 0, else case b)."""
    steps, lanes = sv.shape
    dev = sv.device
    i32 = torch.int32
    is_op = mode == MODE_OP
    flush = (mode == MODE_FLUSH1) | (mode == MODE_FLUSH2)
    op1 = is_op & (bit != 0)
    op0 = is_op & (bit == 0)
    add_f1 = (mode == MODE_FLUSH1).to(i32) * 0xFF
    coded = is_op | flush
    low = torch.zeros(lanes, dtype=i32, device=dev)
    rng = torch.full((lanes,), 0xFF00, dtype=i32, device=dev)
    pending = torch.full((lanes,), -1, dtype=i32, device=dev)
    pcount = torch.zeros(lanes, dtype=i32, device=dev)
    first = torch.empty((steps, lanes), dtype=i32, device=dev)
    fcount = torch.empty_like(first)
    fval = torch.empty_like(first)
    for i in range(steps):
        r1 = (rng * sv[i]) >> 8
        d = rng - r1
        low1 = torch.where(op1[i], low + d, low) + add_f1[i]
        rng1 = torch.where(op1[i], r1, torch.where(
            op0[i], d, torch.where(flush[i], 0xFF, rng)))
        renorm = (rng1 < 0x100) & coded[i]
        case_b = pending < 0
        case_c = low1 <= 0xFF00
        c_or_d = case_c | (low1 >= 0x10000)
        settle = renorm & ~case_b
        emit = settle & c_or_d
        hi = low1 >> 8
        first[i] = torch.where(emit, (pending + (~case_c).to(i32)) & 0xFF,
                               -1)
        fcount[i] = torch.where(emit, pcount, 0)
        fval[i] = case_c.to(i32) * 0xFF
        # case b takes low >> 8 whole; c (hi <= 0xFF) and d take its byte
        pending = torch.where(renorm & (case_b | c_or_d),
                              torch.where(case_b, hi, hi & 0xFF), pending)
        pcount = torch.where(settle, torch.where(c_or_d, 0, pcount + 1),
                             pcount)
        low = torch.where(renorm, (low1 & 0xFF) << 8, low1)
        rng = torch.where(renorm, rng1 << 8, rng1)
    return first, fcount, fval


def rac_lanes(sv, bit, mode):
    """K7 wrapper: the lane coder of the hybrid encoder (tpu_coder.py).
    sv/bit/mode contiguous int32 (steps, lanes) on one device -> staged
    (first, fcount, fval), each int32 (steps, lanes), as
    ``rac_scan_lanes`` (its plain version, taken for CPU tensors) gives
    them.  The three outputs are views of one (3, steps, lanes) tensor."""
    steps, lanes = sv.shape
    dev = sv.device
    for name, t in (("sv", sv), ("bit", bit), ("mode", mode)):
        _K7.check(name, t, (steps, lanes), dev)
    if _K7.plain_for(dev):
        return rac_scan_lanes(sv, bit, mode)
    out = torch.empty((3, steps, lanes), dtype=torch.int32, device=dev)
    _K7.launch(sv.data_ptr(), bit.data_ptr(), mode.data_ptr(), steps, lanes,
               out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
               _build.stream_handle(sv))
    return out[0], out[1], out[2]


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
