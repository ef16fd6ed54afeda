"""Copy of ``ffmpeg_ffv2_tpu/ffv1/headers.py``.

FFV1 header coding: global extradata, version<2 in-band headers,
version-2 slice tables, and version-3+ slice headers.

Reference layout: ffv1enc.c:write_extradata/write_header/encode_slice_header
and ffv1dec.c:read_extra_header/read_header/decode_slice_header.
"""

from __future__ import annotations

import numpy as np

from ..coder.rac import RangeEncoder, RangeDecoder, DEFAULT_ONE_STATE
from ..coder.symbols import put_symbol, get_symbol, new_states, CONTEXT_SIZE
from ..core.crc import crc32_ieee
from .native import crc32_trailer
from .params import (FFV1Params, CODER_RANGE_CUSTOM, MAX_QUANT_TABLES,
                     context_count_of)


def write_quant_table(c: RangeEncoder, table: np.ndarray):
    state = new_states(1)[0]
    last = 0
    for i in range(1, 128):
        if table[i] != table[i - 1]:
            put_symbol(c, state, i - last - 1, False)
            last = i
    put_symbol(c, state, 128 - last - 1, False)


def write_quant_tables(c: RangeEncoder, tables: np.ndarray):
    for i in range(5):
        write_quant_table(c, tables[i])


def read_quant_table(c: RangeDecoder, scale: int) -> tuple[np.ndarray, int]:
    state = new_states(1)[0]
    table = np.zeros(256, dtype=np.int16)
    i = 0
    v = 0
    while i < 128:
        length = get_symbol(c, state, False) + 1
        if length > 128 - i or length <= 0:
            raise ValueError("invalid quant table run")
        table[i:i + length] = scale * v
        i += length
        v += 1
    for i in range(1, 128):
        table[256 - i] = -table[i]
    table[128] = -table[127]
    return table, 2 * v - 1


def read_quant_tables(c: RangeDecoder) -> tuple[np.ndarray, int]:
    tables = np.zeros((5, 256), dtype=np.int16)
    context_count = 1
    for i in range(5):
        tables[i], ranges = read_quant_table(c, context_count)
        context_count *= ranges
        if context_count > 32768:
            raise ValueError("context count overflow")
    return tables, (context_count + 1) // 2


def _initial_states_all_default(init) -> bool:
    return init is None or bool(np.all(init == 128))


def write_extradata(p: FFV1Params) -> bytes:
    """Global header for version >= 2, CRC-protected (ffv1enc.c:396-467)."""
    c = RangeEncoder()  # extradata always uses the default state tables
    state = new_states(1)[0]
    state2 = new_states(CONTEXT_SIZE)

    put_symbol(c, state, p.version, False)
    if p.version > 2:
        put_symbol(c, state, p.micro_version, False)

    put_symbol(c, state, p.ac, False)
    if p.ac == CODER_RANGE_CUSTOM:
        for i in range(1, 256):
            put_symbol(c, state,
                       int(p.state_transition[i]) - int(DEFAULT_ONE_STATE[i]),
                       True)

    put_symbol(c, state, p.colorspace, False)
    put_symbol(c, state, p.bits, False)
    c.put(state, 0, 1 if p.chroma_planes else 0)
    put_symbol(c, state, p.chroma_h_shift, False)
    put_symbol(c, state, p.chroma_v_shift, False)
    c.put(state, 0, 1 if p.transparency else 0)
    put_symbol(c, state, p.num_h_slices - 1, False)
    put_symbol(c, state, p.num_v_slices - 1, False)

    nqt = len(p.context_counts)
    put_symbol(c, state, nqt, False)
    for i in range(nqt):
        write_quant_tables(c, p.quant_tables[i])

    for i in range(nqt):
        init = p.initial_states[i] if p.initial_states else None
        if not _initial_states_all_default(init):
            c.put(state, 0, 1)
            for j in range(p.context_counts[i]):
                for k in range(CONTEXT_SIZE):
                    pred = int(init[j - 1][k]) if j else 128
                    delta = int(init[j][k]) - pred
                    # int8 cast as in the reference
                    delta = ((delta + 128) & 0xFF) - 128
                    put_symbol(c, state2[k], delta, True)
        else:
            c.put(state, 0, 0)

    if p.version > 2:
        put_symbol(c, state, p.ec, False)
        put_symbol(c, state, p.intra, False)

    data = c.terminate(0)
    return data + crc32_trailer(data)


def read_extradata(extradata: bytes, width: int, height: int) -> FFV1Params:
    """ffv1dec.c:read_extra_header."""
    c = RangeDecoder(extradata)
    state = new_states(1)[0]
    state2 = new_states(CONTEXT_SIZE)

    version = get_symbol(c, state, False)
    if version < 2:
        raise ValueError("invalid version in global header")
    micro = 0
    if version > 2:
        if crc32_ieee(extradata) != 0 or len(extradata) < 4:
            raise ValueError("extradata CRC mismatch")
        c.end -= 4
        micro = get_symbol(c, state, False)
    ac = get_symbol(c, state, False)

    state_transition = DEFAULT_ONE_STATE.copy()
    if ac == CODER_RANGE_CUSTOM:
        for i in range(1, 256):
            state_transition[i] = (get_symbol(c, state, True)
                                   + int(DEFAULT_ONE_STATE[i])) & 0xFF

    colorspace = get_symbol(c, state, False)
    bits = get_symbol(c, state, False)
    chroma_planes = bool(c.get(state, 0))
    chroma_h_shift = get_symbol(c, state, False)
    chroma_v_shift = get_symbol(c, state, False)
    transparency = bool(c.get(state, 0))
    plane_count = 1 + (1 if (chroma_planes or version < 4) else 0) \
        + (1 if transparency else 0)
    num_h_slices = 1 + get_symbol(c, state, False)
    num_v_slices = 1 + get_symbol(c, state, False)

    if chroma_h_shift > 4 or chroma_v_shift > 4:
        raise ValueError("invalid chroma shift")
    if not (0 < num_h_slices <= width) or not (0 < num_v_slices <= height):
        raise ValueError("invalid slice counts")

    nqt = get_symbol(c, state, False)
    if not (0 < nqt <= MAX_QUANT_TABLES):
        raise ValueError("invalid quant table count")

    quant_tables = np.zeros((nqt, 5, 256), dtype=np.int16)
    context_counts = []
    for i in range(nqt):
        quant_tables[i], cc = read_quant_tables(c)
        context_counts.append(cc)

    initial_states = [None] * nqt
    for i in range(nqt):
        if c.get(state, 0):
            init = np.full((context_counts[i], CONTEXT_SIZE), 128,
                           dtype=np.uint8)
            for j in range(context_counts[i]):
                for k in range(CONTEXT_SIZE):
                    pred = int(init[j - 1][k]) if j else 128
                    init[j][k] = (pred + get_symbol(c, state2[k], True)) & 0xFF
            initial_states[i] = init

    ec = 0
    intra = 0
    if version > 2:
        ec = get_symbol(c, state, False)
        if micro > 2:
            intra = get_symbol(c, state, False)

    return FFV1Params(
        version=version, micro_version=micro, width=width, height=height,
        colorspace=colorspace, bits=bits, chroma_planes=chroma_planes,
        chroma_h_shift=chroma_h_shift, chroma_v_shift=chroma_v_shift,
        transparency=transparency, ac=ac, ec=ec, intra=intra,
        context_model=0, num_h_slices=num_h_slices, num_v_slices=num_v_slices,
        plane_count=plane_count, use32bit=(colorspace == 1 and bits >= 16),
        quant_tables=quant_tables, context_counts=context_counts,
        state_transition=state_transition, initial_states=initial_states,
        pix_fmt=deduce_pix_fmt(colorspace, bits, chroma_planes,
                               chroma_h_shift, chroma_v_shift, transparency),
    )


def deduce_pix_fmt(colorspace, bits, chroma_planes, h_shift, v_shift,
                   transparency):
    """Named pixel format from coded header fields (the reverse of
    ffv1dec.c:read_header's pix_fmt deduction switch)."""
    from ..core.pixfmt import _FORMATS
    for f in _FORMATS.values():
        if f.packed:
            continue
        if (f.colorspace == colorspace and f.bits == bits
                and f.transparency == transparency
                and (colorspace != 0
                     or (f.chroma_planes == chroma_planes
                         and (not chroma_planes
                              or (f.chroma_h_shift == h_shift
                                  and f.chroma_v_shift == v_shift))))):
            return f
    return None


def write_v01_header(c: RangeEncoder, p: FFV1Params):
    """In-band keyframe header for version < 2 (ffv1enc.c:write_header)."""
    state = new_states(1)[0]
    put_symbol(c, state, p.version, False)
    put_symbol(c, state, p.ac, False)
    if p.ac == CODER_RANGE_CUSTOM:
        for i in range(1, 256):
            put_symbol(c, state,
                       int(p.state_transition[i]) - int(DEFAULT_ONE_STATE[i]),
                       True)
    put_symbol(c, state, p.colorspace, False)
    if p.version > 0:
        put_symbol(c, state, p.bits, False)
    c.put(state, 0, 1 if p.chroma_planes else 0)
    put_symbol(c, state, p.chroma_h_shift, False)
    put_symbol(c, state, p.chroma_v_shift, False)
    c.put(state, 0, 1 if p.transparency else 0)
    write_quant_tables(c, p.quant_tables[p.context_model])


def read_v01_header(c: RangeDecoder, width: int, height: int,
                    default_bits: int = 0) -> FFV1Params:
    """ffv1dec.c:read_header version<2 branch."""
    state = new_states(1)[0]
    version = get_symbol(c, state, False)
    if version >= 2:
        raise ValueError("invalid version in v0/v1 header")
    ac = get_symbol(c, state, False)
    state_transition = DEFAULT_ONE_STATE.copy()
    if ac == CODER_RANGE_CUSTOM:
        for i in range(1, 256):
            st = get_symbol(c, state, True) + int(DEFAULT_ONE_STATE[i])
            if st < 1 or st > 255:
                raise ValueError("invalid state transition")
            state_transition[i] = st
    colorspace = get_symbol(c, state, False)
    bits = get_symbol(c, state, False) if version > 0 else (default_bits or 8)
    chroma_planes = bool(c.get(state, 0))
    chroma_h_shift = get_symbol(c, state, False)
    chroma_v_shift = get_symbol(c, state, False)
    transparency = bool(c.get(state, 0))

    quant_table, context_count = read_quant_tables(c)
    quant_tables = quant_table[None]

    return FFV1Params(
        version=version, micro_version=0, width=width, height=height,
        colorspace=colorspace, bits=bits or 8, chroma_planes=chroma_planes,
        chroma_h_shift=chroma_h_shift, chroma_v_shift=chroma_v_shift,
        transparency=transparency, ac=ac, ec=0, intra=0,
        context_model=0, num_h_slices=1, num_v_slices=1,
        plane_count=2 + (1 if transparency else 0),
        use32bit=(colorspace == 1 and bits >= 16),
        quant_tables=quant_tables, context_counts=[context_count],
        state_transition=state_transition, initial_states=None, pix_fmt=None,
    )


def write_slice_header(c: RangeEncoder, p: FFV1Params, ss, rect,
                       sar=(0, 1), interlaced=0, top_field_first=0):
    """encode_slice_header (version >= 3)."""
    x, y, w, h = rect
    state = new_states(1)[0]
    put_symbol(c, state, (x + 1) * p.num_h_slices // p.width, False)
    put_symbol(c, state, (y + 1) * p.num_v_slices // p.height, False)
    put_symbol(c, state, (w + 1) * p.num_h_slices // p.width - 1, False)
    put_symbol(c, state, (h + 1) * p.num_v_slices // p.height - 1, False)
    for j in range(p.plane_count):
        put_symbol(c, state, ss.plane_qt_index[j], False)
    if not interlaced:
        put_symbol(c, state, 3, False)
    else:
        put_symbol(c, state, 1 + (0 if top_field_first else 1), False)
    put_symbol(c, state, sar[0], False)
    put_symbol(c, state, sar[1], False)
    if p.version > 3:
        c.put(state, 0, 1 if ss.slice_coding_mode == 1 else 0)
        if ss.slice_coding_mode == 1:
            ss.clear()
        put_symbol(c, state, ss.slice_coding_mode, False)
        if ss.slice_coding_mode != 1:
            put_symbol(c, state, ss.slice_rct_by, False)
            put_symbol(c, state, ss.slice_rct_ry, False)


def read_slice_header(c: RangeDecoder, p: FFV1Params, ss) -> tuple:
    """decode_slice_header (version >= 3); returns the slice rect."""
    state = new_states(1)[0]
    sx = get_symbol(c, state, False) * p.width
    sy = get_symbol(c, state, False) * p.height
    sw = (get_symbol(c, state, False) + 1) * p.width + sx
    sh = (get_symbol(c, state, False) + 1) * p.height + sy
    sx //= p.num_h_slices
    sy //= p.num_v_slices
    sw = sw // p.num_h_slices - sx
    sh = sh // p.num_v_slices - sy
    if sw > p.width or sh > p.height or sx + sw > p.width or sy + sh > p.height:
        raise ValueError("slice rect out of bounds")

    for i in range(p.plane_count):
        idx = get_symbol(c, state, False)
        if idx >= len(p.context_counts):
            raise ValueError("quant table index out of range")
        ss.plane_qt_index[i] = idx
        ss.plane_ctx_count[i] = p.context_counts[idx]

    get_symbol(c, state, False)          # picture structure
    get_symbol(c, state, False)          # sar num
    get_symbol(c, state, False)          # sar den

    ss.slice_reset_contexts = 0
    ss.slice_coding_mode = 0
    ss.slice_rct_by = 1
    ss.slice_rct_ry = 1
    if p.version > 3:
        ss.slice_reset_contexts = c.get(state, 0)
        ss.slice_coding_mode = get_symbol(c, state, False)
        if ss.slice_coding_mode != 1:
            ss.slice_rct_by = get_symbol(c, state, False)
            ss.slice_rct_ry = get_symbol(c, state, False)
            if ss.slice_rct_by + ss.slice_rct_ry > 4:
                raise ValueError("slice rct coefficients out of range")
    return (sx, sy, sw, sh)


def write_v2_slice_table(c: RangeEncoder, p: FFV1Params, slice_states):
    """write_header version==2 branch: per-slice geometry table."""
    state = new_states(1)[0]
    put_symbol(c, state, p.slice_count, False)
    for i, rect in enumerate(p.rects()):
        x, y, w, h = rect
        put_symbol(c, state, (x + 1) * p.num_h_slices // p.width, False)
        put_symbol(c, state, (y + 1) * p.num_v_slices // p.height, False)
        put_symbol(c, state, (w + 1) * p.num_h_slices // p.width - 1, False)
        put_symbol(c, state, (h + 1) * p.num_v_slices // p.height - 1, False)
        for j in range(p.plane_count):
            put_symbol(c, state, slice_states[i].plane_qt_index[j], False)
