"""Copy of ``ffmpeg_ffv2_tpu/ffv1/headers.py``: the write side.

FFV1 header coding as the encoder writes it: global extradata, the
version<2 in-band keyframe header and the version-3+ slice header.

Reference layout: ffv1enc.c:write_extradata/write_header/encode_slice_header.
"""

from __future__ import annotations

import numpy as np

from ..coder.rac import RangeEncoder, DEFAULT_ONE_STATE
from ..coder.symbols import put_symbol, new_states, CONTEXT_SIZE
from .native import crc32_trailer
from .params import FFV1Params, CODER_RANGE_CUSTOM


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
