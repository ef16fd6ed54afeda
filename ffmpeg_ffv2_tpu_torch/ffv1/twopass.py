"""Copy of ``ffmpeg_ffv2_tpu/ffv1/twopass.py``: two-pass rate statistics.

Pass 1 collects per-state and per-context bit tallies while encoding
(ffv1enc.c put_symbol's rc_stat hooks); the stats serialize to the same
text format the reference writes to ``stats_out`` (ffv1enc.c:1134-1176).
Pass 2 re-reads them and derives (a) a sorted custom state-transition
table (sort_stt) and (b) optimized per-context initial states
(find_best_state + the accumulation walk of ffv1enc.c:846-872), which are
written into the extradata and loaded by any FFV1 decoder.

Host only: the searches run in the port's native runtime
(ffv1rt_sort_stt / ffv1rt_find_best_state); the pass-2 parameters then
drive ``DeviceFFV1Encoder(params=...)`` on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .params import FFV1Params, CONTEXT_SIZE, CODER_RANGE_CUSTOM
from .native import get_lib


def collect_stats(native_codec) -> tuple[np.ndarray, np.ndarray, int]:
    """Fetch accumulated pass-1 tallies from a native session with
    stats mode on.  Returns (rc_stat[256,2], rc_stat2[nctx,32,2], gob)."""
    lib = get_lib()
    p = native_codec.p
    nctx = p.context_counts[p.context_model]
    rc_stat = np.zeros((256, 2), dtype=np.uint64)
    rc_stat2 = np.zeros((nctx, CONTEXT_SIZE, 2), dtype=np.uint64)
    gob = lib.ffv1rt_get_stats(
        native_codec.handle,
        rc_stat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        rc_stat2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        rc_stat2.size)
    return rc_stat, rc_stat2, int(gob)


def stats_to_text(p: FFV1Params, rc_stat: np.ndarray, rc_stat2: np.ndarray,
                  gob_count: int) -> str:
    """Serialize in the reference's stats_out layout: one line of 256
    (zero,one) pairs, then per quant table per context 32 pairs, then the
    GOP count."""
    parts = []
    parts.append(" ".join(f"{int(rc_stat[j][0])} {int(rc_stat[j][1])}"
                          for j in range(256)) + " \n")
    for qt, cc in enumerate(p.context_counts):
        for j in range(cc):
            if qt == p.context_model:
                row = rc_stat2[j]
                parts.append(" ".join(
                    f"{int(row[k][0])} {int(row[k][1])}"
                    for k in range(CONTEXT_SIZE)) + " ")
            else:
                parts.append("0 " * (2 * CONTEXT_SIZE))
    parts.append(f"{gob_count}\n")
    return "".join(parts)


def parse_stats(text: str, p: FFV1Params):
    """Inverse of stats_to_text (also reads reference-generated files)."""
    it = iter(text.split())
    rc_stat = np.zeros((256, 2), dtype=np.uint64)
    for j in range(256):
        rc_stat[j][0] = int(next(it))
        rc_stat[j][1] = int(next(it))
    rc_stat2 = []
    for cc in p.context_counts:
        arr = np.zeros((cc, CONTEXT_SIZE, 2), dtype=np.uint64)
        for j in range(cc):
            for k in range(CONTEXT_SIZE):
                arr[j][k][0] = int(next(it))
                arr[j][k][1] = int(next(it))
        rc_stat2.append(arr)
    gob_count = int(next(it))
    return rc_stat, rc_stat2, gob_count


def sort_stt(rc_stat: np.ndarray, stt: np.ndarray) -> bool:
    """In-place state-transition-table optimization (native)."""
    lib = get_lib()
    rc = np.ascontiguousarray(rc_stat, dtype=np.uint64)
    st = np.ascontiguousarray(stt, dtype=np.uint8)
    changed = lib.ffv1rt_sort_stt(
        rc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    rc_stat[:] = rc
    stt[:] = st
    return bool(changed)


_best_state_cache: dict[bytes, np.ndarray] = {}


def find_best_state(one_state: np.ndarray) -> np.ndarray:
    """best_state[probability][count] for a transition table (native,
    cached by table)."""
    key = bytes(np.asarray(one_state, dtype=np.uint8))
    if key in _best_state_cache:
        return _best_state_cache[key]
    lib = get_lib()
    best = np.zeros((256, 256), dtype=np.uint8)
    st = np.ascontiguousarray(one_state, dtype=np.uint8)
    lib.ffv1rt_find_best_state(
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        best.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    _best_state_cache[key] = best
    return best


def derive_initial_states(p: FFV1Params, rc_stat2_by_qt, gob_count: int,
                          best_state: np.ndarray):
    """ffv1enc.c:846-872: walk each state slot's per-context tallies,
    merging sparse contexts, and pick initial states from best_state."""
    out = []
    for qt, cc in enumerate(p.context_counts):
        stat2 = rc_stat2_by_qt[qt]
        init = np.full((cc, CONTEXT_SIZE), 128, dtype=np.uint8)
        for k in range(CONTEXT_SIZE):
            a = 0.0
            b = 0.0
            jp = 0
            for j in range(cc):
                pr = 128.0
                s0 = float(stat2[j][k][0])
                s1 = float(stat2[j][k][1])
                if (s0 + s1 > 200 and j) or a + b > 200:
                    if a + b:
                        pr = 256.0 * b / (a + b)
                    v = best_state[int(np.clip(round(pr), 1, 255))][
                        int(np.clip(int((a + b) / gob_count), 0, 255))]
                    init[jp][k] = v
                    jp += 1
                    while jp < j:
                        init[jp][k] = init[jp - 1][k]
                        jp += 1
                    a = b = 0.0
                a += s0
                b += s1
                if a + b:
                    pr = 256.0 * b / (a + b)
                init[j][k] = best_state[int(np.clip(round(pr), 1, 255))][
                    int(np.clip(int((a + b) / gob_count), 0, 255))]
        out.append(init)
    return out


def apply_pass2(p: FFV1Params, stats_text: str) -> FFV1Params:
    """Derive pass-2 parameters (sorted transition table + initial states)
    from a pass-1 stats dump; mirrors the stats_in block of encode_init.
    Updates ``p`` in place and returns it."""
    rc_stat, rc_stat2_by_qt, gob = parse_stats(stats_text, p)
    stt = p.state_transition.copy()
    if p.ac == CODER_RANGE_CUSTOM:
        sort_stt(rc_stat, stt)
    best = find_best_state(stt)
    init = derive_initial_states(p, rc_stat2_by_qt, max(gob, 1), best)
    p.state_transition = stt
    p.initial_states = init
    return p
