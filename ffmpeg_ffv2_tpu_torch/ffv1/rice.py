"""Golomb-Rice (run mode) planning and bit assembly of the device encoder.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/device_rice.py`` for YUV and gray
streams (planes concatenated per slice) and RGB streams (planes
interleaved per line, one run-index ladder per slice): ``plan_runs_plane``,
``build_rice_streams``, ``VLC_INIT``, ``vlc_code_word``, ``vlc_update``,
``build_vlc_s0``, ``writeback_vlc``, ``ladder_step``, ``run_index_scan``,
``ladder_fields``, ``rice_elements`` and ``assemble_bits``.  Plain torch,
except ``run_index_scan``, which launches the CUDA kernels of
``csrc/ladder.cu`` on CUDA tensors and runs the sequential loop
``run_index_scan_plain`` on CPU tensors.  ``run_index_scan_chunked_plain``
is the kernels' algorithm (chunk maps, carries, replay) in plain torch,
for the tests.

Semantics (ffv1enc_template.c:46-76 run mode, put_vlc_symbol, the
bitstream.c log2 run ladder): a pixel in run mode with a zero residual is
*silent* (no bits, no state update); a run ends at a nonzero residual (an
*event*: ladder climb bits, a terminator, then the residual's VLC code) or
at the line end (a *flush*).  Only the run index (0..40, reset per plane)
is carried from event to event; everything else is data parallel.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..coder.golomb import LOG2_RUN
from ..utils.metrics import no_mark

I32 = torch.int32
PAYLOAD_BITS = 12            # rice cell payload: diff + 2048 in bits 0..11
LOG2_RUN_T = np.asarray(LOG2_RUN, np.int32)                  # (41,)
# LADDER_P[i] = run length consumed by climbing 0..i-1 (42 entries)
LADDER_P = np.concatenate(
    [[0], np.cumsum(1 << LOG2_RUN_T.astype(np.int64))]).astype(np.int32)
VLC_INIT = np.array([0, 4, 0, 1], np.int32)  # drift, error_sum, bias, count
# the ladder kernels' climb: for t < LADDER_SMALL (= P[24]) one entry
# k | P[k] << 6 | P[max(k - 1, 0)] << 16, k the largest j with P[j] <= t
LADDER_SMALL = int(LADDER_P[24])
_K_SMALL = (np.searchsorted(LADDER_P, np.arange(LADDER_SMALL), side="right")
            - 1).astype(np.int32)
LADDER_TABLE = (_K_SMALL | LADDER_P[_K_SMALL] << 6
                | LADDER_P[np.maximum(_K_SMALL - 1, 0)] << 16).astype(np.int32)
LADDER_CHUNK = 128      # run_index_scan_chunked_plain's default chunk

_K_LADDER = _build.KERNELS["ladder"]


def rice_pb(bits: int) -> int:
    """The rice cell's payload width for a coding depth: the 12-bit diff
    field (``PAYLOAD_BITS``) up to 12 bits, 16 bits for 13..16.  Past 16
    (rgb48 codes at 17) the folded difference does not fit the field, so
    the depth is refused."""
    if bits > 16:
        raise NotImplementedError(
            f"Golomb-Rice at coding depth {bits}: the 16-bit cell payload "
            "covers coding depths up to 16")
    return PAYLOAD_BITS if bits <= 12 else 16


def plan_runs_plane(ctx, diff):
    """Run-mode planning for one plane, all slices at once.

    ctx/diff: int32 (S, h, w) plane-local |context| and folded diff.
    Returns a dict of (S, h, w) tensors: silent, event, run_count (at
    events), flush (at x = w-1), flush_count and diff_adj (the run-end
    ``diff > 0 -> diff - 1`` adjustment applied).  A pixel is in run mode
    when a context-0 position follows the line's last nonzero residual
    (two cummax scans); the run length is counted from the first context-0
    position of the current zero segment (a cummin over one monotone key).
    """
    S, h, w = diff.shape
    pos = torch.arange(w, dtype=I32, device=diff.device)
    z = diff == 0
    c0 = ctx == 0
    lnz = torch.cummax(torch.where(~z, pos, -1), dim=2).values
    lc0 = torch.cummax(torch.where(c0, pos, -1), dim=2).values
    mode_after = lc0 > lnz
    prev_after = torch.cat([mode_after.new_zeros((S, h, 1)),
                            mode_after[:, :, :-1]], dim=2)
    mode_in = prev_after | c0
    silent = mode_in & z
    event = mode_in & ~z

    # segments advance at nonzero positions; seg strictly increases, so
    # a plain cummin over (-seg) * BASE + position acts segmented
    base = w + 1
    nz = (~z).to(I32)
    seg = torch.cumsum(nz, dim=2, dtype=I32) - nz
    key = -seg * base + torch.where(c0, pos, base - 1)
    fc0 = torch.cummin(key, dim=2).values + seg * base
    entry = torch.minimum(fc0, pos)
    run_count = pos - entry

    flush = torch.zeros_like(z)
    flush[:, :, w - 1] = mode_after[:, :, w - 1]
    flush_count = torch.where(flush, w - entry, 0)
    diff_adj = torch.where(event & (diff > 0), diff - 1, diff)
    return dict(silent=silent, event=event, run_count=run_count,
                flush=flush, flush_count=flush_count, diff_adj=diff_adj)


def build_rice_streams(ctx_planes, diff_planes, interleave: bool = False,
                       pb: int = PAYLOAD_BITS):
    """Per-plane (S, h, w) |context| / folded-diff grids -> stream-order
    (S, npix) tensors: payload ((diff_adj + 2^(pb - 1)) | silent << pb, the
    vlc walk's cell word before the layout adds the valid flag at bit
    pb + 1; pb is ``rice_pb`` of the coding depth), lad
    (the pixel carries a ladder event: run end or line flush), cnt (its
    ladder count), flush, plane.

    YUV concatenates the planes per slice and resets the run index per
    plane.  ``interleave`` (RGB) alternates the planes line by line and
    runs one run-index ladder over the whole stream, reset once per slice
    (ffv1enc_template.c:138), so every position carries plane 0.  Runs are
    planned per plane either way: a line end flushes the run."""
    pays, lads, cnts, flushes, planes = [], [], [], [], []
    for li, (ctx, diff) in enumerate(zip(ctx_planes, diff_planes)):
        pr = plan_runs_plane(ctx, diff)
        pays.append(((pr["diff_adj"] + (1 << (pb - 1))) & ((1 << pb) - 1))
                    | (pr["silent"].to(I32) << pb))
        lads.append(pr["event"] | pr["flush"])
        cnts.append(torch.where(pr["flush"], pr["flush_count"],
                                pr["run_count"]))
        flushes.append(pr["flush"])
        planes.append(torch.full(diff.shape, 0 if interleave else li,
                                 dtype=I32, device=diff.device))

    def cat(xs):
        if interleave:
            return torch.stack(xs, dim=2).reshape(xs[0].shape[0], -1)
        return torch.cat([x.reshape(x.shape[0], -1) for x in xs], dim=1)

    return dict(payload=cat(pays), lad=cat(lads), cnt=cat(cnts),
                flush=cat(flushes), plane=cat(planes))


# ---------------------------------------------------------------------------
# VlcState: one put_vlc_symbol and its state update, elementwise
# ---------------------------------------------------------------------------

def vlc_code_word(v0, drift, es, bias, count, bits: int):
    """One put_vlc_symbol: returns (len, val, v), v the bias-folded value
    the state update consumes.  k is the smallest k <= 16 with
    count << k >= error_sum (golomb.py:95-99); an escape (e >= 12) codes
    12 + bits bits."""
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    d = (v0 - bias) & mask
    v = d - ((d & half) << 1)                       # fold to signed bits
    ks = torch.arange(16, dtype=I32, device=v0.device)
    k = ((count[..., None] << ks) < es[..., None]).sum(-1, dtype=I32)
    sgn = (2 * drift + count) >> 31                 # arithmetic shift
    code = v ^ sgn
    vv = (code << 1) ^ (code >> 31)                 # zigzag
    e = vv >> k
    esc = e >= 12
    length = torch.where(esc, 12 + bits, e + k + 1)
    val = torch.where(esc, vv - 11, (1 << k) | (vv & ((1 << k) - 1)))
    return length, val, v


def vlc_update(drift, es, bias, count, v):
    """update_vlc_state (ffv1.h), elementwise."""
    es = (es + v.abs()) & 0xFFFF
    drift = drift + v
    at128 = count == 128
    count = torch.where(at128, count >> 1, count)
    drift = torch.where(at128, drift >> 1, drift)   # arithmetic
    es = torch.where(at128, es >> 1, es)
    count = count + 1
    neg = drift <= -count
    pos = drift > 0
    bias = torch.where(neg, torch.clamp(bias - 1, min=-128),
                       torch.where(pos, torch.clamp(bias + 1, max=127), bias))
    drift = torch.where(neg, torch.maximum(drift + count, -count + 1),
                        torch.where(pos, torch.clamp(drift - count, max=0),
                                    drift))
    return drift, es, bias, count


def build_vlc_s0(plan, vcanon, tiles_cap: int):
    """(TILES_CAP, 5, 128) int32 start-state blocks from the canonical vlc
    table ((chain rows + 1, 4) int32): rows drift, error_sum, bias, count,
    then the per-lane continuation flag."""
    rows = plan["lane_rows"].reshape(tiles_cap, 128).long()
    cont = plan["lane_cont"].reshape(tiles_cap, 128)
    s0 = vcanon[rows].permute(0, 2, 1)                       # (T, 4, 128)
    return torch.cat([s0, cont[:, None, :]], dim=1).contiguous()


def writeback_vlc(plan, vcanon, end_states, tiles_cap: int):
    """Store group-end states back into the canonical table for the next
    (inter) frame; only lanes holding their group's last sub-block
    write."""
    rows = plan["lane_rows"].reshape(-1).long()
    last = plan["lane_last"].reshape(-1) > 0
    ends = end_states.permute(0, 2, 1).reshape(tiles_cap * 128, 4)
    n = vcanon.shape[0]
    ext = torch.cat([vcanon, vcanon.new_zeros((1, 4))])
    # lanes that do not write land on the spare row past the table
    ext[torch.where(last, rows, n)] = ends.to(vcanon.dtype)
    return ext[:n]


# ---------------------------------------------------------------------------
# run-index ladder
# ---------------------------------------------------------------------------

def ladder_step(i, count):
    """Closed-form climb from index i over a run of ``count``: returns
    (j, ones, rem), the post-climb index (<= 40), the number of climb
    1-bits and the remaining count."""
    P = torch.as_tensor(LADDER_P, device=count.device)
    t = count + P[i.long()]
    j = torch.clamp(torch.searchsorted(P, t, right=True, out_int32=True) - 1,
                    max=40)
    return j, j - i, t - P[j.long()]


def run_index_scan_plain(ev_count, ev_flush, ev_valid, ev_reset, n_ev):
    """Plain version of ``run_index_scan``: a loop over the events, all
    lanes at once, as far as the longest lane's n_ev."""
    L, E = ev_count.shape
    dev = ev_count.device
    live = torch.arange(E, device=dev)[None, :] < n_ev[:, None]
    i = torch.zeros(L, dtype=I32, device=dev)
    out = torch.zeros((L, E), dtype=I32, device=dev)
    for e in range(int(live.sum(1).max()) if L else 0):
        va = ev_valid[:, e] & live[:, e]
        i_in = torch.where(ev_reset[:, e], 0, i)
        j, _, _ = ladder_step(i_in, ev_count[:, e])
        out[:, e] = torch.where(va, i_in, i)
        nxt = torch.where(ev_flush[:, e], j, torch.clamp(j - 1, min=0))
        i = torch.where(va, nxt, i)
    return out


def ladder_climb(c, fl, i, pi):
    """The ladder kernels' step (``csrc/ladder.cu`` ``climb``), elementwise:
    the state (i, pi = P[i]) after an event of count ``c`` (clamped to
    [0, 2^26]) and flags ``fl`` (bit 0 flush, 1 valid, 2 reset).  The
    climb is one table entry below P[24] = 540 and the closed form k = 16
    + floor(log2(t - 284)) past it (P[j] = 284 + 2^(j - 16) for j >= 24),
    capped at 40."""
    tab = torch.as_tensor(LADDER_TABLE, device=c.device)
    t = c + torch.where((fl & 4) != 0, 0, pi)
    e = tab[torch.clamp(t, max=LADDER_SMALL - 1).long()]
    log2 = torch.frexp(torch.clamp(t - 284, min=1).double())[1] - 1
    kb = torch.clamp(16 + log2, max=40).to(I32)
    big = t >= LADDER_SMALL
    k = torch.where(big, kb, e & 63)
    pk = torch.where(big, 284 + (1 << (kb - 16).clamp(min=0)),
                     (e >> 6) & 1023)
    pk1 = torch.where(big, torch.where(kb > 24,
                                       284 + (1 << (kb - 17).clamp(min=0)),
                                       412), e >> 16)
    keep = (fl & 1) != 0
    valid = (fl & 2) != 0
    ni = torch.where(keep, k, torch.clamp(k - 1, min=0))
    npi = torch.where(keep, pk, pk1)
    return torch.where(valid, ni, i), torch.where(valid, npi, pi)


def run_index_scan_chunked_plain(ev_count, ev_flush, ev_valid, ev_reset,
                                 n_ev, chunk: int = LADDER_CHUNK):
    """``csrc/ladder.cu``'s algorithm in plain torch, for the tests: each
    lane's first n_ev events cut into chunks of ``chunk``; (1) each chunk
    but the last as a map of the 41 start states (a walk of each), (2)
    the maps applied in order to index 0, each chunk's carry-in, (3) each
    chunk replayed from its carry-in.  Every step is ``ladder_climb``.
    Same arguments and result as ``run_index_scan`` (slots at or past
    n_ev unspecified: 0 here)."""
    L, E = ev_count.shape
    dev = ev_count.device
    nch = max(-(-E // chunk), 1)
    pad = nch * chunk - E
    live = (torch.arange(E, device=dev)[None, :]
            < n_ev.clamp(0, E)[:, None])
    c = torch.where(live, ev_count.clamp(0, 1 << 26), 0).to(I32)
    fl = ((ev_flush.to(I32) | ev_valid.to(I32) << 1 | ev_reset.to(I32) << 2)
          * live)
    c = torch.nn.functional.pad(c, (0, pad)).reshape(L, nch, chunk)
    fl = torch.nn.functional.pad(fl, (0, pad)).reshape(L, nch, chunk)
    P = torch.as_tensor(LADDER_P, device=dev)
    # 1. chunk maps: (L, nch, 41) end state of each start state
    s = torch.arange(41, dtype=I32, device=dev).expand(L, nch, 41)
    i, pi = s.clone(), P[s.long()]
    for p in range(chunk):
        i, pi = ladder_climb(c[:, :, p, None], fl[:, :, p, None], i, pi)
    maps = i
    # 2. carries: each chunk's index on entry
    carry = torch.zeros((L, nch), dtype=I32, device=dev)
    for k in range(1, nch):
        carry[:, k] = maps[:, k - 1].gather(
            1, carry[:, k - 1, None].long())[:, 0]
    # 3. replay from the carries
    i, pi = carry, P[carry.long()]
    out = torch.zeros((L, nch, chunk), dtype=I32, device=dev)
    for p in range(chunk):
        f = fl[:, :, p]
        out[:, :, p] = torch.where((f & 6) == 6, 0, i)
        i, pi = ladder_climb(c[:, :, p], f, i, pi)
    out = out.reshape(L, nch * chunk)[:, :E]
    return torch.where(live, out, 0)


def run_index_scan(ev_count, ev_flush, ev_valid, ev_reset, n_ev):
    """The run index each event climbs from (after its plane's reset).

    ev_*: (L, E) per-lane compacted events (count int32; flush, valid,
    reset bool); invalid entries carry the index through unchanged.
    After an event the index is the post-climb one on a line flush and
    one below it otherwise (ffv1enc_template.c:60-64).  n_ev: (L,) int32,
    each lane's number of events (at most E counted); the walk stops
    there and the entries at or past it are unspecified.  Launches
    ``csrc/ladder.cu`` on CUDA tensors (one launcher call, one count on
    the kernel: three device launches, the chunk maps, the carries and
    the replay); returns (L, E) int32."""
    dev = ev_count.device
    L, E = ev_count.shape
    _K_LADDER.check("ev_count", ev_count, (L, E), dev)
    for name, t in (("ev_flush", ev_flush), ("ev_valid", ev_valid),
                    ("ev_reset", ev_reset)):
        _K_LADDER.check(name, t, (L, E), dev, torch.bool)
    _K_LADDER.check("n_ev", n_ev, (L,), dev)
    if _K_LADDER.plain_for(dev):
        return run_index_scan_plain(ev_count, ev_flush, ev_valid, ev_reset,
                                    n_ev)
    out = torch.empty((L, E), dtype=I32, device=dev)
    nbytes = _build.load().ffv2_ladder_scratch_bytes(L, E)
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    _K_LADDER.launch(ev_count.data_ptr(), ev_flush.data_ptr(),
                     ev_valid.data_ptr(), ev_reset.data_ptr(),
                     n_ev.data_ptr(), L, E, out.data_ptr(),
                     scratch.data_ptr(), nbytes,
                     _build.stream_handle(ev_count))
    return out


def compact_events(streams, ev_cap: int):
    """The ladder events of each slice, in stream order, packed into the
    first columns of (S, ev_cap) tensors by a cumsum rank (the positions
    are unique and ascending, so this is the order of ladder_fields'
    sort); events past ev_cap are dropped and n_lad tells the caller.
    Returns a dict: count, flush, valid, reset (the plane's first event),
    pos (stream position) and n_lad (S,)."""
    lad = streams["lad"]
    S, npix = lad.shape
    dev = lad.device
    rank = torch.cumsum(lad.to(I32), dim=1, dtype=I32) - 1
    slot = torch.where(lad & (rank < ev_cap), rank, ev_cap)
    flat = (torch.arange(S, dtype=I32, device=dev)[:, None] * (ev_cap + 1)
            + slot).reshape(-1).long()
    meta = ((streams["plane"] << 24) | (streams["flush"].to(I32) << 23)
            | torch.arange(npix, dtype=I32, device=dev))

    def put(v):
        # every non-event lands on its row's spare column past ev_cap
        out = torch.zeros(S * (ev_cap + 1), dtype=I32, device=dev)
        return out.scatter_(0, flat, v.reshape(-1)).reshape(
            S, ev_cap + 1)[:, :ev_cap].contiguous()

    count, meta = put(streams["cnt"]), put(meta)
    n_lad = lad.sum(dim=1, dtype=I32)
    valid = (torch.arange(ev_cap, dtype=I32, device=dev)[None, :]
             < n_lad[:, None])
    plane = meta >> 24
    prev = torch.cat([plane.new_full((S, 1), -1), plane[:, :-1]], dim=1)
    return dict(count=count, flush=((meta >> 23) & 1) == 1, valid=valid,
                reset=valid & (plane != prev), pos=meta & 0x7FFFFF,
                n_lad=n_lad)


def deliver_ladder(ev, i_before, npix: int):
    """Climb each event from its run index and scatter (ones, term_j, rem)
    back to the (S, npix) stream positions (0 away from events).
    i_before is read at the valid events only."""
    S = i_before.shape[0]
    dev = i_before.device
    j, ones, rem = ladder_step(torch.where(ev["valid"], i_before, 0),
                               ev["count"])
    n = S * npix
    flat = torch.where(
        ev["valid"], torch.arange(S, dtype=I32, device=dev)[:, None] * npix
        + ev["pos"], n).reshape(-1).long()

    def put(v):
        out = torch.zeros(n + 1, dtype=I32, device=dev)
        return out.scatter_(0, flat, v.reshape(-1))[:n].reshape(S, npix)

    return put(ones), put(j), put(rem)


def ladder_fields(streams, ev_cap: int, mark=no_mark):
    """Run the run-index chain over each slice's events and deliver the
    ladder fields back to stream order.

    Returns (ones, term_j, rem), each (S, npix) int32 (the climb 1-bits,
    the post-climb index that sizes the terminator, the remaining count),
    and n_lad (S,) the true event counts for the ev_cap check.  The events
    of all planes share a slice's lane; each plane's first event resets
    the index (encode_plane's run_index = 0).  The ladder kernel walks
    each lane's events only, not its ev_cap slots."""
    ev = compact_events(streams, ev_cap)
    mark("compact events")
    args = (ev["count"], ev["flush"], ev["valid"], ev["reset"], ev["n_lad"])
    i_before = run_index_scan(*args)
    mark("ladder kernel", args)
    out = deliver_ladder(ev, i_before, streams["lad"].shape[1])
    mark("ladder delivery")
    return (*out, ev["n_lad"])


# ---------------------------------------------------------------------------
# bit elements and their assembly into bytes
# ---------------------------------------------------------------------------

def rice_elements(streams, vlc_codes, ones, term_j, rem):
    """Per-pixel bit elements in stream order -> (lens, vals), each
    (S, 3 * npix) int32 (vals: the low 32 bits).

    Three slots per pixel, in encode_line's emission order
    (codec_py.py:132-170): the run climbs (or a line flush's bits), the
    run terminator, the VLC code (vlc_codes: (S, npix) len << 18 | val
    from the vlc walk, 0 for silent pixels)."""
    lad, flush = streams["lad"], streams["flush"]
    event = lad & ~flush
    S, npix = lad.shape
    l2r = torch.as_tensor(LOG2_RUN_T, device=lad.device)
    # slot 0: `ones` climb 1-bits, plus on a flush a single 1 when a
    # partial count remains
    l0 = torch.where(event, ones,
                     torch.where(flush, ones + (rem > 0).to(I32), 0))
    v0 = ((1 << torch.clamp(l0, min=0).long()) - 1).to(I32)
    # slot 1: run terminator [0][rem in LOG2_RUN[j] bits]
    l1 = torch.where(event, 1 + l2r[torch.clamp(term_j, 0, 40).long()], 0)
    v1 = torch.where(event, rem, 0)
    # slot 2: the VLC code
    l2 = vlc_codes >> 18
    v2 = vlc_codes & ((1 << 18) - 1)
    lens = torch.stack([l0, l1, l2], dim=2).reshape(S, 3 * npix)
    vals = torch.stack([v0, v1, v2], dim=2).reshape(S, 3 * npix)
    return lens, vals


def assemble_bits(lens, vals, nwords: int):
    """Pack MSB-first bit elements into big-endian bytes per slice.

    lens/vals: (S, E) int32 element lengths (0 = absent, <= 31) and values
    (low ``len`` bits used).  Returns (bytes (S, nwords * 4) uint8, nbits
    (S,) int32).  Bit offsets are a prefix sum; each element adds its bits
    into at most two 32-bit words (int64 here, masked to 32 bits; the bit
    ranges are disjoint, so add == or).  Words past a slice's nwords spill
    into the next slice's and past the last slice are dropped: the caller
    checks nbits against nwords * 32."""
    S, E = lens.shape
    dev = lens.device
    ln = lens.long()
    off = torch.cumsum(ln, dim=1) - ln
    nbits = lens.sum(dim=1, dtype=I32)
    w0 = off >> 5
    sh = 32 - (off & 31) - ln
    m32 = 0xFFFFFFFF
    vmask = torch.where(ln > 0, (1 << torch.clamp(ln, 0, 32)) - 1, 0)
    v = vals.long() & m32 & vmask
    hi = torch.where(sh >= 0, (v << torch.clamp(sh, min=0)) & m32,
                     v >> torch.clamp(-sh, max=31))
    lo = torch.where(sh < 0, (v << ((32 + sh) & 31)) & m32, 0)
    n = S * nwords
    rows = torch.arange(S, device=dev)[:, None] * nwords

    def at(idx):
        return torch.where((idx >= 0) & (idx < n), idx, n).reshape(-1)

    words = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    words.index_add_(0, at(rows + w0), hi.reshape(-1))
    words.index_add_(0, at(rows + w0 + 1), lo.reshape(-1))
    words = words[:n].reshape(S, nwords)
    sh8 = torch.tensor([24, 16, 8, 0], device=dev)
    by = (words[:, :, None] >> sh8) & 0xFF
    return by.reshape(S, nwords * 4).to(torch.uint8), nbits
