"""FFV1 encoder with phase A and the entropy coder on an NVIDIA GPU.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/device_coder.py``: the range coder
on YUV, gray and RGB formats at coding depths up to 17 (rgb48), with the
fixed RCT of versions <= 3 and the per-slice RCT search of version 4, and
the Golomb-Rice coder (YUV, gray and RGB; a 12-bit cell payload up to
coding depth 12, a 16-bit one for 13..16), on uniform
and non-uniform slice geometries (shape banks).  The plain torch stages
``layout_plan``, ``build_s0_blocks``, ``writeback_canonical`` and the
unsorts (``_s_unsort_impl``, ``_s_rice_unsort_impl``); the JAX session's
work on one slice shape as the class ``Bank`` (its ``__init__`` on a set
of slices, ``ops_from_streams``, ``_s_front``, ``_adapt``, ``_pick_rct``,
``_prefix_for_rct``, ``_code_render``, ``_render_retry``,
``_encode_rice``); and the session over its banks as
``DeviceFFV1Encoder`` (``encode``, ``encode_batch``, ``_finish_packet``).

A range-coded frame runs phase A (plain torch), the chain-grouping layout
(plain torch), then five CUDA kernels: K1 ``ops/place.py`` places the
cells, K2 ``adapt.py`` walks the context states and the emission_pack
kernel (``adapt.pack_emission``) packs them into emission order (or K6,
the same walk and packing in one launcher call, under
``emission_order=True``), K3 ``expand.py`` lays out each slice's rac ops
and K4 ``rac.py`` codes and renders each slice's bytes.  A Golomb-Rice
frame plans its runs in phase A (``rice.py``), takes the same layout and
K1, then K5 ``vlc.py`` walks the VlcStates, the ladder kernel
(``rice.run_index_scan``) carries each slice's run index, and plain torch
assembles the bits.  The host reads the sizes once per frame to check the
adaptive caps (``caps.py``: it retries larger on a miss), picks the v4 RCT
coefficients from the device's cost sums, and adds the slice headers
(rice) and trailers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..coder.rac import RangeEncoder
from ..ops.place import place
from ..utils import metrics
from . import headers as H
from . import host
from .adapt import (adapt, adapt_emission, pack_emission,
                    repack_emission_order)  # noqa: F401 (the tests' name)
from .caps import Caps, fit
from .expand import expand
from .native import crc32_trailer
from .params import FFV1Config, FFV1Params, params_from_config, CODER_GOLOMB
from .phase_a import (lut_for, pick_rct, rct_costs, rct_planes, rgb_plan,
                      yuv_plan)
from .phase_a import run as run_phase_a
from .rac import rac_render
from .rice import (VLC_INIT, assemble_bits, build_rice_streams, rice_pb,
                   build_vlc_s0, ladder_fields, no_mark, rice_elements,
                   writeback_vlc)
from .slice_state import SliceState
from .symbols import event_count
from .vlc import vlc_adapt

INT32_MAX = 2 ** 31 - 1
I32 = torch.int32


def _set_drop(dst, idx, val):
    """jax's ``dst.at[idx].set(val, mode="drop")`` for a 1-D ``dst`` and
    unique in-range indices: indices outside ``dst`` are dropped."""
    n = dst.shape[0]
    ok = (idx >= 0) & (idx < n)
    ext = torch.cat([dst, dst.new_zeros(1)])
    # every dropped element lands on the spare slot past the end
    ext.scatter_(0, torch.where(ok, idx, n).long().reshape(-1),
                 val.reshape(-1).to(dst.dtype))
    return ext[:n]


def layout_plan(row_local, diff, rows_per_slice: int, slots_cap: int,
                tiles_cap: int, payload_bits: int = 0, wide: int = 0):
    """Group-sort + lane/tile layout (device_coder.py:426 layout_plan, the
    range coder's diff field or a rice payload).  Every key of JAX's
    plan equals JAX's; the port adds K1's slot geometry
    (``ops.place.TABLE_KEYS``).

    row_local/diff: int32 (n_slices, npix) per-slice coding-order streams;
    row_local is the slice-local chain row (plane-class offset + context).
    payload_bits > 0: ``diff`` already carries an encoded payload (the
    rice walk's diff + 2048 | silent << 12) and only the valid flag at
    bit ``payload_bits`` is added.  Otherwise the cell payload is diff +
    2048 with the valid flag at bit 13, or with ``wide`` (16 for coding
    depths 11..16, 17 for depth 17: ``host.payload_field``'s valid bit)
    diff + 2^(wide - 1) with the flag at bit ``wide``.
    Pixels merge with one sentinel record per chain row and sort by
    (row, stream index); the sentinel carries its group's lane word,
    which a forward fill spreads over the group.  Lanes: buckets of GCAP
    sub-lanes of split groups first (bucket k = every group's k-th
    sub-block), then whole groups by (length desc, group asc), 128 lanes
    per tile."""
    dev = row_local.device
    gcap = host.GCAP
    S, npix = row_local.shape
    G = S * rows_per_slice
    M = npix + rows_per_slice                 # merged pixels + sentinels
    B = max(int(npix).bit_length(), 1)
    nsb_cap = npix // gcap + 2

    def ar(n):
        return torch.arange(n, dtype=I32, device=dev)

    pidx = ar(npix)[None, :]
    gq = ar(rows_per_slice)[None, :]
    diff_m = torch.cat([diff, diff.new_zeros((S, rows_per_slice))], dim=1)
    key = torch.cat([(row_local.long() << B) | (pidx + 1),
                     (gq.long() << B).expand(S, rows_per_slice)], dim=1)
    key, order = torch.sort(key, dim=1)                  # keys unique
    diff_s = diff_m.gather(1, order)
    sidx = (key & ((1 << B) - 1)).to(I32)
    is_sent = sidx == 0
    idx_s = sidx - 1                                     # pixel stream index
    pidx2 = ar(M)[None, :]
    st = torch.cummax(torch.where(is_sent, pidx2, -1), dim=1).values
    r = pidx2 - st - 1                                   # rank within group
    # sentinels sort in chain-row order: slice s's k-th sentinel position
    # starts group (s, k); sizes are adjacent differences
    spos = torch.sort(torch.where(is_sent, pidx2, INT32_MAX),
                      dim=1).values[:, :rows_per_slice]
    nxt_spos = torch.cat([spos[:, 1:], spos.new_full((S, 1), M)], dim=1)
    size_f = (nxt_spos - spos - 1).reshape(-1)

    # ---- group-domain class ordering: buckets (split groups and
    # exact-GCAP groups) by (n_sb desc, group asc), then whole groups by
    # (size desc, group asc); empty groups last
    nsb = (size_f + gcap - 1) // gcap
    is_bucket = (nsb > 1) | (size_f == gcap)
    ckey = torch.where(is_bucket, -nsb, (1 << 30) + (gcap - size_f))
    ckey_s, order = torch.sort(ckey, stable=True)
    g_sorted = order.to(I32)
    nsb_sorted = nsb[order]
    size_sorted = size_f[order]
    isb_sorted = ckey_s < 0
    Mb = isb_sorted.sum(dtype=I32)                       # bucket groups
    rank_sorted = ar(G) - torch.where(isb_sorted, 0, Mb)

    kk = ar(nsb_cap)
    Mk = torch.searchsorted(ckey_s, -kk, out_int32=True)
    ntiles_k = (Mk + 127) // 128                         # buckets pad tiles
    base_k = torch.cumsum(ntiles_k, 0, dtype=I32) - ntiles_k
    n_bucket_tiles = ntiles_k.sum(dtype=I32)
    n_nonempty_norm = torch.searchsorted(
        ckey_s, ckey_s.new_full((1,), (1 << 30) + gcap),
        out_int32=True)[0] - Mb

    # ---- tile tables (tile domain)
    T = ar(tiles_cap)
    isbt = T < n_bucket_tiles
    k_of_T = torch.clamp(torch.searchsorted(base_k, T, right=True,
                                            out_int32=True) - 1,
                         0, nsb_cap - 1)
    nidx = Mb + 128 * (T - n_bucket_tiles)
    ncap = torch.where((nidx >= Mb) & (nidx < G),
                       size_sorted[torch.clamp(nidx, 0, G - 1).long()], 0)
    tile_caps = torch.where(isbt, gcap, ncap).to(I32)
    tile_bases = torch.cumsum(tile_caps, 0, dtype=I32) - tile_caps
    prev_base = base_k[torch.clamp(k_of_T - 1, min=0).long()]
    tile_pred = torch.where(isbt & (k_of_T > 0),
                            T - (base_k[k_of_T.long()] - prev_base),
                            -1).to(I32)

    # ---- slot-indexed lane tables: the sb = 0 lane of every group, then
    # the sub-lanes k >= 1 of the split groups (a prefix of the class
    # ordering)
    slot0 = torch.where(isb_sorted, rank_sorted,
                        n_bucket_tiles * 128 + rank_sorted)
    last0 = ((nsb_sorted == 1) & (size_sorted > 0)).to(I32)
    lane_tab = _set_drop(torch.zeros(slots_cap, dtype=I32, device=dev),
                         slot0, (g_sorted << 2) | last0)
    split_cap = min(S * npix // gcap + 2, G)
    sg = g_sorted[:split_cap]
    snsb = nsb_sorted[:split_cap]
    ks = ar(nsb_cap)[None, 1:]
    validk = ks < snsb[:, None]
    slotk = base_k[None, 1:] * 128 + ar(split_cap)[:, None]
    lastk = (ks == snsb[:, None] - 1).to(I32)
    packedk = (sg[:, None] << 2) | 2 | lastk
    lane_tab = _set_drop(lane_tab,
                         torch.where(validk, slotk, INT32_MAX), packedk)

    # ---- per-pixel destinations: each group's lane word rides its
    # sentinel and a forward fill; bucket -> (rank << 1) | 1, whole group
    # -> its lane's first cell << 1
    norm_tile = torch.clamp(n_bucket_tiles + (rank_sorted >> 7), 0,
                            tiles_cap - 1)
    cell0 = tile_bases[norm_tile.long()] * 128 + (rank_sorted & 127)
    wprime = torch.where(isb_sorted, (rank_sorted << 1) | 1, cell0 << 1)
    w_tab = torch.zeros(G, dtype=I32, device=dev).scatter_(
        0, g_sorted.long(), wprime.to(I32))
    sent_at = (ar(S)[:, None] * M + spos).reshape(-1)
    wfill = _set_drop(torch.full((S * M,), -1, dtype=I32, device=dev),
                      sent_at, w_tab).reshape(S, M)
    last_set = torch.cummax(torch.where(wfill >= 0, pidx2, -1),
                            dim=1).values
    wfill = wfill.gather(1, torch.clamp(last_set, min=0).long())

    sb = torch.div(r, gcap, rounding_mode="floor")
    t2 = r - sb * gcap
    bk = base_k[torch.clamp(sb, 0, nsb_cap - 1).long()]
    v = wfill >> 1
    dest_b = (gcap * (bk + (v >> 7)) + t2) * 128 + (v & 127)
    dest = torch.where(is_sent, INT32_MAX,
                       torch.where((wfill & 1) == 1, dest_b, v + r * 128))
    # cell channel: the biased diff (or the payload), then the pixel-valid
    # flag
    if payload_bits:
        ch1 = diff_s | ((~is_sent).to(I32) << payload_bits)
    elif wide:
        ch1 = (diff_s + (1 << (wide - 1))) | ((~is_sent).to(I32) << wide)
    else:
        ch1 = (diff_s + 2048) | ((~is_sent).to(I32) << 13)
    orig = torch.where(is_sent, INT32_MAX, ar(S)[:, None] * npix + idx_s)
    # K1's slot geometry (not in JAX's plan): a real slot (T, l) holds
    # the elements of group lane_rows[T * 128 + l] from rank
    # tile_rank0[T] on, at cells (cell_bases[T] + j) * 128 + l,
    # j < cell_caps[T]
    return dict(ch1=ch1.reshape(-1).to(I32), orig=orig.reshape(-1).to(I32),
                dest=dest.reshape(-1).to(I32),
                group_first=sent_at + 1, group_size=size_f,
                tile_rank0=torch.where(isbt, k_of_T * gcap, 0).to(I32),
                cell_bases=tile_bases, cell_caps=tile_caps,
                tile_caps=tile_caps, tile_bases=tile_bases,
                tile_pred=tile_pred, lane_rows=lane_tab >> 2,
                lane_cont=(lane_tab >> 1) & 1, lane_last=lane_tab & 1,
                n_rows=tile_caps.sum(dtype=I32),
                n_tiles=(n_bucket_tiles
                         + (torch.clamp(n_nonempty_norm, min=0) + 127)
                         // 128),
                n_slots=n_bucket_tiles * 128 + n_nonempty_norm)


def build_s0_blocks(plan, canonical, tiles_cap: int, slot_at_row):
    """(TILES_CAP, 33, 128) int32 start-state blocks from the canonical
    per-chain state table ((rows, 32) uint8): slot rows in SLOT_AT_ROW
    order (``slot_at_row``: that index, int64 on the table's device), row
    32 = continuation flag."""
    rows = plan["lane_rows"].reshape(tiles_cap, 128).long()
    cont = plan["lane_cont"].reshape(tiles_cap, 128)
    s0 = canonical.to(I32)[:, slot_at_row][rows]              # (T,128,32)
    return torch.cat([s0.permute(0, 2, 1), cont[:, None, :]],
                     dim=1).contiguous()


def writeback_canonical(plan, canonical, end_states, tiles_cap: int,
                        row_of_slot):
    """Store group-end states back into the canonical table for the next
    (inter) frame; only lanes holding their group's last sub-block
    write.  end_states rows are in SLOT_AT_ROW order (``row_of_slot``:
    ROW_OF_SLOT, int64 on the table's device)."""
    rows = plan["lane_rows"].reshape(-1).long()
    last = plan["lane_last"].reshape(-1) > 0
    ends = end_states[:, row_of_slot, :].permute(0, 2, 1).reshape(-1, 32)
    n = canonical.shape[0]
    ext = torch.cat([canonical, canonical.new_zeros((1, 32))])
    # lanes that do not write land on the spare row past the table
    ext[torch.where(last, rows, n)] = ends.to(torch.uint8)
    return ext[:n]


def unsort_cells(ev_cells, ch1c, ch2c, S: int, npix: int,
                 code_bits: int = 10):
    """Cells -> stream order.  ch2c holds each real cell's stream index
    (unique; empty cells INT32_MAX), so one scatter replaces the payload
    sort.  Returns (words (W, S, npix) int32, maxc): maxc is the frame's
    largest op count over the valid cells (read through the payload field
    of ``code_bits``), checked against the unsort width by the caller."""
    n = S * npix
    W = ev_cells.shape[1]
    keys = ch2c.reshape(-1)
    idx = torch.where(keys < n, keys, n).long()
    words = ev_cells.permute(1, 0, 2).reshape(W, -1)
    out = torch.zeros((W, n + 1), dtype=I32, device=ev_cells.device)
    out.scatter_(1, idx.expand(W, -1), words)
    mask, bias, vbit = host.payload_field(code_bits)
    if code_bits <= 10:
        mask = 0x1FFF                    # as the JAX unsort reads it
    diff_c = (ch1c & mask) - bias
    maxc = torch.where(((ch1c >> vbit) & 1) == 1, event_count(diff_c),
                       0).max()
    return out[:, :n].reshape(W, S, npix).contiguous(), maxc


def unsort_codes(code_cells, ch2c, S: int, npix: int):
    """Rice code cells -> stream order (S, npix): one scatter keyed by each
    real cell's stream index, as ``unsort_cells`` (``_s_rice_unsort_impl``
    sorts by the same unique keys)."""
    n = S * npix
    keys = ch2c.reshape(-1)
    out = torch.zeros(n + 1, dtype=I32, device=code_cells.device)
    out.scatter_(0, torch.where(keys < n, keys, n).long(),
                 code_cells.reshape(-1))
    return out[:n].reshape(S, npix)


class _Launched(NamedTuple):
    """A range bank's frame up to K4's launch (``Bank.launch_range``)."""
    opw: torch.Tensor           # K3's op words
    steps: int                  # K4's step bucket
    by: torch.Tensor            # K4's bytes, on the device
    ln: torch.Tensor            # K4's lengths, on the device
    attempt: int                # the cap-retry attempt whose sizes fit


def _read(tensors) -> list:
    """Device tensors -> their host arrays, in one read: one tensor is
    copied down as it is; several are joined into one buffer on the
    device first."""
    if len(tensors) == 1:
        return [tensors[0].cpu().numpy()]
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    ends = np.cumsum([t.numel() for t in tensors])
    return [a.reshape(t.shape) for a, t in zip(np.split(flat, ends[:-1]),
                                                tensors)]


def shape_banks(crop_plan) -> list:
    """The slice ids of each shape bank of a frame's crop plan
    (``host.build_crop_plan``), banks in order of their first slice: the
    slices whose rects have equal (w, h) in every plane.  A uniform
    geometry has one bank of every slice."""
    groups = {}
    for si in range(len(crop_plan[0])):
        sig = tuple((prects[si][2], prects[si][3]) for prects in crop_plan)
        groups.setdefault(sig, []).append(si)
    return list(groups.values())


def upload(planes, device) -> list:
    """Planes -> int32 tensors on ``device``: numpy arrays are copied up;
    a tensor already there (a device conversion's output,
    ``convert/device.py``) is used as it is, cast on the device."""
    return [torch.as_tensor(pl if torch.is_tensor(pl) else np.asarray(pl),
                            dtype=I32, device=device)
            for pl in planes]


# the kernels each path's frame launches (chip_smoke.py and the card tests
# check that a path went through all of its kernels)
RANGE_KERNELS = ("phase_a", "place", "adapt", "emission_pack", "expand",
                 "rac_render")
EMISSION_KERNELS = ("phase_a", "place", "adapt_emission", "expand",
                    "rac_render")
RICE_KERNELS = ("phase_a", "place", "vlc", "ladder")


class Bank:
    """The slices ``slice_ids`` of a frame (``crop_plan``: the frame's),
    whose rects have one shape in every plane, as one batched stream: its
    plans, chain rows, carried state table, slice prefixes or headers and
    ``caps``, and the stages of a frame.  Raises NotImplementedError where
    ``DeviceFFV1Encoder`` does."""

    def __init__(self, p: FFV1Params, slice_ids, crop_plan, device,
                 emission_order: bool = False):
        self.p, self.device = p, device
        if p.version == 2:
            raise NotImplementedError(
                "device coder: versions 0/1/3/4 (v2's in-band slice table "
                "is a deprecated transitional layout)")
        self.golomb = p.ac == CODER_GOLOMB
        if p.initial_states is not None and self.golomb:
            raise NotImplementedError("initial states are a range-coder "
                                      "feature")
        # version-4 RGB searches the RCT coefficients per slice on the
        # device and codes them in the slice headers
        self.v4rgb = p.version > 3 and p.colorspace == 1
        if self.golomb and self.v4rgb:
            raise NotImplementedError(
                "device rice + version-4 RGB: the per-slice RCT search "
                "re-plans the static rice headers per frame; use version "
                "<= 3 (the FATE configuration) or the range coder")
        # RGB codes the RCT planes at depth bits + 1
        # (ffv1enc_template.c:193)
        self.code_bits = (max(p.bits, 8) + 1 if p.colorspace == 1
                          else p.bits)
        if self.code_bits > 17:
            raise NotImplementedError("device coder: coding depth <= 17")
        # the range cells' valid bit for coding depths over 10
        self.wide = (0 if self.code_bits <= 10
                     else host.payload_field(self.code_bits)[2])
        self.emission_order = bool(emission_order)
        self.kernels = (RICE_KERNELS if self.golomb else
                        EMISSION_KERNELS if self.emission_order else
                        RANGE_KERNELS)
        self.slice_ids = list(slice_ids)
        self.S = len(self.slice_ids)
        self.crop_plan = [[prects[si] for si in self.slice_ids]
                          for prects in crop_plan]
        self.qt = lut_for(p, p.context_model)
        self.five = bool(p.quant_tables[p.context_model][3][127]
                         or p.quant_tables[p.context_model][4][127])
        # phase A's one launch a frame: its descriptor table on the device
        if p.colorspace == 1:
            _, _, sw, sh = self.crop_plan[0][0]
            self.pa_plan = rgb_plan(self.S, sh, sw, len(self.crop_plan),
                                    self.qt, self.code_bits, self.five,
                                    self.device)
        else:
            self.pa_plan = yuv_plan(self.crop_plan, self.qt, p.bits,
                                    self.five, self.device)

        # stream: YUV concatenates whole planes per slice, RGB interleaves
        # them line by line; chain rows are (plane class, context) with
        # plane class (plane + 1) // 2
        plane_sizes = [prects[0][2] * prects[0][3]
                       for prects in self.crop_plan]
        self.npix = int(np.sum(plane_sizes))
        if p.colorspace == 1:
            pclass = np.tile(np.repeat(np.array(
                [(li + 1) // 2 for li in range(len(self.crop_plan))],
                np.int32), sw), sh)
        else:
            pclass = np.concatenate([np.full(sz, (li + 1) // 2, np.int32)
                                     for li, sz in enumerate(plane_sizes)])
        class_counts = SliceState(p).plane_ctx_count
        class_off = np.zeros(p.plane_count, np.int32)
        class_off[1:] = np.cumsum(class_counts[:-1])
        self.rows_per_slice = int(np.sum(class_counts))
        self.class_off_stream = torch.as_tensor(class_off[pclass],
                                                device=self.device)
        self.n_chain_rows = self.S * self.rows_per_slice
        self.state_shape = (self.n_chain_rows + 1, 4 if self.golomb else 32)
        self.batch_caps = {}         # encode_batch's layout caps, per B
        if self.golomb:
            self._init_rice()
        else:
            self._init_range()

    def _init_range(self):
        p = self.p
        self.table = torch.as_tensor(host.packed_transition_table(p),
                                     device=self.device)
        # the state rows' order in the walk's slots, on the device once:
        # no frame copies them up (a copy up syncs the stream)
        self.slot_at_row, self.row_of_slot = (
            torch.as_tensor(t, device=self.device).long()
            for t in (host.SLOT_AT_ROW, host.ROW_OF_SLOT))
        # keyframe canonical: 128 everywhere, or the 2-pass per-context
        # initial states (ff_ffv1_clear_slice_state, ffv1.c:70-84): one
        # slice's (rows_per_slice, 32) key (canonical_key1) tiled over the
        # slices, plus the spare row
        ck = np.full((self.rows_per_slice, 32), 128, np.uint8)
        if p.initial_states is not None:
            ss = SliceState(p)
            off = 0
            for cnt, qt in zip(ss.plane_ctx_count, ss.plane_qt_index):
                init = p.initial_states[qt]
                if init is not None:
                    ck[off:off + cnt] = np.asarray(init, np.uint8)[:cnt]
                off += cnt
        self.canonical_key1 = torch.as_tensor(ck, device=self.device)
        self.canonical_key = self.key_canonical(self.S)
        self.canonical = self.canonical_key

        # host-planned per-slice prefix ops (constant per keyframe flag;
        # v4 RGB re-plans them per frame with the chosen RCT coefficients)
        self.prefix = {key: self._plan_prefix(key, None)
                       for key in (True, False)}
        self._rct_prefix_cache = {}
        hmax = max(int(self.prefix[k][0].shape[1]) for k in (True, False))
        self.caps = Caps.range(self.npix, self.S, self.rows_per_slice, hmax,
                               self.code_bits)

    def _plan_prefix(self, keyframe: bool, rct_list, pad_to: int = 1):
        """(svp, btp, hlen) tensors of this bank's slices' prefix ops;
        rct_list gives each slice's (by, ry) for its v4 slice header."""
        p = self.p
        rects = p.rects()
        ops = []
        for li, si in enumerate(self.slice_ids):
            ss = SliceState(p)
            if rct_list is not None:
                ss.slice_rct_by, ss.slice_rct_ry = rct_list[li]
            ops.append(host.plan_slice_prefix(p, ss, si, rects[si],
                                              keyframe))
        hmax = -(-max(len(sv) for sv, _ in ops) // pad_to) * pad_to
        svp = np.zeros((self.S, hmax), np.int32)
        btp = np.zeros((self.S, hmax), np.int32)
        for li, (sv, bit) in enumerate(ops):
            svp[li, :len(sv)] = sv
            btp[li, :len(bit)] = bit
        hlen = np.array([len(sv) for sv, _ in ops], np.int32)
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in (svp, btp, hlen))

    def _init_rice(self):
        """Rice state: the canonical VlcState table (one row of drift,
        error_sum, bias, count per chain row, plus a spare row), the slice
        headers and the caps."""
        p = self.p
        # the rice cell's payload width: 12 bits for coding depths up to
        # 12, 16 for 13..16 (silent flag at pb, layout valid flag at pb +
        # 1); coding depth 17 (rgb48) raises NotImplementedError
        self.rice_pb = rice_pb(self.code_bits)
        self.vcanon_key = torch.as_tensor(
            np.tile(VLC_INIT, (self.n_chain_rows + 1, 1)), device=self.device)
        self.vcanon = self.vcanon_key
        # a Golomb-Rice slice's range coder terminates after its header
        # (encoder.py:80-83), so the header bytes are constant per
        # (keyframe, slice)
        rects = p.rects()
        self.rice_headers = {}
        for key in (True, False):
            hdrs = []
            for si in self.slice_ids:
                c = RangeEncoder()
                if si == 0:
                    c.put(np.array([128], dtype=np.uint8), 0,
                          1 if key else 0)
                    if key and p.version < 2:
                        H.write_v01_header(c, p)
                if p.version > 2:
                    H.write_slice_header(c, p, SliceState(p), rects[si])
                hdrs.append(c.terminate(1 if p.version > 2 else 0))
            self.rice_headers[key] = hdrs
        nlines = sum(prects[0][3] for prects in self.crop_plan)
        self.caps = Caps.rice(self.npix, self.S, self.rows_per_slice, nlines,
                              p.bits)

    # -- codec state ---------------------------------------------------------

    def state(self) -> np.ndarray:
        """The per-chain state table that the next inter frame starts
        from: the range coder's context states (n_chain_rows + 1, 32)
        uint8, or the Golomb-Rice VlcStates (n_chain_rows + 1, 4) int32
        (drift, error_sum, bias, count)."""
        return (self.vcanon if self.golomb else self.canonical).cpu().numpy()

    def load_state(self, table: np.ndarray):
        """Continue from another session's state table (``state()``'s, or
        the JAX DeviceFFV1Encoder's ``canonical``, or its ``vcanon`` for
        Golomb-Rice)."""
        table = np.asarray(table)
        dtype = np.int32 if self.golomb else np.uint8
        if table.shape != self.state_shape or table.dtype != dtype:
            raise ValueError(f"load_state: expected {np.dtype(dtype)} "
                             f"{self.state_shape}, got {table.dtype} "
                             f"{table.shape}")
        setattr(self, "vcanon" if self.golomb else "canonical",
                torch.as_tensor(table.copy(), device=self.device))

    # -- pipeline stages -----------------------------------------------------

    def phase_a(self, planes, by=None, ry=None, out=None):
        """Planes (tensors on the device) -> per-slice (ctx, diff) streams
        (n_slices, npix) int32, into the pair ``out`` where given: one
        launch of the phase_a kernel (``pa_plan``).  RGB first takes the
        RCT in torch, fixed, or with the per-slice coefficients
        ``by``/``ry`` ((n_slices,) int32) of version 4."""
        if self.p.colorspace == 1:
            planes = [c.reshape(-1, c.shape[-1]) for c in rct_planes(
                planes, self.crop_plan[0], self.p, by, ry)]
        return run_phase_a(self.pa_plan, planes, out)

    def range_streams(self, planes, keyframe: bool, mark=no_mark):
        """Planes on the device -> (ctx, diff, the slices' prefix ops): v4
        RGB first picks each slice's RCT coefficients (a read of the
        candidates' costs, ``RCT costs to host``) and plans the slice
        headers that carry them (as the JAX session's frame does)."""
        if not self.v4rgb:
            return (*self.phase_a(planes), self.prefix[keyframe])
        rct = self.pick_rct(planes)
        mark("RCT costs to host")
        by, ry = torch.tensor(rct, dtype=I32, device=self.device).T
        return (*self.phase_a(planes, by.contiguous(), ry.contiguous()),
                self.prefix_for_rct(keyframe, rct))

    def pick_rct(self, planes) -> list:
        """The v4 per-slice RCT search: [(by, ry)] per slice, from the
        candidates' cost sums on the device (device_coder._pick_rct)."""
        x, y, w, h = self.crop_plan[0][0]
        if h < 2 or w < 2:
            return [(1, 1)] * self.S
        return pick_rct(rct_costs(planes, self.crop_plan[0]))

    def prefix_for_rct(self, keyframe: bool, rct_list):
        """Slice-header prefixes carrying the chosen per-slice RCT
        coefficients, cached per (keyframe, coefficients); hmax is rounded
        up to a multiple of 16 (device_coder._prefix_for_rct)."""
        key = (keyframe, tuple(rct_list))
        hit = self._rct_prefix_cache.get(key)
        if hit is None:
            if len(self._rct_prefix_cache) > 64:
                self._rct_prefix_cache.clear()
            hit = self._rct_prefix_cache[key] = self._plan_prefix(
                keyframe, rct_list, pad_to=16)
        return hit

    def layout(self, ctx, diff, tiles_cap: int, cellrows_cap: int,
               payload_bits: int = 0):
        plan = layout_plan(self.class_off_stream[None, :] + ctx, diff,
                           self.rows_per_slice, tiles_cap * 128, tiles_cap,
                           payload_bits, self.wide)
        # under a cap overflow the frame is redone larger; keep every tile
        # of the walk inside the cells regardless (K1 keeps the unclamped
        # cell_bases/cell_caps that dest was computed from)
        lim = cellrows_cap - 1024
        plan["tile_bases"] = torch.clamp(plan["tile_bases"], max=lim)
        plan["tile_caps"] = torch.minimum(plan["tile_caps"],
                                          lim - plan["tile_bases"])
        return plan

    def adapt(self, ch1c, plan, s0, ev_words: int, mark=no_mark):
        """The walk -> (emission-order words (CELLROWS, ev_words, 128),
        end states): K2 and emission_pack (the repack to emission order),
        or K6 under emission_order (device_coder._adapt)."""
        k = (ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
             s0, self.table, self.code_bits)
        if self.emission_order:
            out = adapt_emission(*k, ev_words)
            mark("K6 adapt_emission", k + (ev_words,))
            return out
        sv, ends = adapt(*k)
        mark("K2 adapt", k)
        kp = (sv, ch1c, plan["tile_caps"], plan["tile_bases"],
              self.code_bits, ev_words)
        ev = pack_emission(*kp)
        mark("emission_pack", kp)
        return ev, ends

    def front(self, ctx, diff, canonical, keyframe: bool, tiles_cap: int,
              cellrows_cap: int, ev_words: int, mark=no_mark):
        """Layout, K1 place, start states, the walk (K2 then emission_pack
        to emission order, or K6) and the state writeback
        (device_coder._s_front).  ``mark`` is called after each stage
        (``metrics.no_mark`` by default)."""
        plan = self.layout(ctx, diff, tiles_cap, cellrows_cap)
        mark("layout")
        k1 = (plan, cellrows_cap)
        ch1c, ch2c = place(*k1)
        mark("K1 place", k1)
        if keyframe:
            canonical = (self.canonical_key if ctx.shape[0] == self.S
                         else self.key_canonical(ctx.shape[0]))
        s0 = build_s0_blocks(plan, canonical, tiles_cap, self.slot_at_row)
        mark("s0")
        ev, ends = self.adapt(ch1c, plan, s0, ev_words, mark)
        canonical = writeback_canonical(plan, canonical, ends, tiles_cap,
                                        self.row_of_slot)
        mark("writeback")
        psizes = torch.stack([plan["n_rows"], plan["n_tiles"],
                              plan["n_slots"]])
        return ev, ch1c, ch2c, canonical, psizes

    def ops_from_streams(self, ctx, diff, canonical, svp, btp, hlen,
                         keyframe: bool, caps, ev_words: int, mark=no_mark):
        """Streams of n slices (the bank's S, or a batch's B x S) -> (opw
        (n, op_cap) int32 op words, n_ops (n,), canonical after the frame,
        sizes = [rows, tiles, slots, opmax, maxcount]) at ``caps`` =
        (tiles_cap, cellrows_cap, op_cap).  A keyframe starts from
        ``key_canonical(n)``, not from ``canonical``."""
        tiles_cap, cellrows_cap, op_cap = caps
        ev, ch1c, ch2c, canonical, psizes = self.front(
            ctx, diff, canonical, keyframe, tiles_cap, cellrows_cap,
            ev_words, mark)
        words, maxc = unsort_cells(ev, ch1c, ch2c, ctx.shape[0], self.npix,
                                   self.code_bits)
        mark("unsort")
        k3 = (words, diff, svp, btp, hlen, op_cap)
        opw, n_ops = expand(*k3)
        mark("K3 expand", k3)
        sizes = torch.cat([psizes, n_ops.max()[None], maxc[None]])
        return opw, n_ops, canonical, sizes

    def render(self, opw, steps: int, mark=no_mark):
        """K4 at the bank's render cap, launched and not read: (bytes,
        lengths) on the device.  ``mark`` is called after K4 with its
        inputs."""
        k4 = (opw, steps, self.caps.render_cap)
        by, ln = rac_render(*k4)
        mark("K4 rac_render", k4)
        return by, ln

    def render_fit(self, opw, steps: int, mark=no_mark):
        """K4, its render cap grown and K4 redone until the lengths fit
        (a read of the lengths an attempt): (bytes on the device, host
        lengths)."""
        _, by, ln = fit(lambda: self.render(opw, steps, mark),
                        self.caps.fits_render, mark, 6, "lengths to host",
                        "render buffer exceeded worst-case cap")
        return by, ln

    def _fit_ops(self, ctx, diff, canonical, prefix, keyframe: bool,
                 layout: Caps, mark=no_mark):
        """``ops_from_streams`` at ``layout``'s tile and cell-row caps and
        the bank's op caps, fitted (``caps.fit``): (the attempt that fit,
        opw, n_ops, canonical after it, the largest op count, K4's step
        count: its power-of-two bucket)."""
        caps = self.caps

        def run():
            *out, sizes = self.ops_from_streams(
                ctx, diff, canonical, *prefix, keyframe,
                (layout.tiles_cap, layout.cellrows_cap, caps.op_cap),
                caps.unsort_words, mark)
            return out, sizes

        attempt, (opw, n_ops, canon), sizes = fit(
            run, lambda s: layout.fits_layout(*s[:3]) & caps.fits_ops(*s[3:]),
            mark)
        steps = max(512, min(1 << sizes[3].bit_length(), int(opw.shape[1])))
        return attempt, opw, n_ops, canon, sizes[3], steps

    def launch_range(self, dev, keyframe: bool, mark=no_mark) -> _Launched:
        """Phase A through K3 on the uploaded planes (``_fit_ops``), then
        K4 launched and not read."""
        ctx, diff, prefix = self.range_streams(dev, keyframe, mark)
        mark("phase_a")
        attempt, opw, _, self.canonical, opmax, steps = self._fit_ops(
            ctx, diff, self.canonical, prefix, keyframe, self.caps, mark)
        self.caps.shrink_ops(opmax)
        return _Launched(opw, steps, *self.render(opw, steps, mark), attempt)

    # -- Golomb-Rice stages --------------------------------------------------

    def phase_a_rice(self, planes):
        """Planes -> (ctx (S, npix), the rice stream dict of (S, npix)
        tensors, build_rice_streams); runs are planned per plane, on views
        of phase A's streams (device_coder._phase_a_rice).  RGB takes the
        fixed RCT and interleaves the planes line by line under one
        run-index ladder."""
        ctx, diff = self.phase_a(planes)
        return ctx, build_rice_streams(
            self.pa_plan.grids(ctx), self.pa_plan.grids(diff),
            interleave=self.p.colorspace == 1, pb=self.rice_pb)

    def rice_front(self, ctx, payload, vcanon, keyframe: bool,
                   tiles_cap: int, cellrows_cap: int, mark=no_mark):
        """Layout, K1 place, start states, K5 vlc walk, the state
        writeback and the unsort: returns (codes (S, npix) len << 18 | val
        in stream order, vcanon after the frame, [rows, tiles, slots]).
        ``mark`` is called after each stage (``metrics.no_mark`` by
        default)."""
        plan = self.layout(ctx, payload, tiles_cap, cellrows_cap,
                           self.rice_pb + 1)
        mark("layout")
        k1 = (plan, cellrows_cap)
        ch1c, ch2c = place(*k1)
        mark("K1 place", k1)
        if keyframe:
            vcanon = self.vcanon_key
        s0 = build_vlc_s0(plan, vcanon, tiles_cap)
        mark("s0")
        k5 = (ch1c, plan["tile_caps"], plan["tile_bases"], plan["tile_pred"],
              s0)
        code_cells, ends = vlc_adapt(*k5, self.code_bits)
        mark("K5 vlc", k5)
        vcanon = writeback_vlc(plan, vcanon, ends, tiles_cap)
        mark("writeback")
        codes = unsort_codes(code_cells, ch2c, self.S, self.npix)
        mark("unsort")
        psizes = torch.stack([plan["n_rows"], plan["n_tiles"],
                              plan["n_slots"]])
        return codes, vcanon, psizes

    def rice_bits(self, streams, codes, ev_cap: int, nwords: int,
                  mark=no_mark):
        """The run-index ladder, the bit elements and their assembly:
        (bytes (S, nwords * 4) uint8, nbits (S,), n_lad (S,))."""
        ones, term_j, rem, n_lad = ladder_fields(streams, ev_cap, mark)
        lens, vals = rice_elements(streams, codes, ones, term_j, rem)
        mark("bit elements")
        by, nbits = assemble_bits(lens, vals, nwords)
        mark("bit assembly")
        return by, nbits, n_lad

    def rice_slices(self, by_h, nbits, keyframe: bool) -> list:
        """Host bytes (S, nwords * 4) and bit counts -> raw slice payloads:
        each slice's header bytes, then its bitstream."""
        hdrs = self.rice_headers[keyframe]
        return [hdrs[si] + by_h[si, :(nbits[si] + 7) // 8].tobytes()
                for si in range(self.S)]

    def encode_rice(self, dev, keyframe: bool, mark=no_mark) -> list:
        """One Golomb-Rice frame, its planes on the device (``upload``) ->
        list of raw slice payloads (encoder.py:_encode_slice); ``mark`` is
        called after each stage."""
        ctx, streams = self.phase_a_rice(dev)
        mark("phase_a")
        caps = self.caps

        def run():
            codes, vcanon, psizes = self.rice_front(
                ctx, streams["payload"], self.vcanon, keyframe,
                caps.tiles_cap, caps.cellrows_cap, mark)
            by, nbits, n_lad = self.rice_bits(streams, codes, caps.ev_cap,
                                              caps.nwords, mark)
            return (by, vcanon), torch.cat([psizes, n_lad.max()[None],
                                            nbits])

        _, (by, self.vcanon), sizes = fit(run, lambda s: (
            caps.fits_layout(*s[:3]) & caps.fits_rice(s[3], s[4:])), mark,
            error="device rice exceeded worst-case caps")
        by_h = by.cpu().numpy()
        mark("bytes to host")
        chunks = self.rice_slices(by_h, sizes[4:], keyframe)
        mark("slice bytes")
        return chunks

    # -- all-intra batches ---------------------------------------------------

    def key_canonical(self, n_slices: int):
        """The keyframe state table of ``n_slices`` slices: one slice's
        key (``canonical_key1``: 128, or the 2-pass initial states) tiled
        over them, plus the spare row of 128 (device_coder._s_front)."""
        return torch.cat([self.canonical_key1.repeat(n_slices, 1),
                          self.canonical_key1.new_full((1, 32), 128)])

    def batch_streams(self, frames_list):
        """B frames -> (ctx, diff) of their B x S slices, frame-major, and
        the keyframe prefix ops tiled over the frames
        (device_coder._pipeline_batch): frame b's phase A launch writes
        rows b * S .. (b + 1) * S of the pair."""
        B, S = len(frames_list), self.S
        ctx = torch.empty((B * S, self.npix), dtype=I32, device=self.device)
        diff = torch.empty_like(ctx)
        for b, f in enumerate(frames_list):
            self.phase_a(upload(f, self.device),
                         out=(ctx[b * S:(b + 1) * S], diff[b * S:(b + 1) * S]))
        svp, btp, hlen = self.prefix[True]
        return ctx, diff, (svp.repeat(B, 1), btp.repeat(B, 1),
                           hlen.repeat(B))

    def batch_ops(self, frames_list, mark=no_mark):
        """B >= 1 key frames -> (opw (B x S, op_cap) op words, n_ops
        (B x S,), K4's step count): phase A, the layout, K1, the walk and
        K3 on the batch's slices, retried on the batch's own layout caps
        (per B) until every size fits (device_coder.encode_batch)."""
        B = len(frames_list)
        staged = [upload(f, self.device) for f in frames_list]
        mark("upload")
        ctx, diff, prefix = self.batch_streams(staged)
        del staged          # phase A's streams replace the int32 planes
        mark("phase_a")
        layout = self.batch_caps.get(B)
        if layout is None:
            layout = self.batch_caps[B] = Caps.layout(
                self.npix, B * self.S, self.rows_per_slice)
        _, opw, n_ops, _, _, steps = self._fit_ops(ctx, diff, None, prefix,
                                                   True, layout, mark)
        return opw, n_ops, steps


def code_banks(banks, dev, keyframe: bool, mark=no_mark) -> list:
    """One frame's uploaded planes through every shape bank -> each bank's
    raw slice payloads.  The range banks run as one pipeline: each in
    turn enqueues phase A through K3, reads its sizes and launches K4
    unread; then one read of every bank's lengths (a bank over its render
    cap codes again) and one of their bytes.  The Golomb-Rice banks run
    one after the other.  A bank's stages are marked with its index; once
    the records left bank 0, the call's own stages are bank 0's at
    attempt 0, else they run on at the one bank's attempt."""
    jobs = []
    for i, bank in enumerate(banks):
        metrics.bank(mark, i)
        jobs.append(bank.encode_rice(dev, keyframe, mark) if bank.golomb
                    else bank.launch_range(dev, keyframe, mark))
    left = i > 0
    if left:
        metrics.bank(mark, 0)
    if banks[0].golomb:
        return jobs
    lens = _read([j.ln for j in jobs])
    mark("lengths to host")
    bys = []
    for i, (bank, j) in enumerate(zip(banks, jobs)):
        by = j.by
        if not bank.caps.fits_render(lens[i]):
            # K4 again, under the bank's own index and next attempt
            metrics.bank(mark, i, j.attempt + 1)
            by, lens[i] = bank.render_fit(j.opw, j.steps, mark)
            if left:
                metrics.bank(mark, 0)
        bys.append(by)
    bys = _read(bys)
    mark("bytes to host")
    out = [[by_h[li, :int(ln_h[li])].tobytes() for li in range(bank.S)]
           for bank, by_h, ln_h in zip(banks, bys, lens)]
    mark("slice bytes")
    return out


def finish_packet(p: FFV1Params, slice_ids, datas) -> bytes:
    """A frame's raw slice payloads and each one's global slice index ->
    its packet: the slices in global order, each with its 3-byte BE size
    trailer and optional CRC (ffv1enc.c:1236-1262 layout)."""
    chunks = [None] * len(datas)
    for si, data in zip(slice_ids, datas):
        chunks[si] = data
    out = []
    for si, data in enumerate(chunks):
        if si > 0 or p.version > 2:
            if len(data) >= 1 << 24:
                raise RuntimeError("slice exceeds the 24-bit size field")
            data += len(data).to_bytes(3, "big")
            if p.ec:
                data += b"\x00"
                data += crc32_trailer(data)
        out.append(data)
    return b"".join(out)


class DeviceFFV1Encoder:
    """FFV1 encode with phase A and the entropy coder on a CUDA device.

    Covers versions 0/1/3/4 with the range coder (custom table, coder=1,
    and the default table, coder=-2) on YUV, gray and RGB formats at every
    depth up to 16 bits per sample (RGB codes at bits + 1: rgb48 at 17,
    with int32 samples), the v4 per-slice RCT search, and the Golomb-Rice
    coder (coder=0, YUV/gray/RGB up to version 3, coding depths up to
    16); one keyframe
    followed by inter frames carries the context states from frame to
    frame.  The session codes a frame through ``banks``, one ``Bank`` per
    slice shape (one for a uniform geometry), and assembles the packet in
    global slice order.
    ``emission_order`` runs K6 (the walk that packs the emission order
    itself) instead of K2 and emission_pack, as the JAX encoder does under
    FFV1_ADAPT_EMISSION=1.  device="cpu" runs every kernel's plain
    PyTorch version (tests).  ``params`` overrides the config's
    FFV1Params, such as the 2-pass parameters of
    ``twopass.apply_pass2`` (custom transition table and per-context
    initial states, on every bank).  Raises NotImplementedError for v4
    RGB with Golomb-Rice, initial states with Golomb-Rice and coding
    depths above 17."""

    def __init__(self, width: int, height: int, pix_fmt: str,
                 config: FFV1Config | None = None, device="cuda",
                 emission_order: bool = False,
                 params: FFV1Params | None = None):
        """The set-up is a call record ``session init`` on
        ``metrics.TRACE``, which is the session's ``trace``: the recorder
        that ``encode`` and ``encode_batch`` mark by default (an operator
        may set their own ``StageTrace``)."""
        self.trace = metrics.TRACE
        with self.trace.call("session init", 0):
            self.device = torch.device(device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("DeviceFFV1Encoder: device='cuda' but "
                                   "torch sees no CUDA device")
            if self.device.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {self.device}")
            self.cfg = config or FFV1Config()
            p = self.p = (params if params is not None else
                          params_from_config(self.cfg, pix_fmt, width,
                                             height))
            # the batched stream layout needs one slice shape: a
            # non-uniform geometry splits into banks of equal shapes
            plan = host.build_crop_plan(p)
            self.banks = [Bank(p, ids, plan, self.device, emission_order)
                          for ids in shape_banks(plan)]
            self.kernels = self.banks[0].kernels
            self.picture_number = 0
            self.extradata = H.write_extradata(p) if p.version > 1 else b""
            self.trace("session tables")

    # -- codec state ---------------------------------------------------------

    def _one_bank(self, what: str) -> Bank:
        if len(self.banks) > 1:
            raise ValueError(
                f"{what}: this session splits a non-uniform slice geometry "
                f"into {len(self.banks)} shape banks, each with its own "
                "state table; there is no single table")
        return self.banks[0]

    def state(self) -> np.ndarray:
        """The one bank's ``Bank.state``: ValueError with several."""
        return self._one_bank("state").state()

    def load_state(self, table: np.ndarray, picture_number: int):
        """The one bank's ``Bank.load_state``: ValueError with several."""
        self._one_bank("load_state").load_state(table)
        self.picture_number = int(picture_number)

    def _table(name):  # the one bank's state table, to swap whole
        return property(lambda s: getattr(s._one_bank(name), name),
                        lambda s, t: setattr(s._one_bank(name), name, t))

    canonical, vcanon = _table("canonical"), _table("vcanon")

    # -- public API ------------------------------------------------------------

    def upload(self, planes) -> list:
        """Planes -> int32 tensors on the session's device (``upload``)."""
        return upload(planes, self.device)

    def encode(self, planes, force_keyframe=None, mark=None) -> bytes:
        """One frame -> its packet: the planes uploaded once, then every
        bank (``code_banks``).  Every stage is marked on ``mark`` (the
        session's ``trace`` by default, in a call record ``encode`` of one
        frame)."""
        mark = self.trace if mark is None else mark
        with metrics.span(mark, "encode", 1):
            gop = self.cfg.gop_size
            keyframe = gop == 0 or self.picture_number % gop == 0
            if force_keyframe is not None:
                keyframe = bool(force_keyframe)
            dev = self.upload(planes)
            mark("upload")
            parts = code_banks(self.banks, dev, keyframe, mark)
            self.picture_number += 1
            pkt = finish_packet(self.p,
                                [si for b in self.banks for si in b.slice_ids],
                                [data for part in parts for data in part])
            mark("slice trailers + CRC")
        return pkt

    def encode_batch(self, frames_list, mark=None) -> list:
        """B intra (key) frames -> their packets, in one pass of B x S
        slices through phase A, the layout, K1, the walk (K2 and
        emission_pack, or K6), K3 and K4 (device_coder.encode_batch):
        keyframes reset every slice's states, so the frames are
        independent coding units.  Planes are numpy arrays or tensors
        (``upload``).  The batch keeps its own layout caps per B and
        leaves the session's state table, picture number and layout caps
        as they were; it shares (and may grow) op_cap, unsort_words and
        render_cap.  Raises NotImplementedError for shape banks and v4
        RGB (as the JAX encoder does) and for Golomb-Rice (the JAX batch
        runs the range pipeline under a rice header there).  Every stage
        is marked on ``mark`` (the session's ``trace`` by default, in a
        call record ``encode_batch`` of B frames), and each kernel stage
        with the kernel's inputs."""
        if len(self.banks) > 1:
            raise NotImplementedError(
                "batch encode with a non-uniform slice geometry: use "
                "encode() (per-shape banks) or a uniform frame size")
        bank = self.banks[0]
        if bank.v4rgb:
            raise NotImplementedError(
                "batch encode with v4 RGB: the per-slice RCT search "
                "re-plans headers per frame; use encode()")
        if bank.golomb:
            raise NotImplementedError(
                "batch encode with Golomb-Rice: the batch is the range "
                "pipeline; use encode()")
        if not frames_list:
            return []
        mark = self.trace if mark is None else mark
        with metrics.span(mark, "encode_batch", len(frames_list)):
            opw, _, steps = bank.batch_ops(frames_list, mark)
            by, ln_h = bank.render_fit(opw, steps, mark)
            by_h = by.cpu().numpy()
            mark("bytes to host")
            S = bank.S
            chunks = [[by_h[b * S + li, :int(ln_h[b * S + li])].tobytes()
                       for li in range(S)] for b in range(len(frames_list))]
            mark("slice bytes")
            pkts = [finish_packet(self.p, range(S), c) for c in chunks]
            mark("slice trailers + CRC")
        return pkts
