"""The FFV1 context-state walk (adaptation) over chain-grouped cells.

Counterpart of ``ffmpeg_ffv2_tpu/ffv1/device_coder.py:adapt_reference`` and
``repack_emission_order`` and of the TPU kernels of
``ffmpeg_ffv2_tpu/ffv1/adapt_pallas.py:adapt_pallas``: ``_kernel_slotpack``
(K2, ``adapt``) and ``_kernel_emission`` (K6, ``adapt_emission``).  The
wrappers launch ``csrc/adapt.cu`` on CUDA tensors and take their plain
versions on CPU tensors: the row scan ``adapt_plain``; for
``pack_emission`` (the emission_pack kernel, which packs K2's slot words
into emission order where the JAX encoder runs its XLA repack)
``repack_emission_order`` or ``emission_pack`` on the walked rows; for K6
the row scan followed by ``emission_pack`` (``adapt_emission_plain``).  On
the card K6 is K2's walk followed by the emission_pack kernel.

Slot states are kept in PERMUTED row order (host.SLOT_AT_ROW); a cell's
pre-update state values pack into 8 int32 words, word j = slots 4j..4j+3
little-endian.  At coding depths 11..17 (R = code_bits - 10) slots 10 and
31 repeat up to R more times per pixel: R masked sub-steps follow each
cell's base step, and their pre-update pairs sv10 | sv31 << 8 pack two to
a word after the 8 base words (``host.n_sv_words``).  The cell payload's
diff field and valid flag sit where ``host.payload_field`` says.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from . import host
from .symbols import (emission_source, event_count, exponent,
                      lookup_packed, slot_bit_grid)

_K = _build.KERNELS["adapt"]
_K6 = _build.KERNELS["adapt_emission"]
_KP = _build.KERNELS["emission_pack"]
FILLS = ("sign", "zero")     # past a cell's op count: the repack's, K6's


def pack_sv_words(sv_perm):
    """(..., 32, 128) permuted-row sv bytes -> (..., 8, 128) int32 words."""
    return (sv_perm[..., 0:8, :]
            | (sv_perm[..., 8:16, :] << 8)
            | (sv_perm[..., 16:24, :] << 16)
            | (sv_perm[..., 24:32, :] << 24))


def cell_diff(ch1_cells, code_bits: int):
    """The signed diff of each cell's payload field."""
    mask, bias, _ = host.payload_field(code_bits)
    return (ch1_cells & mask) - bias


def repack_emission_order(sv_words, diff, code_bits: int,
                          n_words: int | None = None):
    """Slot-packed sv words (..., n_sv_words, 128) -> emission-order byte
    words (..., Wk, 128): byte k of a cell's output (word k >> 2, byte
    k & 3) is the sv byte its k-th rac op consumes; repeat hits of slots
    10/31 read the repeat-pair words.  ``n_words`` caps Wk (the adaptive
    unsort width; bytes past it are dropped).  As the JAX function does,
    the bytes past a cell's op count repeat its sign byte (nothing reads
    them)."""
    k_max = host.k_max_for_bits(code_bits)
    Wk = (k_max + 3) // 4
    if n_words is not None:
        Wk = min(Wk, n_words)
    W = sv_words.shape[-2]
    e = exponent(diff.abs())
    outs = []
    for m in range(Wk):
        acc = torch.zeros_like(diff)
        for k in range(4 * m, min(4 * m + 4, k_max)):
            if k == 0:
                word = shift = torch.zeros_like(e)
            else:
                mant_i = 2 * e + 1 - k
                slot = torch.where(
                    k <= e, min(k, 10),
                    torch.where(k == e + 1, torch.clamp(e + 1, max=10),
                                torch.where(k <= 2 * e + 1,
                                            22 + torch.clamp(mant_i, max=9),
                                            11 + torch.clamp(e, max=10))))
                word, shift = slot >> 2, (slot & 3) * 8
                if code_bits > 10:
                    h10 = torch.where(k <= e, k - 9, e - 8)
                    h = torch.where(slot == 10, torch.clamp(h10, min=1),
                                    torch.where(slot == 31,
                                                torch.clamp(k - e - 1, min=1),
                                                1))
                    j = h - 1
                    word = torch.where(j == 0, word, 8 + (j - 1) // 2)
                    shift = torch.where(
                        j == 0, shift,
                        ((j - 1) % 2) * 16 + (slot == 31).to(e.dtype) * 8)
            acc = acc | (_byte_at(sv_words, word, shift, W) << ((k & 3) * 8))
        outs.append(acc)
    return torch.stack(outs, dim=-2)


def _byte_at(sv_words, word, shift, W: int):
    """(sv_words[..., word, :] >> shift) & 0xFF per cell, 0 where word is
    past the W words."""
    b = sv_words.gather(-2, word.clamp(0, W - 1).long().unsqueeze(-2))
    return torch.where(word < W, (b.squeeze(-2) >> shift) & 0xFF, 0)


def emission_pack(sv_words, diff, code_bits: int, ev_words: int):
    """What K6 writes, from slot-packed sv words: byte k of a cell's
    emission-order words is the sv byte of its k-th rac op
    (``emission_source``) for k below its op count and below 4 *
    ev_words, and 0 elsewhere (the JAX emission kernel leaves the bytes
    past the op count 0, where ``repack_emission_order`` repeats the sign
    byte)."""
    k_max = host.k_max_for_bits(code_bits)
    word, shift = emission_source(diff, k_max)
    count = event_count(diff)
    W = sv_words.shape[-2]
    outs = []
    for m in range(ev_words):
        acc = torch.zeros_like(diff)
        for k in range(4 * m, min(4 * m + 4, k_max)):
            b = _byte_at(sv_words, word[..., k], shift[..., k], W)
            acc = acc | (torch.where(k < count, b, 0) << ((k & 3) * 8))
        outs.append(acc)
    return torch.stack(outs, dim=-2)


@functools.lru_cache(maxsize=None)
def emission_table(code_bits: int, fill: str) -> torch.Tensor:
    """Where each emission-order byte comes from, (rows, 4 * n_ev_words)
    int32 (read-only, cached): entry [e + 1, k] is the byte index (4 *
    word + byte) into the cell's slot-packed words that byte k of its
    emission-order words copies, or -1 for a 0 byte, for a cell of
    exponent e (-1 for a zero diff, up to the largest the payload field
    holds; the source depends on nothing else).  ``fill`` "sign" follows
    ``repack_emission_order`` (the sign byte repeated past the op count),
    "zero" ``emission_pack``.  Read off the plain function itself, on slot
    words whose bytes hold their own index + 1."""
    if fill not in FILLS:
        raise ValueError(f"emission_table: fill {fill!r} not in {FILLS}")
    W, nev = host.n_sv_words(code_bits), host.n_ev_words(code_bits)
    bias = host.payload_field(code_bits)[1]
    e = torch.arange(-1, bias.bit_length(), dtype=torch.int32)
    diff = torch.where(e < 0, 0, 1 << e.clamp(min=0))[None, :]
    b = torch.arange(4 * W, dtype=torch.int32).reshape(W, 4) + 1
    probe = (b << torch.tensor([0, 8, 16, 24], dtype=torch.int32)).sum(
        1, dtype=torch.int32)
    probe = probe[None, :, None].expand(1, W, diff.shape[1])
    fn = repack_emission_order if fill == "sign" else emission_pack
    ev = fn(probe, diff, code_bits, nev)[0]             # (nev, rows)
    by = (ev[:, None, :] >> (8 * torch.arange(4)[None, :, None])) & 0xFF
    return (by.reshape(4 * nev, -1).T - 1).contiguous()


@functools.lru_cache(maxsize=None)
def source_words(code_bits: int, fill: str, device) -> torch.Tensor:
    """``emission_table`` as the kernel reads it, cached per device:
    (rows, n_ev_words) int32, byte j of word m the source of byte 4m + j,
    with the "zero" source mapped to 4 * n_sv_words (a zero word the
    kernel stages after a cell's slot words)."""
    src = emission_table(code_bits, fill)
    src = torch.where(src < 0, 4 * host.n_sv_words(code_bits), src)
    src = src.reshape(src.shape[0], -1, 4) << torch.tensor(
        [0, 8, 16, 24], dtype=torch.int32)
    return src.sum(-1, dtype=torch.int32).to(device)


def walked_rows(tile_caps, tile_bases) -> int:
    """The walked extent: the end of the last tile with rows (0 if
    none)."""
    return max(torch.where(tile_caps > 0, tile_bases + tile_caps,
                           0).tolist(), default=0)


def pack_emission_plain(sv_words, ch1_cells, tile_caps, tile_bases,
                        code_bits: int, n_words: int, fill: str = "sign"):
    """Plain version of the emission_pack kernel: ``repack_emission_order``
    (fill "sign") or ``emission_pack`` (fill "zero") on the rows up to the
    walked extent, 0 from there on."""
    n = walked_rows(tile_caps, tile_bases)
    fn = repack_emission_order if fill == "sign" else emission_pack
    out = sv_words.new_zeros((sv_words.shape[0], n_words, 128))
    out[:n] = fn(sv_words[:n], cell_diff(ch1_cells[:n], code_bits),
                 code_bits, n_words)
    return out


def pack_emission(sv_words, ch1_cells, tile_caps, tile_bases,
                  code_bits: int, n_words: int, fill: str = "sign"):
    """emission_pack wrapper: K2's slot-packed words (CELLROWS,
    n_sv_words(code_bits), 128) -> emission-order words (CELLROWS,
    n_words, 128) int32, n_words <= n_ev_words(code_bits), rows from the
    walked extent on 0.  Equals ``repack_emission_order`` (fill "sign") on
    K2's output, whose rows no tile walks are 0."""
    cellrows = ch1_cells.shape[0]
    dev = ch1_cells.device
    if not 8 <= code_bits <= 17:
        raise ValueError(f"{_KP.name}: coding depth {code_bits} outside "
                         "8..17")
    if fill not in FILLS:
        raise ValueError(f"{_KP.name}: fill {fill!r} not in {FILLS}")
    if not 1 <= n_words <= host.n_ev_words(code_bits):
        raise ValueError(f"{_KP.name}: n_words {n_words} outside "
                         f"1..{host.n_ev_words(code_bits)}")
    _KP.check("sv_words", sv_words,
              (cellrows, host.n_sv_words(code_bits), 128), dev)
    _KP.check("ch1_cells", ch1_cells, (cellrows, 128), dev)
    tiles = tile_caps.shape[0]
    _KP.check("tile_caps", tile_caps, (tiles,), dev)
    _KP.check("tile_bases", tile_bases, (tiles,), dev)
    if _KP.plain_for(dev):
        return pack_emission_plain(sv_words, ch1_cells, tile_caps,
                                   tile_bases, code_bits, n_words, fill)
    out = torch.empty((cellrows, n_words, 128), dtype=torch.int32,
                      device=dev)
    _KP.launch(sv_words.data_ptr(), ch1_cells.data_ptr(),
               tile_caps.data_ptr(), tile_bases.data_ptr(), tiles, cellrows,
               code_bits, n_words,
               source_words(code_bits, fill, dev).data_ptr(),
               out.data_ptr(), _build.stream_handle(ch1_cells))
    return out


def adapt_plain(ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
                packed_table, code_bits: int = 10, tiles=None):
    """Plain version: a Python loop over the cell rows of each tile on
    (32, 128) state tensors.

    ch1_cells (CELLROWS, 128) int32; s0_blocks (TILES, 33, 128) int32 (32
    permuted slot rows, row 32 = per-lane continuation flag); returns
    (sv (CELLROWS, n_sv_words, 128) int32, ends (TILES, 32, 128) int32),
    zero where no tile walks.  ``tiles`` restricts the walk to the listed
    tile indices (ascending, closed under tile_pred), for a cut
    comparison."""
    dev = ch1_cells.device
    i32 = torch.int32
    R = max(0, code_bits - 10)
    mask, bias, vbit = host.payload_field(code_bits)
    r10, r31 = int(host.ROW_OF_SLOT[10]), int(host.ROW_OF_SLOT[31])
    caps = tile_caps.tolist()
    bases = tile_bases.tolist()
    preds = tile_pred.tolist()
    sv = torch.zeros((ch1_cells.shape[0], host.n_sv_words(code_bits), 128),
                     dtype=i32, device=dev)
    ends = torch.zeros((len(caps), 32, 128), dtype=i32, device=dev)
    perm = torch.as_tensor(host.SLOT_AT_ROW, device=dev).long()
    table = packed_table.reshape(128)
    for t in (range(len(caps)) if tiles is None else tiles):
        cap, base, pred = caps[t], bases[t], preds[t]
        if cap <= 0:
            continue
        if pred >= 0:
            cont = (s0_blocks[t, 32] > 0)[None, :]
            s = torch.where(cont, ends[pred], s0_blocks[t, :32])
        else:
            s = s0_blocks[t, :32].clone()
        for row in range(base, base + cap):
            r = ch1_cells[row]
            v = (r & mask) - bias
            ok = ((r >> vbit) & 1) == 1
            valid, bit = slot_bit_grid(v)            # (128, 32) slot order
            valid = (valid & ok[:, None])[:, perm].T
            bit = bit[:, perm].T
            out = [pack_sv_words(torch.where(valid, s, 0))]
            s = torch.where(valid, lookup_packed(table, bit * 256 + s), s)
            if R:
                # repeat hits of slots 10/31 (e > 9): sub-step j is hit j+1
                a = v.abs()
                e = exponent(a)
                pairs = []
                for j in range(1, R + 1):
                    v10 = ok & (e >= 9 + j)
                    v31 = ok & (e >= 10 + j)
                    b10 = (e >= j + 10).to(i32)
                    b31 = (a >> torch.clamp(e - 1 - j, min=0)) & 1
                    pairs.append(torch.where(v10, s[r10], 0)
                                 | (torch.where(v31, s[r31], 0) << 8))
                    s = s.clone()
                    s[r10] = torch.where(
                        v10, lookup_packed(table, b10 * 256 + s[r10]), s[r10])
                    s[r31] = torch.where(
                        v31, lookup_packed(table, b31 * 256 + s[r31]), s[r31])
                if R % 2:
                    pairs.append(torch.zeros_like(pairs[0]))
                out.append(torch.stack([pairs[2 * w] | (pairs[2 * w + 1] << 16)
                                        for w in range(len(pairs) // 2)]))
            sv[row] = torch.cat(out)
        ends[t] = s
    return sv, ends


def adapt_emission_plain(ch1_cells, tile_caps, tile_bases, tile_pred,
                         s0_blocks, packed_table, code_bits: int,
                         ev_words: int, tiles=None):
    """Plain version of K6: the row scan, then ``emission_pack`` on the
    rows the tiles cover (the others stay 0, as the kernel leaves them).
    Returns (ev (CELLROWS, ev_words, 128), ends (TILES, 32, 128)) int32."""
    sv, ends = adapt_plain(ch1_cells, tile_caps, tile_bases, tile_pred,
                           s0_blocks, packed_table, code_bits, tiles)
    return pack_emission_plain(sv, ch1_cells, tile_caps, tile_bases,
                               code_bits, ev_words, "zero"), ends


def successors(tile_pred):
    """The successor of each tile (tile_pred inverted, -1 for none), built
    on the device; the spare slot past the tiles absorbs the root tiles'
    writes.  K2, K5 and K6 walk a split group's tiles through it."""
    tiles = tile_pred.shape[0]
    tidx = torch.arange(tiles, dtype=torch.int32, device=tile_pred.device)
    succ = torch.full((tiles + 1,), -1, dtype=torch.int32,
                      device=tile_pred.device)
    succ.scatter_(0, torch.where(tile_pred >= 0, tile_pred, tiles).long(),
                  tidx)
    return succ[:tiles].contiguous()


def _check(k, ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
           packed_table, code_bits: int):
    if not 8 <= code_bits <= 17:
        raise ValueError(f"{k.name}: coding depth {code_bits} outside 8..17")
    dev = ch1_cells.device
    tiles = tile_caps.shape[0]
    k.check("ch1_cells", ch1_cells, (ch1_cells.shape[0], 128), dev)
    for name, t in (("tile_caps", tile_caps), ("tile_bases", tile_bases),
                    ("tile_pred", tile_pred)):
        k.check(name, t, (tiles,), dev)
    k.check("s0_blocks", s0_blocks, (tiles, 33, 128), dev)
    k.check("packed_table", packed_table, (128,), dev)


def adapt(ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
          packed_table, code_bits: int):
    """K2 wrapper: (sv (CELLROWS, n_sv_words(code_bits), 128), ends
    (TILES, 32, 128)) int32."""
    _check(_K, ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
           packed_table, code_bits)
    dev = ch1_cells.device
    if _K.plain_for(dev):
        return adapt_plain(ch1_cells, tile_caps, tile_bases, tile_pred,
                           s0_blocks, packed_table, code_bits)
    cellrows = ch1_cells.shape[0]
    tiles = tile_caps.shape[0]
    succ = successors(tile_pred)
    sv = torch.zeros((cellrows, host.n_sv_words(code_bits), 128),
                     dtype=torch.int32, device=dev)
    ends = torch.zeros((tiles, 32, 128), dtype=torch.int32, device=dev)
    _K.launch(ch1_cells.data_ptr(), tile_caps.data_ptr(),
              tile_bases.data_ptr(), tile_pred.data_ptr(), succ.data_ptr(),
              s0_blocks.data_ptr(), packed_table.data_ptr(), tiles, cellrows,
              code_bits, sv.data_ptr(), ends.data_ptr(),
              _build.stream_handle(ch1_cells))
    return sv, ends


def adapt_emission(ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
                   packed_table, code_bits: int, ev_words: int):
    """K6 wrapper: the walk with each cell's sv bytes packed at their
    emission positions (on the card: K2's walk into a scratch of slot
    words, then the emission_pack kernel with the zero fill, in one
    launcher call on the stream).  Returns (ev (CELLROWS, ev_words, 128),
    ends (TILES, 32, 128)) int32, ev_words <= n_ev_words(code_bits); bytes
    past ev_words words are dropped."""
    _check(_K6, ch1_cells, tile_caps, tile_bases, tile_pred, s0_blocks,
           packed_table, code_bits)
    if not 1 <= ev_words <= host.n_ev_words(code_bits):
        raise ValueError(f"adapt_emission: ev_words {ev_words} outside "
                         f"1..{host.n_ev_words(code_bits)}")
    dev = ch1_cells.device
    if _K6.plain_for(dev):
        return adapt_emission_plain(ch1_cells, tile_caps, tile_bases,
                                    tile_pred, s0_blocks, packed_table,
                                    code_bits, ev_words)
    cellrows = ch1_cells.shape[0]
    tiles = tile_caps.shape[0]
    succ = successors(tile_pred)
    # the walk leaves the rows no tile walks 0, as K2's wrapper has them
    sv = torch.zeros((cellrows, host.n_sv_words(code_bits), 128),
                     dtype=torch.int32, device=dev)
    ev = torch.empty((cellrows, ev_words, 128), dtype=torch.int32,
                     device=dev)
    ends = torch.zeros((tiles, 32, 128), dtype=torch.int32, device=dev)
    _K6.launch(ch1_cells.data_ptr(), tile_caps.data_ptr(),
               tile_bases.data_ptr(), tile_pred.data_ptr(), succ.data_ptr(),
               s0_blocks.data_ptr(), packed_table.data_ptr(), tiles,
               cellrows, code_bits, ev_words,
               source_words(code_bits, "zero", dev).data_ptr(),
               sv.data_ptr(), ev.data_ptr(), ends.data_ptr(),
               _build.stream_handle(ch1_cells))
    return ev, ends
