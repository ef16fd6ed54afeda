"""The emission_pack kernel's source table and a plain-torch model of its
per-cell loop, on the CPU, against the port's and the JAX package's
``repack_emission_order`` (the sign byte repeated past a cell's op count)
and against ``emission_pack`` (0 there, as the JAX emission kernel writes):
every coding depth 8..17, every exponent the payload field holds (diff 0
and the depth's largest included), Wk full, 2 and 3, on random slot words
and on a small yuv420p frame's real K2 output; rows from the walked extent
on come out 0.  Inputs are made from seeded numpy; every comparison is
exact (bit for bit)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ffmpeg_ffv2_tpu.ffv1 import device_coder as jdc
from ffmpeg_ffv2_tpu_torch import _build
from ffmpeg_ffv2_tpu_torch.ffv1 import adapt as ad
from ffmpeg_ffv2_tpu_torch.ffv1 import host
from ffmpeg_ffv2_tpu_torch.ffv1 import symbols
from test_torch_device_coder import _tplan, np_, stages, t_  # noqa: F401
from test_torch_formats import torch_one_thread  # noqa: F401

BITS = range(8, 18)


def _below_count(words, diff):
    """Emission-order words with the bytes at or past each cell's op count
    zeroed (numpy): the JAX repack with the emission kernel's fill."""
    e = np.floor(np.log2(np.maximum(np.abs(diff), 1))).astype(np.int64)
    count = np.where(diff == 0, 1, 2 * e + 3)
    out = words.astype(np.int64) & 0xFFFFFFFF
    for m in range(words.shape[-2]):
        keep = np.clip(count - 4 * m, 0, 4)
        out[..., m, :] &= (1 << (8 * keep)) - 1
    return out.astype(np.uint32).view(np.int32)


def jax_pack(sv, diff, bits, n_words, fill):
    """The JAX side: repack_emission_order, zeroed past the op count for
    the zero fill."""
    ref = np.asarray(jdc.repack_emission_order(jnp.asarray(sv),
                                               jnp.asarray(diff), bits,
                                               n_words))
    return ref if fill == "sign" else _below_count(ref, np.asarray(diff))


def model(sv, ch1c, tile_caps, tile_bases, bits, n_words, fill):
    """The kernel's per-cell loop, in plain torch: stage the cell's slot
    words and a zero word, look its exponent's row up in the kernel's
    source words (``adapt.source_words``), and assemble each output word
    from the four bytes its table word names; rows from the walked extent
    on are 0."""
    rows = ch1c.shape[0]
    src = ad.source_words(bits, fill, "cpu")
    shift = torch.tensor([0, 8, 16, 24], dtype=torch.int32)
    src_bytes = ((src[:, :n_words, None] >> shift) & 0xFF).reshape(
        src.shape[0], 4 * n_words).long()
    staged = torch.cat([sv, sv.new_zeros((rows, 1, 128))], dim=1)
    by = ((staged[:, :, None, :] >> shift[None, None, :, None])
          & 0xFF).reshape(rows, -1, 128)
    mask, bias, _ = host.payload_field(bits)
    e = symbols.exponent(((ch1c & mask) - bias).abs())
    idx = src_bytes[(e + 1).long()].permute(0, 2, 1)      # (rows, 4nw, 128)
    got = by.gather(1, idx).reshape(rows, n_words, 4, 128)
    out = (got << shift[None, None, :, None]).sum(2, dtype=torch.int32)
    out[ad.walked_rows(tile_caps, tile_bases):] = 0
    return out


def _n_words(bits, n_words):
    return host.n_ev_words(bits) if n_words == "full" else n_words


@pytest.mark.parametrize("fill", ad.FILLS)
@pytest.mark.parametrize("bits", BITS)
def test_torch_emission_table(bits, fill):
    """The source table: one row an exponent e = -1 (diff 0) .. the
    largest the payload field holds.  Sign fill: equal to the JAX repack
    read off the same probe words on every row.  Zero fill: the port's and
    JAX's emission_source below the op count (-1 where it names a word
    past the slot words) and -1 from there on, on every row; on the rows
    of the depth's exponents (e < bits) also the JAX repack zeroed past
    the op count.  (Above the depth, at depths up to 10, emission_source
    reads slot 10's repeat words, which those depths do not have, where
    the repack reads the base word; such a cell is not valid and its slot
    words are 0.)"""
    tab = np_(ad.emission_table(bits, fill))
    W, nev = host.n_sv_words(bits), host.n_ev_words(bits)
    k_max = host.k_max_for_bits(bits)
    bias = host.payload_field(bits)[1]
    assert tab.shape == (bias.bit_length() + 1, 4 * nev)
    assert tab.min() >= -1 and tab.max() < 4 * W
    assert (tab[:, k_max:] == -1).all()
    e = np.arange(-1, bias.bit_length())
    diff = np.where(e < 0, 0, 1 << np.maximum(e, 0)).astype(np.int32)
    probe = np.broadcast_to(
        (np.arange(4 * W).reshape(W, 4) + 1
         << np.array([0, 8, 16, 24])).sum(1).astype(np.int32)[None, :, None],
        (1, W, diff.size))
    ref = jax_pack(probe, diff[None], bits, nev, fill)[0]      # (nev, rows)
    ref_tab = (((ref[:, None, :] >> (8 * np.arange(4))[None, :, None])
                & 0xFF).reshape(4 * nev, -1).T - 1)
    depth = e < bits
    assert np.array_equal(tab[depth], ref_tab[depth])
    if fill == "sign":
        assert np.array_equal(tab, ref_tab)
        return
    count = np.minimum(np.where(diff == 0, 1, 2 * e + 3), k_max)
    for word, sh in ((np_(a), np_(b)) for a, b in (
            symbols.emission_source(t_(diff), k_max),
            jdc.emission_source(jnp.asarray(diff), k_max))):
        src = np.where(word < W, 4 * word + sh // 8, -1)
        for r in range(len(e)):
            assert np.array_equal(tab[r, :count[r]], src[r, :count[r]]), e[r]
            assert (tab[r, count[r]:] == -1).all(), e[r]


@pytest.mark.parametrize("n_words", ["full", 2, 3])
@pytest.mark.parametrize("bits", BITS)
def test_torch_emission_pack_random_words(bits, n_words):
    """Random slot words (repeat-pair words included) and payload fields
    over the whole field (every exponent it holds, diff 0, the depth's
    largest), on tiles that end 5 rows before the cells do: the model,
    the wrapper's CPU path and the plain functions equal the port's
    repack (sign fill) and emission_pack (zero fill) on the walked rows,
    and 0 past them; and JAX's repack (as is, and zeroed past the op count
    on the cells of the depth's exponents)."""
    rng = np.random.RandomState(bits * 7 + (0 if n_words == "full"
                                            else n_words))
    nw = _n_words(bits, n_words)
    mask, bias, vbit = host.payload_field(bits)
    rows, W = 12, host.n_sv_words(bits)
    half = 1 << (bits - 1)
    diff = rng.randint(-half, half, (rows, 128))
    diff[0, :40] = rng.randint(-8, 9, 40)
    diff[1, :18] = [0, half - 1, -half, 1, -1] + list(
        (1 << np.arange(13)) * rng.choice([-1, 1], 13))
    diff[2] = rng.randint(-bias, mask - bias + 1, 128)   # the whole field
    ch1 = ((diff + bias) & mask) | (rng.randint(0, 2, (rows, 128)) << vbit)
    sv = rng.randint(-2 ** 31, 2 ** 31 - 1, (rows, W, 128),
                     dtype=np.int64).astype(np.int32)
    caps = np.array([4, 0, 3], np.int32)
    bases = np.array([0, 9, 4], np.int32)               # walked extent 7
    k = (t_(sv), t_(ch1.astype(np.int32)), t_(caps), t_(bases), bits, nw)
    n = ad.walked_rows(k[2], k[3])
    assert n == 7
    diff_c = ad.cell_diff(k[1], bits)
    depth = np_(symbols.exponent(diff_c.abs()))[:n] < bits
    for fill in ad.FILLS:
        got = model(*k, fill)
        ref = jax_pack(sv[:n], np_(diff_c)[:n], bits, nw, fill)
        if fill == "sign":
            assert np.array_equal(np_(got)[:n], ref)
        else:       # the zero fill's JAX side holds on the depth's cells
            assert np.array_equal(np_(got)[:n].transpose(0, 2, 1)[depth],
                                  ref.transpose(0, 2, 1)[depth])
        assert (got[n:] == 0).all()
        plain = (ad.repack_emission_order(k[0][:n], diff_c[:n], bits, nw)
                 if fill == "sign" else
                 ad.emission_pack(k[0][:n], diff_c[:n], bits, nw))
        assert torch.equal(got[:n], plain)
        _build.reset_counts()
        assert torch.equal(ad.pack_emission(*k, fill), got)
        assert _build.KERNELS["emission_pack"].plain_calls == 1
        assert torch.equal(ad.pack_emission_plain(*k, fill), got)


@pytest.mark.parametrize("n_words", ["full", 2, 3])
def test_torch_emission_pack_frame(stages, n_words):
    """On the real K2 output (JAX adapt_reference) of a small yuv420p
    frame, at GCAP 4096 and 64 (split tiles): the model and the wrapper's
    CPU path equal the JAX repack over every row of the cells (those past
    the walked extent are 0 in both), and emission_pack's fill below the
    op count; the plain encoder stage ``adapt`` runs the wrapper."""
    nw = _n_words(8, n_words)
    plan = _tplan(stages)
    k = (t_(stages["sv"]), t_(stages["ch1c"]), plan["tile_caps"],
         plan["tile_bases"], 8, nw)
    n = ad.walked_rows(k[2], k[3])
    assert 0 < n < k[1].shape[0]
    for fill in ad.FILLS:
        ref = jax_pack(stages["sv"], stages["diff_c"], 8, nw, fill)
        assert (ref[n:] == 0).all()
        assert np.array_equal(np_(model(*k, fill)), ref), fill
        assert np.array_equal(np_(ad.pack_emission(*k, fill)), ref), fill


def test_torch_emission_pack_checks():
    """The wrapper refuses a depth, a fill or a width it does not take,
    and a slot-word tensor of another depth."""
    sv = torch.zeros((4, 8, 128), dtype=torch.int32)
    ch1 = torch.zeros((4, 128), dtype=torch.int32)
    caps = torch.tensor([4], dtype=torch.int32)
    bases = torch.tensor([0], dtype=torch.int32)
    for bits, nw, fill in ((18, 2, "sign"), (8, 2, "copy"), (8, 0, "sign"),
                           (8, 6, "sign"), (12, 2, "sign")):
        with pytest.raises(ValueError):
            ad.pack_emission(sv, ch1, caps, bases, bits, nw, fill)
    assert ad.walked_rows(torch.tensor([0, 0], dtype=torch.int32),
                          torch.tensor([5, 9], dtype=torch.int32)) == 0
