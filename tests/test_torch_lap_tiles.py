"""K19's tile table (``ffmpeg_ffv2_tpu_torch/ffv2/device.py:lap_tiles``),
the exact geometry that ``csrc/ffv2_lap.cu`` runs, on the CPU.

The table covers the union of the slabs that its mode filters exactly
once, and each tile keeps its kernel's shape limits.  Walking it tile by
tile in table order with ``lap_slab_plain`` (a band tile's horizontal
lift on its first 32 columns then the vertical lift on every column for
the prefilter, the reverse for the postfilter; a row tile's horizontal
lift alone) equals ``lap_frame`` / ``lap_dir`` on the CPU and the JAX
module's ``_jx_frame_hor`` / ``_jx_frame_ver`` (``ffv2/tpu.py:122-150``),
exactly, on Q12 content and on hostile int32 with INT_MIN and INT_MAX."""

import numpy as np
import pytest
import torch

from ffmpeg_ffv2_tpu.ffv2 import tpu as jtpu
from ffmpeg_ffv2_tpu_torch.ffv2 import device as dv
from test_torch_formats import torch_one_thread  # noqa: F401

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
R = dv.LAP_RADIUS

# (P, H, W, sb, mode): sb 32, 64 and 128; a 1080p yuv444p frame padded to
# 1088 x 1920 cut to 4 SB rows; a ragged last piece (W = 250); the 3840-
# wide band of a rank of the sharded 2160p front (cut to 3 SB rows where
# its values are compared), both one-direction modes; the halo slab
CASES = [
    (2, 128, 192, 32, "frame"),
    (3, 192, 320, 64, "frame"),
    (3, 256, 1920, 64, "frame"),
    (1, 192, 250, 64, "frame"),
    (2, 384, 640, 128, "frame"),
    (1, 192, 3840, 64, "hor"),
    (1, 192, 3840, 64, "ver"),
    (3, 192, 216, 64, "hor"),
    (3, 192, 216, 64, "ver"),
    (2, 32, 96, 16, "ver"),
    (2, 96, 32, 16, "hor"),
]
GEOMETRY = [(H, W, sb, mode) for _, H, W, sb, mode in CASES] + [
    (1088, 1920, 64, "frame"), (1088, 3840, 64, "hor"),
    (1088, 3840, 64, "ver"), (2176, 3840, 64, "frame"),
    (64, 64, 64, "frame"), (32, 32, 16, "frame"), (40, 8, 64, "frame")]


def _union(H, W, sb, mode):
    """The words that ``mode``'s slabs cover."""
    h = R // 2
    m = np.zeros((H, W), bool)
    if mode != "ver":
        for b in range(sb, W, sb):
            m[:, b - h:b + h] = True
    if mode != "hor":
        for b in range(sb, H, sb):
            m[b - h:b + h] = True
    return m


@pytest.mark.parametrize("H,W,sb,mode", GEOMETRY)
def test_torch_lap_tiles_cover_the_slabs_once(H, W, sb, mode):
    tab = dv.lap_tiles(H, W, sb, mode)
    assert tab.dtype == np.int32 and tab.shape[1] == 5
    assert not tab.flags.writeable and dv.lap_tiles(H, W, sb, mode) is tab
    h = R // 2
    xs = [b - h for b in range(sb, W, sb)] if mode != "ver" else []
    ys = [b - h for b in range(sb, H, sb)] if mode != "hor" else []
    seen = np.zeros((H, W), np.int64)
    for y0, x0, th, tw, role in tab.tolist():
        assert role in (dv.LAP_ROLE_H, dv.LAP_ROLE_V,
                        dv.LAP_ROLE_H | dv.LAP_ROLE_V)
        assert 0 <= y0 and y0 + th <= H and 0 <= x0 and x0 + tw <= W
        if role & dv.LAP_ROLE_V:             # a band tile
            assert th == R and y0 in ys and 0 < tw <= 64
        else:                                # a row tile
            assert tw == R and 0 < th <= 64
        if role & dv.LAP_ROLE_H:             # starts with a vertical slab
            assert x0 in xs and tw >= R
        seen[y0:y0 + th, x0:x0 + tw] += 1
    assert np.array_equal(seen, _union(H, W, sb, mode).astype(np.int64))
    # every vertical slab's columns of a band start a tile of the band
    for y in ys:
        starts = {x0 for y0, x0, _, _, role in tab.tolist()
                  if y0 == y and role & dv.LAP_ROLE_H}
        assert starts == set(xs)


def _walk(c: torch.Tensor, sb: int, forward: bool, mode: str):
    """The kernel's order on the CPU: each tile of ``lap_tiles`` in table
    order, lifted by ``lap_slab_plain`` on a copy of its own words and
    written back."""
    for y0, x0, th, tw, role in dv.lap_tiles(*c.shape[1:], sb, mode).tolist():
        t = c[:, y0:y0 + th, x0:x0 + tw].clone()
        steps = [role & dv.LAP_ROLE_H, role & dv.LAP_ROLE_V]
        for vertical, on in ((False, steps[0]), (True, steps[1]))[
                ::1 if forward else -1]:
            if not on:
                continue
            if vertical:
                t = dv.lap_slab_plain(t.transpose(1, 2), forward).transpose(
                    1, 2)
            else:
                t[:, :, :R] = dv.lap_slab_plain(t[:, :, :R], forward)
        c[:, y0:y0 + th, x0:x0 + tw] = t
    return c


def _jax(x: np.ndarray, sb: int, forward: bool, mode: str) -> np.ndarray:
    a = jtpu.jnp.asarray(x)
    dirs = {"frame": (jtpu._jx_frame_hor, jtpu._jx_frame_ver),
            "hor": (jtpu._jx_frame_hor,), "ver": (jtpu._jx_frame_ver,)}[mode]
    for fn in dirs if forward else dirs[::-1]:
        a = fn(a, sb, R, forward)
    return np.asarray(a)


def _content(P, H, W, kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "q12":
        return rng.randint(-2600, 2600, (P, H, W)).astype(np.int32)
    x = rng.randint(I32_MIN, I32_MAX + 1, (P, H, W), dtype=np.int64).astype(
        np.int32)
    x[0, :3] = I32_MIN
    x[-1, -3:] = I32_MAX
    x[:, :, 1::7] = I32_MIN
    x[:, 2::5] = I32_MAX
    return x


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("P,H,W,sb,mode", CASES)
def test_torch_lap_tiles_walk_matches_lap_and_jax(P, H, W, sb, mode,
                                                  forward):
    for kind in ("q12", "hostile"):
        x = _content(P, H, W, kind, H + W + sb + forward)
        got = _walk(torch.tensor(x), sb, forward, mode)
        c = torch.tensor(x)
        if mode == "frame":
            want = dv.lap_frame(c, sb, forward)
        else:
            want = dv.lap_dir(c, sb, forward, mode == "ver")
        assert torch.equal(got, want), kind
        assert np.array_equal(got.numpy(), _jax(x, sb, forward, mode)), kind
        assert not np.array_equal(got.numpy(), x)


@pytest.mark.parametrize("H,W,sb,mode,match", [
    (64, 64, 16, "frame", "overlap"),          # two boundaries at sb 16
    (96, 32, 16, "ver", "overlap"),
    (40, 8, 32, "ver", "leaves the extent"),   # 32 + 16 > 40
    (64, 200, 64, "frame", "leaves the extent"),
    (64, 64, 64, "both", "mode"),
])
def test_torch_lap_tiles_refuse_overlap_and_overhang(H, W, sb, mode, match):
    with pytest.raises(ValueError, match=match):
        dv.lap_tiles(H, W, sb, mode)


def test_torch_lap_tiles_of_no_boundary_are_empty():
    """A plane no boundary crosses (W, H <= sb) has no tile: no launch."""
    assert dv.lap_tiles(64, 64, 64, "frame").shape == (0, 5)
    assert dv.lap_tiles(40, 8, 64, "hor").shape == (0, 5)
    # one direction crossed: its slab's tiles only
    tab = dv.lap_tiles(128, 64, 64, "frame")
    assert set(tab[:, 4].tolist()) == {dv.LAP_ROLE_V}
