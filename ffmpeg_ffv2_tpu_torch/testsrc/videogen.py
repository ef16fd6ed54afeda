"""Copy of ``ffmpeg_ffv2_tpu/testsrc/videogen.py``.

Deterministic synthetic test-video source (vsynth1/vsynth3).

Bit-exact port of the reference's tests/videogen.c + tests/utils.c:
an LCG-driven scene of moving gradient background, a saturated-noise patch,
and ten noisy moving rectangles, converted RGB24 -> yuv420p with the exact
integer coefficients.  Vectorized with numpy; LCG sequences use the closed
form seed_k = A^k * s0 + C_k (mod 2^32).
"""

from __future__ import annotations

import numpy as np

_LCG_A = 314159
_LCG_M = 1 << 32

# precomputed LCG power/offset tables, grown on demand
_pow_a = np.array([1], dtype=np.uint64)
_off_c = np.array([0], dtype=np.uint64)


def _grow_lcg(n: int):
    global _pow_a, _off_c
    while len(_pow_a) < n + 1:
        m = len(_pow_a)
        new_pow = np.empty(2 * m, dtype=np.uint64)
        new_off = np.empty(2 * m, dtype=np.uint64)
        new_pow[:m] = _pow_a
        new_off[:m] = _off_c
        for k in range(m, 2 * m):
            new_pow[k] = (int(new_pow[k - 1]) * _LCG_A) % _LCG_M
            new_off[k] = (int(new_off[k - 1]) * _LCG_A + 1) % _LCG_M
        _pow_a, _off_c = new_pow, new_off


def lcg_sequence(seed: int, n: int) -> np.ndarray:
    """Seeds after 1..n updates of seed = seed*314159 + 1 (mod 2^32)."""
    _grow_lcg(n)
    a = _pow_a[1:n + 1]
    c = _off_c[1:n + 1]
    return ((a * np.uint64(seed)) + c) % np.uint64(_LCG_M)


def myrnd_sequence(seed: int, n_draws: int, n: int) -> np.ndarray:
    seq = lcg_sequence(seed, n_draws)
    if n == 256:
        return (seq >> np.uint64(24)).astype(np.int64)
    return (seq % np.uint64(n)).astype(np.int64)


class _Rng:
    """Scalar stateful view of the same LCG (for the global object seed)."""

    def __init__(self, seed: int = 1):
        self.seed = seed

    def draw(self, n: int) -> int:
        self.seed = (self.seed * _LCG_A + 1) % _LCG_M
        return self.seed >> 24 if n == 256 else self.seed % n


FRAC_BITS = 8
FRAC_ONE = 1 << FRAC_BITS


def _int_cos(a: int) -> int:
    a &= FRAC_ONE - 1
    if a >= FRAC_ONE // 2:
        a = FRAC_ONE - a
    neg = False
    if a > FRAC_ONE // 4:
        neg = True
        a = FRAC_ONE // 2 - a
    v = FRAC_ONE - ((a * a) >> 4)
    return -v if neg else v


NOISE_X, NOISE_Y, NOISE_W = 10, 30, 26
NB_OBJS = 10


def vsynth_rgb_frames(w: int = 352, h: int = 288, n_frames: int = 50):
    """Yield RGB24 frames as uint8 [h][w][3] arrays."""
    rng = _Rng(1)
    objs = []
    rgb = np.zeros((h, w, 3), dtype=np.uint8)

    yy, xx = np.mgrid[0:h, 0:w]
    xs = xx.astype(np.int64) << FRAC_BITS
    ys = yy.astype(np.int64) << FRAC_BITS

    # per-object noise is a fixed sequence (seed = object index)
    obj_noise_cache: dict[tuple[int, int, int], np.ndarray] = {}

    for num in range(n_frames):
        if num == 0:
            objs = []
            for _ in range(NB_OBJS):
                o = {}
                o["x"] = rng.draw(w)
                o["y"] = rng.draw(h)
                o["w"] = rng.draw(w // 4) + 10
                o["h"] = rng.draw(h // 4) + 10
                o["r"] = rng.draw(256)
                o["g"] = rng.draw(256)
                o["b"] = rng.draw(256)
                objs.append(o)

        # moving gradient background
        dx = _int_cos(num * FRAC_ONE // 50) * 35
        dy = _int_cos(num * FRAC_ONE // 50 + FRAC_ONE // 10) * 30
        x1 = xs + dx
        y1 = ys + dy
        rgb[..., 0] = ((y1 * 7) >> FRAC_BITS) & 0xFF
        rgb[..., 1] = (((x1 + y1) * 9) >> FRAC_BITS) & 0xFF
        rgb[..., 2] = ((x1 * 5) >> FRAC_BITS) & 0xFF

        # saturated noise patch; draws are r,g,b per pixel, row-major
        # (put_pixel clips, so crop for frames smaller than the patch)
        noise = myrnd_sequence(num, 3 * NOISE_W * NOISE_W, 256) \
            .reshape(NOISE_W, NOISE_W, 3)
        nh = min(NOISE_W, h - NOISE_Y)
        nw = min(NOISE_W, w - NOISE_X)
        if nh > 0 and nw > 0:
            rgb[NOISE_Y:NOISE_Y + nh, NOISE_X:NOISE_X + nw] = \
                noise[:nh, :nw].astype(np.uint8)

        # moving noisy objects
        for i, o in enumerate(objs):
            key = (i, o["w"], o["h"])
            if key not in obj_noise_cache:
                obj_noise_cache[key] = myrnd_sequence(
                    i, 3 * o["w"] * o["h"], 50).reshape(o["h"], o["w"], 3)
            noise = obj_noise_cache[key]
            base = np.array([o["r"], o["g"], o["b"]], dtype=np.int64)
            block = ((base[None, None] + noise) & 0xFF).astype(np.uint8)
            # clip to the frame (put_pixel drops out-of-range writes)
            x0, y0 = o["x"], o["y"]
            sx0, sy0 = max(0, -x0), max(0, -y0)
            dx0, dy0 = max(0, x0), max(0, y0)
            cw = min(o["w"] - sx0, w - dx0)
            ch = min(o["h"] - sy0, h - dy0)
            if cw > 0 and ch > 0:
                rgb[dy0:dy0 + ch, dx0:dx0 + cw] = \
                    block[sy0:sy0 + ch, sx0:sx0 + cw]
            o["x"] += rng.draw(21) - 10
            o["y"] += rng.draw(21) - 10

        yield rgb.copy()


_FIX = lambda x: int(x * 256 + 0.5)


def rgb24_to_yuv420p(rgb: np.ndarray):
    """Exact integer RGB->YUV420 conversion (tests/utils.c:rgb24_to_yuv420p)."""
    r = rgb[..., 0].astype(np.int64)
    g = rgb[..., 1].astype(np.int64)
    b = rgb[..., 2].astype(np.int64)
    lum = ((_FIX(0.29900) * r + _FIX(0.58700) * g + _FIX(0.11400) * b + 128)
           >> 8).astype(np.uint8)
    r1 = r[0::2, 0::2] + r[0::2, 1::2] + r[1::2, 0::2] + r[1::2, 1::2]
    g1 = g[0::2, 0::2] + g[0::2, 1::2] + g[1::2, 0::2] + g[1::2, 1::2]
    b1 = b[0::2, 0::2] + b[0::2, 1::2] + b[1::2, 0::2] + b[1::2, 1::2]
    cb = (((-_FIX(0.16874) * r1 - _FIX(0.33126) * g1 + _FIX(0.50000) * b1
            + 4 * 128 - 1) >> 10) + 128).astype(np.uint8)
    cr = (((_FIX(0.50000) * r1 - _FIX(0.41869) * g1 - _FIX(0.08131) * b1
            + 4 * 128 - 1) >> 10) + 128).astype(np.uint8)
    return lum, cb, cr


def vsynth1_frames(n_frames: int = 50, w: int = 352, h: int = 288):
    """vsynth1: the standard 352x288x50 yuv420p clip."""
    for rgb in vsynth_rgb_frames(w, h, n_frames):
        yield rgb24_to_yuv420p(rgb)


def vsynth3_frames(n_frames: int = 50, w: int = 34, h: int = 34):
    """vsynth3: the tiny odd-size variant (FATEW x FATEH)."""
    yield from vsynth1_frames(n_frames, w, h)


def save_yuv(path: str, frames):
    with open(path, "wb") as f:
        for y, cb, cr in frames:
            f.write(y.tobytes())
            f.write(cb.tobytes())
            f.write(cr.tobytes())
