"""The frame pool of the FFV1 cells: FATE's vsynth1 source.

A copy of ``ffmpeg_ffv2_tpu_torch/testsrc/videogen.py``, itself FFmpeg's
``tests/videogen.c`` and ``tests/utils.c:rgb24_to_yuv420p``: a moving
gradient background, a 26x26 patch of saturated noise, and ten noisy
rectangles that wander by a random walk, converted RGB24 -> yuv420p with
FFmpeg's integer coefficients.  videogen.c takes the width and height as
arguments; FATE runs it at 352x288 (vsynth1) and 34x34 (vsynth3).

The run's seed picks where in the clip the pool starts: frame
``start + k`` of videogen's one sequence (its objects' sizes, colours and
noise drawn from its own seed, 1), with ``start`` the seed modulo
``STARTS``.  So every seed codes the same kind of content at the same
size, and the seed moves the objects and the background.  The planes are
uint8, as a capture or a raw file hands them over.
"""

from __future__ import annotations

import numpy as np

STARTS = 600            # 24 s of 25 fps: the objects stay in a 1080p frame

_LCG_A = 314159
_LCG_M = 1 << 32
FRAC_BITS = 8
FRAC_ONE = 1 << FRAC_BITS
NOISE_X, NOISE_Y, NOISE_W = 10, 30, 26
NB_OBJS = 10


def lcg_sequence(seed: int, n: int) -> np.ndarray:
    """videogen.c's seeds after 1..n updates of seed = seed * 314159 + 1
    (mod 2^32), from the closed form A^k s0 + (A^(k-1) + ... + 1), the
    tables doubled in NumPy (uint64 products wrap mod 2^64, and 2^32
    divides it)."""
    pw = np.ones(1, np.uint64)          # A^k, k < m
    off = np.zeros(1, np.uint64)        # C_k = A^(k-1) + ... + 1
    a = np.uint64(_LCG_A)
    while len(pw) < n + 1:
        m = len(pw)
        am = (pw[-1] * a) % np.uint64(_LCG_M)                       # A^m
        cm = (off[-1] * a + np.uint64(1)) % np.uint64(_LCG_M)       # C_m
        pw = np.concatenate([pw, (pw * am) % np.uint64(_LCG_M)])
        off = np.concatenate([off, (off + pw[:m] * cm) % np.uint64(_LCG_M)])
    return (pw[1:n + 1] * np.uint64(seed) + off[1:n + 1]) % np.uint64(_LCG_M)


def myrnd_sequence(seed: int, n_draws: int, n: int) -> np.ndarray:
    """n_draws successive ``myrnd(&seed, n)`` values (videogen.c)."""
    seq = lcg_sequence(seed, n_draws)
    if n == 256:
        return (seq >> np.uint64(24)).astype(np.int64)
    return (seq % np.uint64(n)).astype(np.int64)


class _Rng:
    """The scalar LCG of videogen.c's global object seed."""

    def __init__(self, seed: int = 1):
        self.seed = seed

    def draw(self, n: int) -> int:
        self.seed = (self.seed * _LCG_A + 1) % _LCG_M
        return self.seed >> 24 if n == 256 else self.seed % n


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


def rgb_frames(w: int, h: int, start: int, n: int):
    """RGB24 frames ``start`` .. ``start + n - 1`` of videogen's clip at
    w x h, as uint8 (h, w, 3) arrays."""
    rng = _Rng(1)
    objs = []
    for _ in range(NB_OBJS):
        objs.append({k: rng.draw(m) for k, m in
                     (("x", w), ("y", h), ("w", w // 4), ("h", h // 4),
                      ("r", 256), ("g", 256), ("b", 256))})
        objs[-1]["w"] += 10
        objs[-1]["h"] += 10
    noise_of = [(myrnd_sequence(i, 3 * o["w"] * o["h"], 50)
                 .reshape(o["h"], o["w"], 3)
                 + np.array([o["r"], o["g"], o["b"]])) & 0xFF
                for i, o in enumerate(objs)]
    yy, xx = np.mgrid[0:h, 0:w]
    xs, ys = xx << FRAC_BITS, yy << FRAC_BITS
    rgb = np.zeros((h, w, 3), np.uint8)
    for num in range(start + n):
        if num >= start:
            dx = _int_cos(num * FRAC_ONE // 50) * 35
            dy = _int_cos(num * FRAC_ONE // 50 + FRAC_ONE // 10) * 30
            x1, y1 = xs + dx, ys + dy
            rgb[..., 0] = ((y1 * 7) >> FRAC_BITS) & 0xFF
            rgb[..., 1] = (((x1 + y1) * 9) >> FRAC_BITS) & 0xFF
            rgb[..., 2] = ((x1 * 5) >> FRAC_BITS) & 0xFF
            patch = myrnd_sequence(num, 3 * NOISE_W * NOISE_W, 256).reshape(
                NOISE_W, NOISE_W, 3)
            nh, nw = min(NOISE_W, h - NOISE_Y), min(NOISE_W, w - NOISE_X)
            if nh > 0 and nw > 0:
                rgb[NOISE_Y:NOISE_Y + nh, NOISE_X:NOISE_X + nw] = \
                    patch[:nh, :nw]
        for o, noise in zip(objs, noise_of):
            if num >= start:
                # put_pixel drops the writes outside the frame
                x0, y0 = o["x"], o["y"]
                sx0, sy0 = max(0, -x0), max(0, -y0)
                dx0, dy0 = max(0, x0), max(0, y0)
                cw = min(o["w"] - sx0, w - dx0)
                ch = min(o["h"] - sy0, h - dy0)
                if cw > 0 and ch > 0:
                    rgb[dy0:dy0 + ch, dx0:dx0 + cw] = \
                        noise[sy0:sy0 + ch, sx0:sx0 + cw]
            o["x"] += rng.draw(21) - 10
            o["y"] += rng.draw(21) - 10
        if num >= start:
            yield rgb.copy()


def _fix(x: float) -> int:
    return int(x * 256 + 0.5)


def rgb24_to_yuv420p(rgb: np.ndarray) -> list:
    """tests/utils.c:rgb24_to_yuv420p, exact."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    lum = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
           + 128) >> 8
    r1, g1, b1 = (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
                  + c[1::2, 1::2] for c in (r, g, b))
    cb = ((-_fix(0.16874) * r1 - _fix(0.33126) * g1 + _fix(0.50000) * b1
           + 4 * 128 - 1) >> 10) + 128
    cr = ((_fix(0.50000) * r1 - _fix(0.41869) * g1 - _fix(0.08131) * b1
           + 4 * 128 - 1) >> 10) + 128
    return [lum.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)]


def pool(seed: int, n: int, config: dict) -> list:
    """``n`` consecutive yuv420p frames [Y, U, V] of the clip at the
    configuration's size, from the frame that ``seed`` picks."""
    start = seed % STARTS
    return [rgb24_to_yuv420p(f) for f in
            rgb_frames(config["width"], config["height"], start, n)]
