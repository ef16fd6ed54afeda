"""Copy of ``ffmpeg_ffv2_tpu/ffv1/rct.py``: the per-slice reversible-color-
transform coefficient search of version 4, the scalar oracle of the device
search (``phase_a.rct_costs``).

ffv1enc.c:choose_rct_params — evaluates 15 (by, ry) candidates on second
differences of the slice and picks the one minimizing the L1 cost.
Vectorized with numpy (the reference loops per pixel).
"""

from __future__ import annotations

import numpy as np

RCT_Y_COEFF = [
    (0, 0), (1, 1), (2, 2), (0, 2), (2, 0), (4, 0), (0, 4),
    (0, 3), (3, 0), (3, 1), (1, 3), (1, 2), (2, 1), (0, 1), (1, 0),
]


def choose_rct_params(planes: list[np.ndarray], bits: int) -> tuple[int, int]:
    """planes = [g, b, r, ...] int arrays of one slice; returns (by, ry)."""
    g = planes[0].astype(np.int64)
    b = planes[1].astype(np.int64)
    r = planes[2].astype(np.int64)
    h, w = g.shape
    if h < 2 or w < 2:
        return 1, 1

    # horizontal first differences (ar/ag/ab in the reference)
    def hdiff(p):
        d = np.zeros_like(p)
        d[:, 0] = p[:, 0]          # lastr/g/b start at 0 per row
        d[:, 1:] = p[:, 1:] - p[:, :-1]
        return d

    ag, ab, ar = hdiff(g), hdiff(b), hdiff(r)
    # second difference vs the previous row's first difference, for x>=1,y>=1
    bg = ag[1:, 1:] - ag[:-1, 1:]
    bb = ab[1:, 1:] - ab[:-1, 1:]
    br = ar[1:, 1:] - ar[:-1, 1:]
    br = br - bg
    bb = bb - bg

    stats = [int(np.abs(bg + ((br * ry + bb * by) >> 2)).sum())
             for (ry, by) in RCT_Y_COEFF]
    best = 0
    for i in range(1, len(RCT_Y_COEFF)):
        if stats[i] < stats[best]:
            best = i
    ry, by = RCT_Y_COEFF[best]
    return by, ry
