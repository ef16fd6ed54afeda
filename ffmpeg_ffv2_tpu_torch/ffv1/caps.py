"""A shape bank's caps, and the one loop that fits them to a frame.

A buffer whose need depends on the content is allocated at a cap: the
layout's tiles and cell rows, K3's op words a slice and the unsort width,
K4's render buffer, Golomb-Rice's ladder events and bitstream words.  A
cap starts at a content-typical size and grows, on ``host.quantize_cap``
rungs up to its worst case, when a frame misses it; the frame then runs
again (``fit``).  The bytes do not depend on the caps.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils import metrics
from . import host


@dataclass
class Caps:
    """Caps and their worst-case bounds: a bank's (its coder's fields set,
    the others 0), or the layout caps of a batch's B x S slices.  Each
    ``fits_*`` says whether a frame's sizes fit and grows the caps that
    they miss to the measured need (+slack)."""
    tiles_cap: int
    cellrows_cap: int
    tiles_max: int
    cellrows_max: int
    op_cap: int = 0
    op_cap_max: int = 0
    unsort_words: int = 0       # emission-order words through the unsort
    unsort_max: int = 0
    render_cap: int = 0
    render_cap_max: int = 0
    shrinks: int = 2            # op_cap tightenings left
    ev_cap: int = 0
    ev_cap_max: int = 0
    nwords: int = 0
    nwords_max: int = 0

    @classmethod
    def layout(cls, npix: int, n_slices: int, rows_per_slice: int) -> Caps:
        """The layout caps of ``n_slices`` slices of ``npix`` pixels."""
        gcap = host.GCAP
        n = n_slices * npix
        chains = n_slices * rows_per_slice
        n_buckets = npix // gcap + 2
        tiles_max = n // gcap + 2 * n_buckets + chains // 128 + 8
        cellrows_max = n // 128 + (n_buckets + 2) * gcap + tiles_max + 128
        return cls(host.quantize_cap(n // gcap + chains // 128 + 72,
                                     tiles_max),
                   host.quantize_cap(n // 128 * 5 // 4 + 2 * gcap + 256,
                                     cellrows_max),
                   tiles_max, cellrows_max)

    @classmethod
    def range(cls, npix: int, n_slices: int, rows_per_slice: int,
              hmax: int, code_bits: int) -> Caps:
        """A range bank's caps; ``hmax``: its prefix ops' width."""
        c = cls.layout(npix, n_slices, rows_per_slice)
        c.op_cap_max = -(-(npix * host.k_max_for_bits(code_bits) + hmax + 8)
                         // host.OP_GRAN) * host.OP_GRAN
        c.op_cap = host.quantize_cap(npix * 4 + hmax + 1024, c.op_cap_max,
                                     host.OP_GRAN)
        c.render_cap_max = c.op_cap_max + 16
        c.render_cap = host.quantize_cap(npix + 4096, c.render_cap_max, 4096)
        # 2 words = 8 ops covers |diff| <= 7; grows to the content's
        # ceil(maxops / 4)
        c.unsort_max = host.n_ev_words(code_bits)
        c.unsort_words = min(2, c.unsort_max)
        return c

    @classmethod
    def rice(cls, npix: int, n_slices: int, rows_per_slice: int,
             nlines: int, bits: int) -> Caps:
        """A Golomb-Rice bank's caps; ``nlines``: its plane lines a slice."""
        c = cls.layout(npix, n_slices, rows_per_slice)
        c.ev_cap_max = npix + nlines + 8
        c.ev_cap = host.quantize_cap(npix // 4 + 1024, c.ev_cap_max)
        # worst element: the escape (11 ones + 1 + bits value bits) plus
        # the run and ladder elements
        c.nwords_max = npix * 3 * max(25, bits + 13) // 32 + 8
        c.nwords = host.quantize_cap(npix // 16 * 8 + 256, c.nwords_max, 8)
        return c

    def fits_layout(self, rows: int, tiles: int, slots: int) -> bool:
        if (rows + 1024 <= self.cellrows_cap and tiles <= self.tiles_cap
                and slots <= self.tiles_cap * 128):
            return True
        self.tiles_cap = host.quantize_cap(
            max(tiles + 64, self.tiles_cap + 1), self.tiles_max)
        self.cellrows_cap = host.quantize_cap(
            max(rows + 2048, self.cellrows_cap + 1), self.cellrows_max)
        return False

    def fits_ops(self, opmax: int, maxc: int) -> bool:
        fits = opmax <= self.op_cap and maxc <= 4 * self.unsort_words
        if opmax > self.op_cap:
            self.op_cap = host.quantize_cap(opmax + 512, self.op_cap_max,
                                            host.OP_GRAN)
        if maxc > 4 * self.unsort_words:
            self.unsort_words = min(self.unsort_max, (maxc + 3) // 4)
        return fits

    def fits_rice(self, n_lad: int, nbits) -> bool:
        top = max(nbits)
        fits = n_lad <= self.ev_cap and top <= self.nwords * 32
        if n_lad > self.ev_cap:
            self.ev_cap = host.quantize_cap(n_lad + 512, self.ev_cap_max)
        if top > self.nwords * 32:
            self.nwords = host.quantize_cap(top // 32 + 256, self.nwords_max,
                                            8)
        return fits

    def fits_render(self, lengths) -> bool:
        top = int(max(lengths))
        if top <= self.render_cap:
            return True
        self.render_cap = host.quantize_cap(
            max(top + 4096, self.render_cap + 1), self.render_cap_max, 4096)
        return False

    def shrink_ops(self, opmax: int):
        """Tighten a fat op domain to the content's measured scale (+25 %),
        at most ``shrinks`` times, so that the caps settle."""
        tight = host.quantize_cap(opmax * 5 // 4 + 512, self.op_cap_max,
                                  host.OP_GRAN)
        if self.shrinks > 0 and tight < self.op_cap:
            self.shrinks -= 1
            self.op_cap = tight


def fit(run, fits, mark, tries: int = 8,
        stage: str = "sizes to host",
        error: str = "device layout exceeded worst-case caps"):
    """The cap-fit loop: ``run()`` (an attempt -> its outputs and sizes on
    the device), a read of the sizes (marked ``stage``), ``fits(sizes)``
    (which grows the caps they miss); a miss counts a retry on ``mark``,
    and after ``tries`` misses raises RuntimeError(``error``).  Returns
    (the attempt that fit, its outputs, its sizes as a list)."""
    for attempt in range(tries):
        out, sizes = run()
        sizes = sizes.tolist()
        mark(stage)
        if fits(sizes):
            return attempt, out, sizes
        metrics.retry(mark)
    raise RuntimeError(error)
