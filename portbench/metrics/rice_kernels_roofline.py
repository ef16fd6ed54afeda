"""The Golomb-Rice path's kernels (K1, K5, the ladder) against their
roofline: the sum of their least times for the traced frames' data
(``portbench/roofline/``) over the sum of their device times, in %."""

from portbench import roofline


def read(run):
    return roofline.share(run, ("place", "vlc", "ladder"))
