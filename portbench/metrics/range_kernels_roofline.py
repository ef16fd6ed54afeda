"""The range path's kernels (K1, K2, emission_pack, K3, K4) against their
roofline: the sum of their least times for the traced frames' data
(``portbench/roofline/``) over the sum of their device times, in %."""

from portbench import roofline


def read(run):
    return roofline.share(run, ("place", "adapt", "emission_pack", "expand",
                                "rac_render"))
