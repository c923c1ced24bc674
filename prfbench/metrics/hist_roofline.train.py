"""hist_roofline.train: % of its roofline.

T_GR, ``csrc/gain_ratio_hist.cu``: the histogram kernel's device time over a
training (dimension reduction's root histograms and every level's), against
the least time for the work ``work.dimred_hist_work`` and
``work.growth_hist_work`` count: the live (tree, sample) pairs' bins of the
features the trees selected, class channels, weights and slots read once a
level, and the histogram of each occupied (tree, slot) written once (with
histogram reuse, the smaller children's). The kernel builds every feature's
histogram; the count holds the features the algorithm scores.

Device time from the profiler's trace of the traced replays; the reader
gives nothing when the trace holds fewer launches than the program's
counter ``hist`` counted.
"""
from prfbench.readers import roofline

PATTERNS = (r"\bhist_kernel\b", r"\bfixed_point_convert\b",)


def read(rec):
    return roofline(rec, "hist", PATTERNS, r"\bhist_kernel\b", "hist")
