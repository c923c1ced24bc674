"""mfu.score: % of a scoring call's host seconds that the least time for
its counted device work would take on one H100: the traversal and vote
and the binning of the rows, as ``work.py`` counts them, over the mean
host seconds of an untraced replay of ``PRFModel.predict``.
"""
from prfbench.readers import mfu


def read(rec):
    return mfu(rec, ("traverse", "binning"))
