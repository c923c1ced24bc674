"""mfu.train: % of a training's host seconds that the least time for its
counted work would take on one H100: the quantile fit (each float read
once), the digitising, the histograms (dimension reduction's and every
level's), the split scans and the OOB walks, as ``work.py`` counts them
(the rooflines' numerators), over the mean host seconds of an untraced
replay of ``fit_prf_from_draws``. The fit runs on the host today; its
count is what it would cost on the card, so a change that moves it there
moves this share. A forest has no matrix products: this is the whole
training's share of the chip's peak bytes and float operations, which
bounds the kernels' rooflines when a later change takes a kernel off the
path.
"""
from prfbench.readers import mfu


def read(rec):
    return mfu(rec, ("bin_fit", "binning", "hist", "split_scan", "oob"))
