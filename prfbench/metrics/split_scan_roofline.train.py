"""split_scan_roofline.train: % of its roofline.

T_NS, ``csrc/split_scan.cu``: the split-scan kernels' device time over a
training, against the least time for the work ``work.split_scan_work`` counts:
each occupied (tree, slot)'s histogram of its selected features read, every
candidate split scored by Eq. 2-6, the winner written.

Device time from the profiler's trace of the traced replays; the reader
gives nothing when the trace holds fewer launches than the program's
counter ``split_scan`` counted.
"""
from prfbench.readers import roofline

PATTERNS = (r"\bsplit_scan_kernel\b", r"\bsplit_scan_wide_kernel\b",)


def read(rec):
    return roofline(rec, "split_scan", PATTERNS, r"\bsplit_scan(_wide)?_kernel\b", "split_scan")
