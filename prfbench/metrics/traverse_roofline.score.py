"""traverse_roofline.score: % of its roofline.

prediction, ``csrc/tree_traverse.cu``: the traversal kernel's and its node
packing's device time over the profiled scoring calls, against the least time
for the work ``work.traverse_work`` counts: the rows' bins read, the internal
nodes the walks visit and the leaves they reach read once, the scores written;
a compare and a step a visit, an add a (tree, class).

Device time from the profiler's trace of the traced replays; the reader
gives nothing when the trace holds fewer launches than the program's
counter ``traverse`` counted.
"""
from prfbench.readers import roofline

PATTERNS = (r"\btraverse_kernel\b", r"\bpack_nodes_kernel\b",)


def read(rec):
    return roofline(rec, "traverse", PATTERNS, r"\btraverse_kernel\b", "traverse")
