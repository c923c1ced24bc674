"""dimred_s.train: Seconds of a training's dimension reduction (``core/dimred.dimension_reduction``): every
tree's root histograms, Eq. 2-7 and the selection of Alg. 3.1.

Host clock, from a synchronise before the stage to one after it, mean of
the untraced replays of a traced run (``program.replay_fit``).
"""
from prfbench.readers import span_mean


def read(rec):
    return span_mean(rec, "dimred")
