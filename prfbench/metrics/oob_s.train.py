"""oob_s.train: Seconds of a training's OOB tree weights (``core/voting.oob_accuracy``, Eq. 8).

Host clock, from a synchronise before the stage to one after it, mean of
the untraced replays of a traced run (``program.replay_fit``).
"""
from prfbench.readers import span_mean


def read(rec):
    return span_mean(rec, "oob")
