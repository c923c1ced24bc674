"""validation_s.train: Seconds of a training's validation (``data/pipeline.screen_blocks``): the rows and labels
screened for NaN, infinities and labels out of range, on the host.

Host clock, from a synchronise before the stage to one after it, mean of
the untraced replays of a traced run (``program.replay_fit``).
"""
from prfbench.readers import span_mean


def read(rec):
    return span_mean(rec, "validation")
