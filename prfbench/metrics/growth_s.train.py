"""growth_s.train: Seconds of a training's growth (``core/forest.grow_forest`` over ``core/engine.grow``):
the level loop of histograms, split scans, plans, writes and routing.

Host clock, from a synchronise before the stage to one after it, mean of
the untraced replays of a traced run (``program.replay_fit``).
"""
from prfbench.readers import span_mean


def read(rec):
    return span_mean(rec, "growth")
