"""binning_s.train: Seconds of a training's binning (``core/binning.bin_dataset``): the quantile edges fitted
on the host, the rows copied to the card and digitised there, ending in a synchronise.

Host clock, from a synchronise before the stage to one after it, mean of
the untraced replays of a traced run (``program.replay_fit``).
"""
from prfbench.readers import span_mean


def read(rec):
    return span_mean(rec, "binning")
