"""to_bins_ms.score: milliseconds of a scoring call's binning (``PRFModel._binned``):
the host rows copied to the card and digitised there by ``core/binning.apply_bins``.

Host clock, from a synchronise before to one after, mean of the untraced
replays of a traced run (``program.replay_predict``).
"""
from prfbench.readers import span_mean


def read(rec):
    s = span_mean(rec, "to_bins")
    return None if s is None else 1000.0 * s
