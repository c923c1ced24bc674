"""idle_share.train: % of the traced window in which no operation (kernel,
copy or fill) ran on the device, from the profiler's trace of the
profiled replays of a traced run.
"""
from prfbench.readers import idle_share


def read(rec):
    return idle_share(rec)
