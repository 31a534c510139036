"""90th percentile, over every request completed in the window, of
(last token - first token) / (tokens - 1), in ms."""

from benchmark import stats


def read(run):
    return stats.percentile(stats.tpot_ms(run.records, run.t0, run.t1), 90)
