"""90th percentile, over every request due in the window, of its first
streamed token minus the time it was due (ms); a failed request, or one
whose first token never came, counts as missing (infinite)."""

from benchmark import stats


def read(run):
    return stats.percentile(stats.ttft_ms(run.records, run.t0, run.t1), 90)
