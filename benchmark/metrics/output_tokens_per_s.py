"""Every output token that reached a client inside the window, over the
window (a non-streamed reply counts when it arrives)."""

from benchmark import stats


def read(run):
    return stats.tokens_in_window(run.records, run.t0, run.t1) / run.seconds
