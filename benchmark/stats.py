"""Window arithmetic over the load generator's request records.

A record (loadgen.py) has `due` (when it was due: the send time of a
closed-loop request, the scheduled time of an open-loop one), `first` and
`last` (arrival of the first and last content token), `done` (reply
complete), `events` [[t, tokens], ...] (every chunk of content as it
arrived; a non-streamed reply is one event when it arrives) and `error`.
Times are on the monotonic clock; the window is [t0, t1).
"""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float | None:
    """Nearest-rank q-th percentile (q in 0..100); inf counts as a value."""
    v = sorted(values)
    if not v:
        return None
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def tokens_in_window(records, t0: float, t1: float) -> int:
    return sum(n for r in records for t, n in r.get("events", ())
               if t0 <= t < t1)


def due_in_window(records, t0: float, t1: float) -> list:
    return [r for r in records if r.get("due") is not None and t0 <= r["due"] < t1]


def completed_in_window(records, t0: float, t1: float) -> list:
    return [r for r in records
            if "error" not in r and r.get("done") is not None and t0 <= r["done"] < t1]


def ttft_ms(records, t0: float, t1: float) -> list:
    """First token minus due, in ms, of every request due in the window; a
    request that failed or has no first token counts as infinite."""
    out = []
    for r in due_in_window(records, t0, t1):
        ok = "error" not in r and r.get("first") is not None
        out.append((r["first"] - r["due"]) * 1000.0 if ok else math.inf)
    return out


def tpot_ms(records, t0: float, t1: float) -> list:
    """(last - first) / (tokens - 1), in ms, of every request completed in
    the window with two tokens or more."""
    out = []
    for r in completed_in_window(records, t0, t1):
        n = sum(k for _, k in r.get("events", ()))
        if n > 1:
            out.append((r["last"] - r["first"]) * 1000.0 / (n - 1))
    return out


def median(values) -> float | None:
    return statistics.median(values) if values else None
