"""1 - (prompt tokens the server processed, timings.prompt_n) / (prompt
tokens sent), over the requests completed in the window: the share of
prompt tokens served from a slot's cached prefix."""

from benchmark import stats


def read(run):
    done = [r for r in stats.completed_in_window(run.records, run.t0, run.t1)
            if "prompt_n" in r.get("timings", {})]
    sent = sum(r["prompt_len"] for r in done)
    if not sent:
        return None
    return 1.0 - sum(r["timings"]["prompt_n"] for r in done) / sent
