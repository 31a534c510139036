"""model/loader.py: load_model's wall time (LoadedModel.load_split's
"total", the sum of its phases and what lies between them)."""


def read(run):
    load = (run.load_split or {}).get("total")
    return None if load is None else float(load)
