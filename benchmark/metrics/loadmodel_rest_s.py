"""/loadmodel's wall time less load_s: the engine, the cache, the program's
warm-up, and loading (or building) the kernels."""


def read(run):
    load = (run.load_split or {}).get("total")
    return None if load is None else run.loadmodel_s - load
