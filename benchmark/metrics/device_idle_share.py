"""Share of the traced window in which no operation ran on the device, in %."""


def read(run):
    tr = run.trace
    if not tr or not tr.get("n_device_events"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
