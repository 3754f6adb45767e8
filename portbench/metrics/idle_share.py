"""The device's idle share of the traced window: 1 - the union of its
records' intervals (kernels, copies, sets) over the window, in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["n_records"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
