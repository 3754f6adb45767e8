"""What the readers of the index cells' build parts share: the seconds
of pipeline/driver.BUILD_STATS under `keys`, summed over the window's
units, over the window, in %."""


def share(*keys):
    def read(ctx):
        c = ctx["counters"]
        if not ctx["units"] or not all(k in c for k in keys):
            return None
        return 100.0 * sum(c[k] for k in keys) / ctx["window_s"]
    return read
