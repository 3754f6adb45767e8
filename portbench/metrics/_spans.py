"""What the readers of the index build's spans share: the program's own
spans (fermi_tpu_torch/spans.py, epoch ns), those that start inside one
of the window's units (the harness's "unit" spans in ctx["spans"]), so
that the warm-up's and the check's do not count.  A program without the
recorder, or without spans of the names asked for, reads None."""


def _window_rows(ctx):
    """The program's spans that start inside a unit of the window, or
    None where the program records none."""
    try:
        from fermi_tpu_torch import spans
    except ImportError:
        return None
    units = [(a, b) for n, a, b, _ in ctx["spans"] if n == "unit"]
    if not ctx["units"] or not units:
        return None
    return [r for r in spans.rows() if r.end_ns is not None
            and any(a <= r.start_ns < b for a, b in units)]


def share(*names):
    """A reader: the seconds of the spans named `names`, summed over the
    window's units, over the window, in %."""
    def read(ctx):
        rows = _window_rows(ctx)
        rows = [r for r in rows or () if r.name in names]
        if not rows:
            return None
        return 100.0 * sum(r.end_ns - r.start_ns for r in rows) / 1e9 \
            / ctx["window_s"]
    return read


def self_share(name):
    """A reader: the self time of the spans named `name` (each one's
    duration less the union of its children's intervals), summed over the
    window's units, over the window, in %."""
    def read(ctx):
        rows = _window_rows(ctx)
        tops = [r for r in rows or () if r.name == name]
        if not tops:
            return None
        total = 0
        for top in tops:
            kids = sorted((max(r.start_ns, top.start_ns),
                           min(r.end_ns, top.end_ns)) for r in rows
                          if r.parent == top.index)
            covered, at = 0, top.start_ns
            for a, b in kids:
                a = max(a, at)
                if b > a:
                    covered += b - a
                    at = b
            total += top.end_ns - top.start_ns - covered
        return 100.0 * total / 1e9 / ctx["window_s"]
    return read
