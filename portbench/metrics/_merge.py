"""What the merge cell's readers of the RLE's and the writer's spans
share: `rle` and `dump` are the index build's names too, so these read
only the spans that a `merge` span opened (fermi_tpu_torch/algos/merge.py,
merge_files), among those that start inside the window's units."""

from portbench.metrics._spans import _window_rows


def share_under_merge(name):
    """A reader: the seconds of the spans named `name` whose parent is a
    `merge` span, summed over the window's units, over the window, in %;
    None where there are none."""
    def read(ctx):
        rows = _window_rows(ctx) or ()
        merges = {r.index for r in rows if r.name == "merge"}
        mine = [r for r in rows if r.name == name and r.parent in merges]
        if not mine:
            return None
        return 100.0 * sum(r.end_ns - r.start_ns for r in mine) / 1e9 \
            / ctx["window_s"]
    return read
