"""Kernel K1's share of the traced window of the merge cell: device time of
the rank6_fused and rank_block_counts kernels (the gap walk's rank
counts) over the window, in %."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["k1_s"]:
        return None
    return 100.0 * tr["k1_s"] / tr["window_s"]
