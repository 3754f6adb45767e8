"""The share of the window spent in the merge's gap walk: the seconds of
the program's `merge/gap_walk` spans (compute_gap_bits, two K1 launches
a step, synchronised), summed over the window's units, over the window,
in %."""

from portbench.metrics._spans import share

read = share("merge/gap_walk")
