"""The share of the window spent in the run-length encoder of the merged
BWT: the seconds of the `rle` spans (rld.Runs.from_bwt) that the
program's `merge` spans opened, summed over the window's units, over the
window, in %."""

from portbench.metrics._merge import share_under_merge

read = share_under_merge("rle")
