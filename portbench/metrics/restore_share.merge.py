"""The share of the window spent restoring the merge's input indexes:
the seconds of the program's `merge/restore` spans (FMDIndex.restore of
each .fmd: the native decoder and the device layout, synchronised),
summed over the window's units, over the window, in %."""

from portbench.metrics._spans import share

read = share("merge/restore")
