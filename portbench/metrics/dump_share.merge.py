"""The share of the window spent in the writer of the merged .fmd: the
seconds of the `dump` spans (rld.write_fmd) that the program's `merge`
spans opened, summed over the window's units, over the window, in %."""

from portbench.metrics._merge import share_under_merge

read = share_under_merge("dump")
