"""The share of the window spent finishing and writing the .fmd (the
span `dump/write` of rld.write_fmd: the last block, the frame and the
file), summed over the window's units, over the window, in %."""

from portbench.metrics._spans import share

read = share("dump/write")
