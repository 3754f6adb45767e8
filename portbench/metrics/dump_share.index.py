"""The share of the window spent in the writer (the .fmd dump): the seconds
of pipeline/driver.BUILD_STATS ("dump_s") summed over the window's
units, over the window, in %."""

from portbench.metrics._parts import share

read = share("dump_s")
