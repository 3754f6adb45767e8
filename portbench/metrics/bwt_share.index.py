"""The share of the window spent in the device builder (the BWT on the
device): the seconds of pipeline/driver.BUILD_STATS ("bwt_s") summed
over the window's units, over the window, in %."""

from portbench.metrics._parts import share

read = share("bwt_s")
