"""The share of the window spent in the run-length encoder: the seconds of
pipeline/driver.BUILD_STATS ("rle_s") summed over the window's units,
over the window, in %."""

from portbench.metrics._parts import share

read = share("rle_s")
