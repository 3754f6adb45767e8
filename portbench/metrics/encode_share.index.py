"""The share of the window spent in the host encoders (the native read
encoders and the text): the seconds of pipeline/driver.BUILD_STATS
("frags_s", "text_s") summed over the window's units, over the window,
in %."""

from portbench.metrics._parts import share

read = share("frags_s", "text_s")
