"""The share of the window spent filling the runs' buffers (the span
`rle/fill` of rld.Runs.from_bwt: native frle_from_bwt into buffers new
each build), summed over the window's units, over the window, in %."""

from portbench.metrics._spans import share

read = share("rle/fill")
