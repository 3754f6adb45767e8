"""The share of the window spent counting the BWT's runs (the span
`rle/count` of rld.Runs.from_bwt: native frle_count, one thread), summed
over the window's units, over the window, in %."""

from portbench.metrics._spans import share

read = share("rle/count")
