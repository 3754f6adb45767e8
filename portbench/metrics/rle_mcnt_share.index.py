"""The share of the window spent on the symbol counts (the span
`rle/mcnt` of rld.Runs.from_bwt: np.bincount of the runs with float
weights), summed over the window's units, over the window, in %."""

from portbench.metrics._spans import share

read = share("rle/mcnt")
