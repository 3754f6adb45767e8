"""The share of the window spent in the native .fmd decoder of the merge's
restores: the seconds of the program's `restore/decode` spans
(rld.read_fmd), summed over the window's units, over the window, in %."""

from portbench.metrics._spans import share

read = share("restore/decode")
