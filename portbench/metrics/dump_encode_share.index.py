"""The share of the window spent encoding the runs (the span
`dump/encode` of rld.write_fmd: the streaming encoder's puts), summed
over the window's units, over the window, in %."""

from portbench.metrics._spans import share

read = share("dump/encode")
