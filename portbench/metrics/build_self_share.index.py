"""The share of the window inside `Pipeline.build_index` but in none of
its parts: the self time of the span `build_index` (its duration less
the time its child spans cover), summed over the window's units, over
the window, in %."""

from portbench.metrics._spans import self_share

read = self_share("build_index")
