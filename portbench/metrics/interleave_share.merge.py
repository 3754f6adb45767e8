"""The share of the window spent interleaving the two BWTs and copying the
merged one back: the seconds of the program's `merge/interleave`
(merge_bwts) and `merge/download` (the merged BWT's copy to the host)
spans, summed over the window's units, over the window, in %."""

from portbench.metrics._spans import share

read = share("merge/interleave", "merge/download")
