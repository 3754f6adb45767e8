"""The share of the window the host spends in the device builder's
copies (the spans `bwt/upload`, the text's copy to the card, and
`bwt/download`, the BWT's copy back), summed over the window's units,
over the window, in %."""

from portbench.metrics._spans import share

read = share("bwt/upload", "bwt/download")
