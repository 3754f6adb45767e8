"""What a unit driver's check shares: the reference's index of a cell's
reads, and a `.fmd` the port wrote held to it."""

import numpy as np

from portbench.reference import bwt as ref_bwt
from portbench.reference import rld as ref_rld


def reference_of(r1, r2, device):
    """(the BWT that reference/bwt.py works out from the pairs' reads, as
    a uint8 tensor on `device`; its counts [total, c0..c5])."""
    text = ref_bwt.text_of(np.concatenate([r1, r2]))
    ref = ref_bwt.bwt_of_text(text, device)
    del text
    return ref, ref_bwt.counts_of(ref)


def fmd_mismatch(raw, ref, counts, device):
    """(bwt_mismatch, count_mismatch) of a `.fmd`'s bytes (None for a file
    that was never written) decoded by the frozen decoder
    (reference/rld.py): symbols that differ from the reference's BWT and
    any difference in length; the header's counts against the
    reference's, and 1 more where the file's length is not its header's."""
    if raw is None:
        got_counts, got, whole = np.zeros_like(counts), ref[:0], False
    else:
        got_counts, got, whole = ref_rld.decode(raw, device)
    m = min(got.numel(), ref.numel())
    bwt_mismatch = abs(got.numel() - ref.numel()) + \
        int((got[:m] != ref[:m]).sum())
    count_mismatch = int(np.abs(got_counts - counts).sum()) + (not whole)
    return bwt_mismatch, count_mismatch


def read_bytes(path):
    """The file's bytes, or None where it is missing."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None
