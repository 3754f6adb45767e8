"""B+-rope incremental BWT builder (reference bprope6.c semantics).

The port's copy of fermi_tpu/construct/bprope.py, over its own copy of
native/bprope.cpp (a counted B+-tree of runs, host code).  It is the
builder of `ropebwt -a bpr`, kept for the reference's strongest QA idea:
interchangeable builders must agree bit for bit (fermi.1:581-628).
Insertion order defines sentinel order, as in bpr_insert_string
(bprope6.c:219-226).
"""

import numpy as np


def bpr_bwt(seqs: list[np.ndarray]) -> np.ndarray:
    """Multi-string BWT of nt6 reads (no sentinels in input), built by
    incremental rope insertion; equal to the suffix-array rule over
    construct.suffix.build_text(seqs, both_strands=False,
    trim_palindrome=False)."""
    from fermi_tpu_torch import native

    n = len(seqs)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    flat = np.ascontiguousarray(
        np.concatenate([np.asarray(s, np.uint8) for s in seqs]) if n
        else np.zeros(0, np.uint8))
    out = np.empty(int(offsets[-1]) + n, np.uint8)
    total = native.get_bprope_lib().fbpr_build(
        flat.ctypes.data, offsets.ctypes.data, n, out.ctypes.data)
    if total < 0:
        raise MemoryError("fbpr_build: out of memory")
    if total != out.size:
        raise RuntimeError(f"fbpr_build wrote {total} symbols, expected "
                           f"{out.size}")
    return out
