"""RLD (run-length delta) .fmd file I/O — byte-exact with reference fermi.

Python view of an index file is a pair of run arrays plus marginal counts; the
bit-level codec lives in native/rld_codec.cpp. On-disk semantics follow
reference rld.c:47-263 (format only; fresh implementation).
"""

import ctypes
from dataclasses import dataclass

import numpy as np

from fermi_tpu_torch import native


@dataclass
class Runs:
    """Run-length representation of a (multi-string) BWT.

    lengths[i] consecutive copies of symbols[i]; adjacent runs are maximal
    (symbols[i] != symbols[i+1]). mcnt[0] is total length, mcnt[1+c] the count
    of symbol c (alphabet {0:$,1:A,2:C,3:G,4:T,5:N}).
    """

    lengths: np.ndarray  # int64[n_runs]
    symbols: np.ndarray  # uint8[n_runs]
    mcnt: np.ndarray     # uint64[asize+1]
    asize: int = 6

    @property
    def total(self) -> int:
        return int(self.mcnt[0])

    @property
    def n_seqs(self) -> int:
        return int(self.mcnt[1])

    def expand(self) -> np.ndarray:
        """Dense BWT symbol array (uint8[total])."""
        return np.repeat(self.symbols, self.lengths)

    @staticmethod
    def from_bwt(bwt: np.ndarray, asize: int = 6) -> "Runs":
        bwt = np.asarray(bwt, dtype=np.uint8)
        if bwt.size == 0:
            return Runs(np.zeros(0, np.int64), np.zeros(0, np.uint8),
                        np.zeros(asize + 1, np.uint64), asize)
        boundaries = np.flatnonzero(bwt[1:] != bwt[:-1]) + 1
        starts = np.concatenate(([0], boundaries))
        ends = np.concatenate((boundaries, [bwt.size]))
        lengths = (ends - starts).astype(np.int64)
        symbols = bwt[starts]
        mcnt = np.zeros(asize + 1, np.uint64)
        mcnt[1:] = np.bincount(bwt, minlength=asize)[:asize].astype(np.uint64)
        mcnt[0] = bwt.size
        return Runs(lengths, symbols, mcnt, asize)


def write_fmd(runs: Runs, path: str, sbits: int = 3) -> None:
    """Write runs as an RLD\\2 .fmd file, byte-identical to reference rld_dump."""
    lib = native.get_lib()
    lengths = np.ascontiguousarray(runs.lengths, dtype=np.int64)
    symbols = np.ascontiguousarray(runs.symbols, dtype=np.uint8)
    rc = lib.frld_encode_file(
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(lengths), runs.asize, sbits, path.encode())
    if rc != 0:
        raise IOError(f"frld_encode_file({path}) failed: {rc}")


def read_fmd(path: str) -> Runs:
    """Read an RLD\\2 .fmd (or raw RLE-byte stream) into runs."""
    lib = native.get_lib()
    p_len = ctypes.POINTER(ctypes.c_int64)()
    p_sym = ctypes.POINTER(ctypes.c_uint8)()
    n_runs = ctypes.c_int64()
    mcnt = (ctypes.c_uint64 * 17)()
    asize = ctypes.c_int()
    rc = lib.frld_decode_file(path.encode(), ctypes.byref(p_len),
                              ctypes.byref(p_sym), ctypes.byref(n_runs),
                              mcnt, ctypes.byref(asize))
    if rc != 0:
        raise IOError(f"frld_decode_file({path}) failed: {rc}")
    n = n_runs.value
    try:
        lengths = np.ctypeslib.as_array(p_len, shape=(n,)).copy() if n else \
            np.zeros(0, np.int64)
        symbols = np.ctypeslib.as_array(p_sym, shape=(n,)).copy() if n else \
            np.zeros(0, np.uint8)
    finally:
        lib.frld_free(ctypes.cast(p_len, ctypes.c_void_p))
        lib.frld_free(ctypes.cast(p_sym, ctypes.c_void_p))
    a = asize.value
    mc = np.array(mcnt[: a + 1], dtype=np.uint64)
    return Runs(lengths.astype(np.int64, copy=False),
                symbols.astype(np.uint8, copy=False), mc, a)
