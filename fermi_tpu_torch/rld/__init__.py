"""RLD (run-length delta) .fmd file I/O — byte-exact with reference fermi.

Python view of an index file is a pair of run arrays plus marginal counts; the
bit-level codec lives in native/rld_codec.cpp. On-disk semantics follow
reference rld.c:47-263 (format only; fresh implementation).
"""

import ctypes
import os
from dataclasses import dataclass

import numpy as np

from fermi_tpu_torch import native, spans


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
        # one native call counts each chunk's runs, one fills buffers of
        # that size and sums the lengths per symbol, both on rle_threads
        # threads (native/rld_codec.cpp): no array of the BWT's length
        # beside it, and the fill threads touch the buffers' pages first
        bwt = np.ascontiguousarray(bwt)
        lib = native.get_lib()
        n_threads = rle_threads(bwt.size)
        first = np.empty(n_threads, np.int64)
        with spans.span("rle/count"):
            n_runs = lib.frle_count(bwt.ctypes.data, bwt.size, n_threads,
                                    first.ctypes.data)
        if n_runs < 0:
            raise MemoryError("frle_count: out of memory")
        with spans.span("rle/fill"):
            symbols = np.empty(n_runs, np.uint8)
            lengths = np.empty(n_runs, np.int64)
            counts = np.empty((n_threads, asize), np.uint64)
            rc = lib.frle_fill(bwt.ctypes.data, bwt.size, n_threads,
                               first.ctypes.data, symbols.ctypes.data,
                               lengths.ctypes.data, asize, counts.ctypes.data)
        if rc != 0:
            raise MemoryError("frle_fill: out of memory")
        with spans.span("rle/mcnt"):
            mcnt = np.empty(asize + 1, np.uint64)
            mcnt[0] = bwt.size
            mcnt[1:] = counts.sum(axis=0, dtype=np.uint64)
        return Runs(lengths, symbols, mcnt, asize)


# Symbols a thread of Runs.from_bwt takes at least: below two of these one
# thread does the whole BWT. On an H100's 8-core host, the count, a fill
# into fresh buffers and the sum over 4-32 Mi symbols ran 1.35-2.8 times
# as fast on one thread per 2 Mi symbols as on one thread
RLE_MIN_CHUNK = 2 << 20


def rle_threads(n: int) -> int:
    """The threads Runs.from_bwt runs on for a BWT of n symbols: the CPUs
    this process may run on, and no more than one per RLE_MIN_CHUNK
    symbols."""
    return max(1, min(len(os.sched_getaffinity(0)), n // RLE_MIN_CHUNK))


def write_fmd(runs: Runs, path: str, sbits: int = 3) -> None:
    """Write runs as an RLD\\2 .fmd file, byte-identical to reference
    rld_dump: the streaming encoder's puts of every run (`dump/encode`),
    then its last block, frame and file (`dump/write`)."""
    lib = native.get_lib()
    lengths = np.ascontiguousarray(runs.lengths, dtype=np.int64)
    symbols = np.ascontiguousarray(runs.symbols, dtype=np.uint8)
    with spans.span("dump/encode"):
        h = lib.frld_enc_open(runs.asize, sbits)
        if not h:
            raise MemoryError("frld_enc_open: out of memory")
        rc = lib.frld_enc_put(h, lengths.ctypes.data, symbols.ctypes.data,
                              len(lengths))
    if rc != 0:
        lib.frld_enc_finish(h, os.devnull.encode())   # frees the encoder
        raise MemoryError(f"frld_enc_put({path}): out of memory")
    with spans.span("dump/write"):
        rc = lib.frld_enc_finish(h, path.encode())
    if rc != 0:
        raise IOError(f"frld_enc_finish({path}) failed: {rc}")


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
