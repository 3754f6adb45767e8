"""Builds and loads the port's compiled code with ctypes.

Shared libraries, each built from one source file of this package into
fermi_tpu_torch/build/ at first use (the directory is not committed):

  * the RLD\\2 codec with the mmapped-index reader, the .fmd.blk record
    cache and the streaming append (native/rld_codec.cpp), the
    error-correction fix engine (native/ec.cpp), the unitig walk and stitch
    (native/unitig.cpp), the read encoders (native/frags.cpp), the fltuniq
    filter (native/sequtil.cpp), the SMEM engine and the collect walk
    (native/smem.cpp), the seqsort walk (native/seqsort.cpp), remap's
    paircov (native/remap.cpp) and the B+-rope BWT builder behind
    `ropebwt -a bpr` (native/bprope.cpp), plain g++, no torch headers
    (the index engines include native/fmindex.h);
  * the CUDA kernels (csrc/rank.cu, csrc/sw.cu), nvcc for sm_90a, plain C
    interface (ops/rank_cuda.py and ops/sw_cuda.py launch them).

A library's file name carries a hash of its source, the headers it
includes and its build command, so an edited source never loads a stale
build, and each build lands under a temporary name that is renamed into
place: concurrent processes (test workers) may build the same library at
once and still load a whole file.
`build_all` starts every missing build at once so the compilers overlap.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")


@dataclass(frozen=True)
class Job:
    """One shared library: its source, the headers of this package it
    includes, and the compiler command without the output path (`-o <path>`
    is appended)."""
    name: str
    source: str
    command: tuple
    headers: tuple = ()

    @property
    def path(self) -> str:
        h = hashlib.sha1()
        for f in (self.source, *self.headers):
            with open(f, "rb") as fh:
                h.update(fh.read())
        h.update("\0".join(self.command).encode())
        return os.path.join(BUILD_DIR, f"lib{self.name}-{h.hexdigest()[:12]}.so")


def build_all(jobs) -> None:
    """Build every job whose library is missing, all compilers running at
    once; raises with the compiler's output if one fails."""
    todo = [j for j in jobs if not os.path.exists(j.path)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for j in todo:
        tmp = f"{j.path}.{os.getpid()}.{threading.get_ident()}.tmp"
        p = subprocess.Popen([*j.command, "-o", tmp], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        procs.append((j, tmp, p))
    errors = []
    for j, tmp, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(j.command)}\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, j.path)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def _gxx_job(name: str, source: str, headers=()) -> Job:
    src = os.path.join(_PKG, "native", source)
    cxx = shutil.which("g++") or "g++"
    return Job(name, src, (cxx, "-O2", "-std=c++17", "-fPIC", "-shared", src,
                           "-lpthread"),
               tuple(os.path.join(_PKG, "native", h) for h in headers))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def _nvcc_job(name: str, source: str) -> Job:
    src = os.path.join(_PKG, "csrc", source)
    return Job(name, src, (_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", src))


def codec_job() -> Job:
    return _gxx_job("rld_codec", "rld_codec.cpp", ("fmindex.h",))


def ec_job() -> Job:
    return _gxx_job("fec", "ec.cpp")


def unitig_job() -> Job:
    return _gxx_job("funitig", "unitig.cpp", ("fmindex.h",))


def frags_job() -> Job:
    return _gxx_job("ffrags", "frags.cpp")


def sequtil_job() -> Job:
    return _gxx_job("fsequtil", "sequtil.cpp")


def smem_job() -> Job:
    return _gxx_job("fsmem", "smem.cpp", ("fmindex.h",))


def seqsort_job() -> Job:
    return _gxx_job("fseqsort", "seqsort.cpp", ("fmindex.h",))


def remap_job() -> Job:
    return _gxx_job("fremap", "remap.cpp")


def bprope_job() -> Job:
    return _gxx_job("fbprope", "bprope.cpp")


def host_jobs() -> list:
    """Every g++ library of the port."""
    return [codec_job(), ec_job(), unitig_job(), frags_job(), sequtil_job(),
            smem_job(), seqsort_job(), remap_job(), bprope_job()]


def rank_job() -> Job:
    return _nvcc_job("rank_k1", "rank.cu")


def sw_job() -> Job:
    return _nvcc_job("sw_k2", "sw.cu")


_P, _I, _I64, _U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_uint64)
_SIGNATURES = {
    "rld_codec": {
        "frld_encode_file": (_I, [ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_uint8), _I64, _I, _I,
                                  ctypes.c_char_p]),
        "frld_decode_file": (_I, [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                                  ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.POINTER(ctypes.c_int)]),
        "frld_free": (None, [_P]),
        # frle_count(bwt, n, n_threads, first int64[n_threads]) -> runs / -9
        "frle_count": (_I64, [_P, _I64, _I, _P]),
        # frle_fill(bwt, n, n_threads, first, syms, lens, asize,
        #           counts uint64[n_threads, asize]) -> 0 / -9
        "frle_fill": (_I, [_P, _I64, _I, _P, _P, _P, _I, _P]),
        "frld_enc_open": (_P, [_I, _I]),
        # frld_enc_put(h, run_len, run_sym, n_runs) -> 0 / -9 memory
        "frld_enc_put": (_I, [_P, _P, _P, _I64]),
        "frld_enc_finish": (_I, [_P, ctypes.c_char_p]),
        # fmmap_open(path, info int64[24]) -> handle or null
        "fmmap_open": (_P, [ctypes.c_char_p, _P]),
        # fmmap_rank6(h, ks, n, out [n, asize], n_threads)
        "fmmap_rank6": (None, [_P, _P, _I64, _P, _I]),
        "fmmap_close": (None, [_P]),
        # fmblk_build(fmd, blk, n_threads) -> 0 / error code
        "fmblk_build": (_I, [ctypes.c_char_p, ctypes.c_char_p, _I]),
        # fmblk_info(blk, info int64[12]) -> 0 / error code
        "fmblk_info": (_I, [ctypes.c_char_p, _P]),
        # fappend_gaps(old_blk, blocks1, occ1, n_rows1, cnt1, n_seqs1,
        #              n_seqs0, pos_out, n_threads) -> 0 / error code
        "fappend_gaps": (_I, [ctypes.c_char_p, _P, _P, _I64, _P, _I64, _I64,
                              _P, _I]),
        "fappend_sort": (None, [_P, _I64]),
        # fappend_interleave(old_fmd, bwt1, pos_sorted, n1, out, sbits)
        "fappend_interleave": (_I, [ctypes.c_char_p, _P, _P, _I64,
                                    ctypes.c_char_p, _I]),
    },
    "fec": {
        # fec_create(w, suf_len, keys u32*, vals u8*, class_offsets i64*)
        "fec_create": (_P, [_I, _I, _P, _P, _P]),
        "fec_destroy": (None, [_P]),
        # fec_fix(ctx, opt*, n, seqs u8*, quals u8*, offsets i64*,
        #         info i32*, n_threads) -> hash queries
        "fec_fix": (_U64, [_P, _P, _I64, _P, _P, _P, _P, _I]),
        # fec_device_table(ids i64*, vals i32*, n, logt, mult, max_probe,
        #                  slots i64*, svals i32*) -> 0 ok / 1 probe bound
        "fec_device_table": (_I, [_P, _P, _I64, _I, _U64, _I, _P, _P]),
    },
    "funitig": {
        # funitig_stitch(blocks, occ, n_rows, cnt, n_seqs, min_match, sorted,
        #                seq_flat, seq_offs, own_ks, valid, ret, intv0,
        #                has_ovlp, nkb, nkf, nsz, nov, nex, nein, nmax, skb,
        #                skf, ssz, sbn, sbmax, redo, idt64, out_len*,
        #                n_recover*) -> malloc'd MAG text
        "funitig_stitch": (_P, [_P, _P, _I64, _P, _I64, _I, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _P, _P, _P, _P, _I, _P, _I, _P, _P]),
        "funitig_free": (None, [_P]),
        # funitig_run(blocks, occ, n_rows, cnt, n_seqs, min_match, sorted,
        #             n_threads, out_len*) -> malloc'd MAG text
        "funitig_run": (_P, [_P, _P, _I64, _P, _I64, _I, _P, _I, _P]),
        # funitig_run_blk(blk, min_match, sorted, n_threads, out_len*)
        "funitig_run_blk": (_P, [ctypes.c_char_p, _I, _P, _I, _P]),
    },
    "ffrags": {
        # fbuild_text(seqs, offsets, n_reads, both_strands, trim_pal, out)
        "fbuild_text": (_I64, [_P, _P, _I64, _I, _I, _P]),
        # fencode_frags(data, starts, lens, n_reads, n_threads, F**, offs**)
        "fencode_frags": (_I64, [_P, _P, _P, _I64, _I, _P, _P]),
        # ffastq_frags(path, n_threads, F**, offs**, nfrag*) -> len(F)
        "ffastq_frags": (_I64, [ctypes.c_char_p, _I, _P, _P, _P]),
        "ffrags_free": (None, [_P]),
    },
    "fsequtil": {
        # fspans_extract(src, starts, lens, n, dst, n_threads)
        "fspans_extract": (None, [_P, _P, _P, _I64, _P, _I]),
        # fflt_keep(seqs, offsets, n_reads, k, keep_out, n_threads)
        "fflt_keep": (_I, [_P, _P, _I64, _I, _P, _I]),
    },
    "fsmem": {
        # fsmem_all(blocks, occ, n_rows, cnt, n_seqs, queries, offsets,
        #           n_queries, self_match, counts*, total*) -> int64 [total, 5]
        "fsmem_all": (_P, [_P, _P, _I64, _P, _I64, _P, _P, _I64, _I, _P,
                           _P]),
        # fsmem_all_blk(blk, queries, offsets, n_queries, self_match,
        #               counts*, total*)
        "fsmem_all_blk": (_P, [ctypes.c_char_p, _P, _P, _I64, _I, _P, _P]),
        # fec_collect(blocks, occ, n_rows, cnt, n_seqs, w, min_occ,
        #             n_threads, counts int64[3]) -> int64 [n, 3]
        "fec_collect": (_P, [_P, _P, _I64, _P, _I64, _I, _I, _I, _P]),
        # fec_collect_blk(blk, w, min_occ, n_threads, counts int64[3])
        "fec_collect_blk": (_P, [ctypes.c_char_p, _I, _I, _I, _P]),
        "fsmem_free": (None, [_P]),
    },
    "fseqsort": {
        # fseqsort(blocks, occ, n_rows, cnt, n_seqs, sorted, n_threads)
        "fseqsort": (_I, [_P, _P, _I64, _P, _I64, _P, _I]),
        # fseqsort_blk(blk, sorted, n_threads) -> 0 / -1
        "fseqsort_blk": (_I, [ctypes.c_char_p, _P, _I]),
    },
    "fremap": {
        "fpaircov_create": (_P, [_I64, _I64]),
        # fpaircov_batch(hd, mems, counts, lens, n_contigs, sorted, n_seqs,
        #                cov, pcv, n_supp, unp_k, unp_v, unp_counts)
        "fpaircov_batch": (_I64, [_P, _P, _P, _P, _I64, _P, _I64, _P, _P,
                                  _P, _P, _P, _P]),
        "fpaircov_stats": (None, [_P, _P]),
        "fpaircov_destroy": (None, [_P]),
    },
    "fbprope": {
        # fbpr_build(seqs u8*, offsets i64*, n_reads, out u8*) -> length
        "fbpr_build": (_I64, [_P, _P, _I64, _P]),
    },
    # the kernels' entries return the cudaError_t of their launch
    "rank_k1": {
        # k1_rank_block_counts(words, off, out, n, stream)
        "k1_rank_block_counts": (_I, [_P, _P, _P, _I64, _P]),
        # k1_rank6_fused(fused, nrows, k, out, n, wide, stream)
        "k1_rank6_fused": (_I, [_P, _I64, _P, _P, _I64, _I, _P]),
    },
    "sw_k2": {
        "k2_rows": (_I, []),
        "k2_block_warps": (_I, []),
        # k2_sw_score(q, qoff, t, toff, tasks, ntasks, match, mismatch,
        #             gapo, gape, carry, coff, out, stream)
        "k2_sw_score": (_I, [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P,
                             _P, _P, _P]),
    },
}

_lock = threading.Lock()
_libs = {}


def load(job_fn) -> ctypes.CDLL:
    """The library of one job, built on first use, signatures declared.
    Later calls (every kernel launch makes one) only look it up."""
    lib = _libs.get(job_fn)
    if lib is None:
        with _lock:
            lib = _libs.get(job_fn)
            if lib is None:
                job = job_fn()
                build_all([job])
                lib = ctypes.CDLL(job.path)
                for fn, (restype, argtypes) in _SIGNATURES[job.name].items():
                    getattr(lib, fn).restype = restype
                    getattr(lib, fn).argtypes = argtypes
                _libs[job_fn] = lib
    return lib


def get_lib() -> ctypes.CDLL:
    """The RLD codec, built on first use."""
    return load(codec_job)


def get_ec_lib() -> ctypes.CDLL:
    """The error-correction fix engine (native/ec.cpp), built on first use."""
    return load(ec_job)


def get_unitig_lib() -> ctypes.CDLL:
    """The unitig walk and stitch (native/unitig.cpp), built on first use."""
    return load(unitig_job)


def get_frags_lib() -> ctypes.CDLL:
    """The read encoders (native/frags.cpp), built on first use."""
    return load(frags_job)


def get_sequtil_lib() -> ctypes.CDLL:
    """The fltuniq filter and span copy (native/sequtil.cpp)."""
    return load(sequtil_job)


def get_smem_lib() -> ctypes.CDLL:
    """The SMEM engine and the collect walk (native/smem.cpp), built on
    first use."""
    return load(smem_job)


def get_seqsort_lib() -> ctypes.CDLL:
    """The seqsort walk (native/seqsort.cpp), built on first use."""
    return load(seqsort_job)


def get_remap_lib() -> ctypes.CDLL:
    """remap's paircov engine (native/remap.cpp), built on first use."""
    return load(remap_job)


def get_bprope_lib() -> ctypes.CDLL:
    """The B+-rope BWT builder (native/bprope.cpp), built on first use."""
    return load(bprope_job)
