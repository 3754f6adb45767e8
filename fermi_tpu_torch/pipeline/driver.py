"""End-to-end assembly pipeline (run-fermi.pl), unpaired and paired.

The port of fermi_tpu/pipeline/driver.py.  The same artifact DAG and stage
semantics as the reference pipeline (run-fermi.pl:53-104): stages run in
process, each writes a durable artifact and is skipped when that artifact
exists, so an interrupted run resumes.  Insert-size statistics flow through
a JSON sidecar (insert.json) instead of being grepped out of stderr logs.
Unpaired reads end at p2.mag.gz; paired reads (interleaved FASTQ, mates
adjacent) go on through the .rank walk, remap (p3.mag.gz), scaf
(p4.fa.gz, scaftigs) and the final remap (p5.fq.gz).

On the Pipeline's device (CUDA unless another device is named): every
index build (prefix doubling, or the blocked builder for texts of
suffix_device.MAX_TEXT symbols and more), the error-correction collect,
the .rank walk, unitig's link records, and scaf's mate walks and local
assemblies' sorts.  On the host: the read encoders and fltuniq (native),
the correction fix and the unitig stitch (native), clean, remap, and
scaf's link analysis and local unitig walks.  Unitig's output is `unitig
-t 1`'s bytes whatever the thread count.  The corrected reads' index stays
on the device from ec_fmd to the last stage that reads it.
"""

import ctypes
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from fermi_tpu_torch import native, resolve_device, spans


# Seconds by part of the last index build (_build_from_frags), for
# measurement (the chip smoke test and the benchmark read them): the
# durations of its spans `frags` (the read encoders), `text`, `bwt` (the
# device BWT), `rle` (its run-length encoding) and `dump` (the .fmd).
BUILD_STATS = {}


def log(stage, msg):
    sys.stderr.write(f"[pipeline::{stage}] {msg}\n")
    sys.stderr.flush()


class _GzPipeWriter:
    """Text sink compressing through an external `gzip -1` process, so the
    deflate runs on its own core beside the producing stage (the reference
    chain's `fermi clean ... | gzip -1`).  Context-managed; raises if gzip
    fails."""

    def __init__(self, path):
        self._f = open(path, "wb")
        self._proc = subprocess.Popen(
            ["gzip", "-1", "-c"], stdin=subprocess.PIPE, stdout=self._f,
            bufsize=1 << 20)
        self._w = io.TextIOWrapper(self._proc.stdin, write_through=False)

    def write(self, s):
        self._w.write(s)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._w.close()
        else:
            # the stage is already unwinding; a dead gzip (disk full,
            # killed) would raise BrokenPipeError here and mask the
            # original exception
            try:
                self._w.close()
            except (BrokenPipeError, ValueError, OSError):
                pass
        rc = self._proc.wait()
        self._f.close()
        if exc_type is None and rc != 0:
            raise OSError(f"gzip exited with {rc}")
        return False


def _gz_text_writer(path):
    """`gzip -1` subprocess writer when the binary exists, else in-process."""
    if shutil.which("gzip"):
        return _GzPipeWriter(path)
    return io.TextIOWrapper(gzip.open(path, "wb", 1))


class Pipeline:
    def __init__(self, prefix, n_threads=8, unitig_k=50, paired=False,
                 trim_l=0, skip_ec=False, device=None):
        self.prefix = prefix
        self.t = n_threads
        self.k = unitig_k
        self.paired = paired
        self.trim_l = trim_l
        self.skip_ec = skip_ec
        self.device = resolve_device(device)
        self.min_clean_o = int(unitig_k * 1.2 + 0.499)
        self._cache = {}  # in-process index reuse across stages

    def _p(self, suffix):
        return f"{self.prefix}.{suffix}"

    def _runs(self, path):
        key = ("runs", path)
        if key not in self._cache:
            from fermi_tpu_torch import rld
            self._cache[key] = rld.read_fmd(path)
        return self._cache[key]

    def _fmd(self, path):
        key = ("fmd", path)
        if key not in self._cache:
            from fermi_tpu_torch.index.fmd import FMDIndex
            self._cache[key] = FMDIndex.from_runs(self._runs(path),
                                                  self.device)
        return self._cache[key]

    def _drop(self, path):
        """Free an index no later stage reads (device memory)."""
        self._cache.pop(("fmd", path), None)

    # -- index builds ------------------------------------------------------

    @staticmethod
    def _frags_from_fastq(paths):
        """(F, offsets) forward-only nt6 fragments (maximal ACGT runs) of
        plain 4-line FASTQ files, plain or gzipped, by the native encoders;
        None when a file is not that shape."""
        from fermi_tpu_torch.core import fastx
        Fs, offs_list = [], []
        for path in paths:
            if not str(path).endswith(".gz"):
                fo = Pipeline._frags_from_plain_fastq(path)
                if fo is not None:
                    Fs.append(fo[0])
                    offs_list.append(fo[1])
                    continue
            opener = gzip.open if str(path).endswith(".gz") else open
            with opener(path, "rb") as f:
                data = f.read()
            sp = fastx.fastq_seq_spans(data)
            if sp is None:
                return None
            F, offs = Pipeline._encode_spans(*sp)
            Fs.append(F)
            offs_list.append(offs)
        if len(Fs) == 1:
            return Fs[0], offs_list[0]
        base = 0
        adj = []
        for F, offs in zip(Fs, offs_list):
            adj.append(offs[:-1] + base if adj else offs[:-1])
            base += len(F)
        adj.append(np.array([base], np.int64))
        return np.concatenate(Fs), np.concatenate(adj)

    @staticmethod
    def _take(lib, pF, pO, n_frag):
        """Copies of the encoders' malloc'd fragment buffers, then freed."""
        try:
            offs = np.ctypeslib.as_array(pO, shape=(n_frag + 1,)).copy()
            F = np.ctypeslib.as_array(pF, shape=(int(offs[-1]) + 1,))[
                : int(offs[-1])].copy()
        finally:
            lib.ffrags_free(ctypes.cast(pF, ctypes.c_void_p))
            lib.ffrags_free(ctypes.cast(pO, ctypes.c_void_p))
        return F, offs

    @staticmethod
    def _frags_from_plain_fastq(path):
        """(F, offsets) of a plain file in one native pass (ffastq_frags:
        mmap, threaded newline scan, encode, ACGT-run split); None when the
        file is empty or not 4-line FASTQ."""
        lib = native.get_frags_lib()
        pF = ctypes.POINTER(ctypes.c_uint8)()
        pO = ctypes.POINTER(ctypes.c_int64)()
        nfrag = ctypes.c_int64()
        n = lib.ffastq_frags(str(path).encode(), min(os.cpu_count() or 1, 8),
                             ctypes.byref(pF), ctypes.byref(pO),
                             ctypes.byref(nfrag))
        if n == -4:
            raise MemoryError(f"ffastq_frags({path}): out of memory")
        if n < 0:
            return None
        return Pipeline._take(lib, pF, pO, int(nfrag.value))

    @staticmethod
    def _encode_spans(arr, starts, lens):
        """(F, offsets) of the reads at byte spans of a buffer (native
        fencode_frags: table encode and ACGT-run split, threaded)."""
        lib = native.get_frags_lib()
        starts = np.ascontiguousarray(starts, np.int64)
        lens = np.ascontiguousarray(lens, np.int64)
        pF = ctypes.POINTER(ctypes.c_uint8)()
        pO = ctypes.POINTER(ctypes.c_int64)()
        nfrag = lib.fencode_frags(arr.ctypes.data, starts.ctypes.data,
                                  lens.ctypes.data, len(starts), 4,
                                  ctypes.byref(pF), ctypes.byref(pO))
        if nfrag < 0:
            raise MemoryError("fencode_frags: out of memory")
        return Pipeline._take(lib, pF, pO, nfrag)

    def _build_from_frags(self, F, offs, out_fmd, frags):
        """The index of forward-only nt6 fragments: the text (each
        fragment and its reverse complement), its BWT on the device, the
        .fmd dump.  `frags` is the closed span that made the fragments;
        BUILD_STATS gets its seconds and those of the text, bwt, rle and
        dump spans opened here."""
        from fermi_tpu_torch import rld
        from fermi_tpu_torch.construct import blocked, suffix

        nfrag = len(offs) - 1
        with spans.span("text") as text_sp:
            text = suffix.build_text_packed(F, offs)
            n_sym = int(text.size)
        log("build", f"{nfrag} fragments, {n_sym / 1e6:.1f}M "
            f"symbols on {self.device}")
        with spans.span("bwt") as bwt_sp:
            bwt = blocked.device_bwt(text, self.device)
        del text
        with spans.span("rle") as rle_sp:
            runs = rld.Runs.from_bwt(bwt)
        rle_threads = rld.rle_threads(bwt.size)
        del bwt
        with spans.span("dump") as dump_sp:
            rld.write_fmd(runs, out_fmd)
        self._cache[("runs", out_fmd)] = runs
        parts = {"frags": frags, "text": text_sp, "bwt": bwt_sp,
                 "rle": rle_sp, "dump": dump_sp}
        BUILD_STATS.update(fragments=nfrag, symbols=n_sym, **{
            f"{k}_s": sp.seconds for k, sp in parts.items()})
        total = (dump_sp.end_ns - frags.start_ns) / 1e9
        times = {k: f"{k} {sp.seconds:.1f}" for k, sp in parts.items()}
        times["rle"] += f" x{rle_threads}"
        log("build", f"wrote {out_fmd} in {total:.1f}s ("
            + ", ".join(times.values()) + ")")

    def build_index(self, reads_iter, out_fmd, paths=None):
        """raw/ec FMD-index (the reference's `ropebwt -a bcr -N` stage):
        plain FASTQ through the native encoders, any other input record by
        record; reads are split at every non-ACGT base either way."""
        with spans.span("build_index"):
            with spans.span("frags") as frags:
                fo = None if paths is None else self._frags_from_fastq(paths)
                if fo is None:
                    fo = self._frags_from_reads(reads_iter)
            self._build_from_frags(*fo, out_fmd, frags)

    @staticmethod
    def _frags_from_reads(reads_iter):
        """(F, offsets) forward-only nt6 fragments of reads as strings."""
        from fermi_tpu_torch.core import dna

        # join reads with N: encode maps it to 5, and fragments are maximal
        # runs of non-5 symbols, so one vectorized pass splits them
        enc = dna.encode("N".join(reads_iter))
        ok = enc != 5
        edge = np.diff(ok.view(np.int8), prepend=np.int8(0),
                       append=np.int8(0))
        lens = np.flatnonzero(edge == -1) - np.flatnonzero(edge == 1)
        return enc[ok], np.concatenate([[0], np.cumsum(lens)])

    # -- stages ------------------------------------------------------------

    def stage_raw_fmd(self, fastx_paths):
        out = self._p("ec.fmd" if self.skip_ec else "raw.fmd")
        if os.path.exists(out):
            return
        from fermi_tpu_torch.core import fastx

        def reads():
            for path in fastx_paths:
                for rec in fastx.read_fastx(path):
                    yield rec.seq

        self.build_index(reads(), out, paths=list(fastx_paths))

    def stage_correct(self, fastx_paths):
        out = self._p("ec.fq.gz")
        if self.skip_ec or os.path.exists(out):
            return
        from fermi_tpu_torch.algos import correct as ec

        raw = self._p("raw.fmd")
        with _gz_text_writer(out + ".tmp") as fp:
            # the reference corrects the concatenated input stream
            ec.ec_correct(self._fmd(raw), list(fastx_paths), fp,
                          n_threads=self.t, is_paired=self.paired,
                          trim_l=self.trim_l)
        self._drop(raw)
        os.rename(out + ".tmp", out)

    def stage_ec_fmd(self):
        out = self._p("ec.fmd")
        if os.path.exists(out):
            return
        from fermi_tpu_torch.cli import sequtils as su
        from fermi_tpu_torch.core import fastx

        src = self._p("ec.fq.gz")
        # fltuniq keep flags -> kept reads' spans -> fragments -> build,
        # without writing the filtered FASTQ (the same fragments as the
        # flt.fq round trip: the same spans, the same encoder)
        with spans.span("frags") as frags:
            kept = su.fltuniq_kept_seq_spans(src)
            if kept is not None:
                fo = self._encode_spans(*kept)
                log("ec_fmd", f"fltuniq: kept {len(kept[1])} reads in "
                    f"{(time.time_ns() - frags.start_ns) / 1e9:.1f}s")
        if kept is not None:
            self._build_from_frags(*fo, out, frags)
            return
        flt = self._p("flt.fq")
        with open(flt, "w") as fp:
            su.fltuniq(src, fp)

        def reads():
            for rec in fastx.read_fastx(flt):
                yield rec.seq

        self.build_index(reads(), out, paths=[flt])
        os.remove(flt)

    def stage_rank(self):
        out = self._p("ec.rank")
        if not self.paired or os.path.exists(out):
            return
        from fermi_tpu_torch.algos.seqsort import seqsort

        seqsort(self._fmd(self._p("ec.fmd"))).tofile(out)

    def stage_unitig(self):
        out = self._p("p0.mag.gz")
        if os.path.exists(out):
            return
        from fermi_tpu_torch.algos.unitig_bulk import fm6_unitig_device

        sorted_arr = None
        if self.paired:
            sorted_arr = np.fromfile(self._p("ec.rank"), np.uint64)
        with _gz_text_writer(out + ".tmp") as fp:
            fm6_unitig_device(self._fmd(self._p("ec.fmd")), self.k, fp,
                              sorted_arr=sorted_arr)
        os.rename(out + ".tmp", out)

    def _clean(self, src, dst, **over):
        if os.path.exists(self._p(dst)):
            return
        from fermi_tpu_torch.algos import mag as M

        opt = dict(M.DEFAULT_OPT)
        opt.update(over)
        g = M.mag_read(self._p(src), opt)
        M.g_clean(g, opt)
        with _gz_text_writer(self._p(dst) + ".tmp") as fp:
            M.mag_print(g, fp)
        os.rename(self._p(dst) + ".tmp", self._p(dst))

    def stage_clean(self):
        self._clean("p0.mag.gz", "p1.mag.gz")
        self._clean("p1.mag.gz", "p2.mag.gz", flag_clean=True,
                    flag_aggressive=True, flag_read_ori=True,
                    flag_no_amend=True, min_ovlp=self.min_clean_o)

    def stage_remap(self):
        out = self._p("p3.mag.gz")
        if not self.paired or os.path.exists(out):
            return
        from fermi_tpu_torch.algos.remap import remap

        # remap's contig queries run in the native SMEM engine over the
        # index's host arrays (one copy from the device, cached)
        sorted_arr = np.fromfile(self._p("ec.rank"), np.uint64)
        with _gz_text_writer(out + ".tmp") as fp:
            avg, std, cap = remap(self._fmd(self._p("ec.fmd")),
                                  self._p("p2.mag.gz"), fp, sorted_arr)
        os.rename(out + ".tmp", out)
        with open(self._p("insert.json"), "w") as fp:
            json.dump({"avg": avg, "std": std, "cap": cap}, fp)

    def stage_scaf(self):
        out = self._p("p4.fa.gz")
        if not self.paired or os.path.exists(out):
            return
        from fermi_tpu_torch.algos.scaf import scaf_core

        with open(self._p("insert.json")) as fp:
            stats = json.load(fp)
        # the mates are walked on the cached device index: no host mirror
        with _gz_text_writer(out + ".tmp") as fp:
            scaf_core(self._fmd(self._p("ec.fmd")), self._p("p3.mag.gz"),
                      stats["avg"], stats["std"], pr_links=True, out_fp=fp)
        os.rename(out + ".tmp", out)

    def stage_final_remap(self):
        out = self._p("p5.fq.gz")
        if not self.paired or os.path.exists(out):
            return
        from fermi_tpu_torch.algos.remap import remap

        with open(self._p("insert.json")) as fp:
            stats = json.load(fp)
        sorted_arr = np.fromfile(self._p("ec.rank"), np.uint64)
        with _gz_text_writer(out + ".tmp") as fp:
            remap(self._fmd(self._p("ec.fmd")), self._p("p4.fa.gz"), fp,
                  sorted_arr, min_pcv=2, max_dist=stats["cap"])
        os.rename(out + ".tmp", out)

    def run(self, fastx_paths):
        """The chain from raw reads to p2.mag.gz, or for paired reads to
        p5.fq.gz.  Seconds of each stage go to the log (`[pipeline::run]
        stage NAME: S s`)."""
        t0 = time.time()
        stages = [("raw_fmd", lambda: self.stage_raw_fmd(fastx_paths)),
                  ("correct", lambda: self.stage_correct(fastx_paths))]
        if not self.skip_ec:
            stages.append(("ec_fmd", self.stage_ec_fmd))
        if self.paired:
            stages.append(("rank", self.stage_rank))
        stages += [("unitig", self.stage_unitig),
                   ("clean", self.stage_clean)]
        if self.paired:
            stages += [("remap", self.stage_remap),
                       ("scaf", self.stage_scaf),
                       ("final_remap", self.stage_final_remap)]
        for name, fn in stages:
            ts = time.time()
            fn()
            log("run", f"stage {name}: {time.time() - ts:.3f}s")
        self._drop(self._p("ec.fmd"))
        final = self._p("p5.fq.gz" if self.paired else "p2.mag.gz")
        log("run", f"done -> {final} in {time.time() - t0:.3f}s")
        return final
