"""Units of kind "merge": `fermi merge` of a deployment's chunk indexes
through the port's CLI, in process, as run-fermi.pl -B's merge job runs
it after its build jobs: the restores (the native decoder, the device
layout), the gap walk (kernel K1), the interleave, the copy back, the
run-length encoder and the writer.

Set-up draws one genome from the seed's stream 0 and chunk c's pairs
from its stream 3 + c, writes each chunk's two FASTQ files and builds
each chunk's `.fmd` with `Pipeline.build_index`, as -B's build jobs do;
then it frees the card and resets its peak counter, so that the run's
device peak is the merges'.  Each unit overwrites one merged `.fmd`, but
the unit drawn from the seed among the first `keep_units` is kept aside.
The check holds the kept file and the last unit's to each other byte for
byte, decodes the last with the frozen decoder (reference/rld.py) and
holds its BWT and header counts to the BWT that reference/bwt.py works
out from the chunks' reads in order: chunk 0's mates 1 and 2, then chunk
1's, as `merge` puts its first index's reads first.

Every file of the cell lives in RAM, in a memfd opened by its
/proc/self/fd path as any file: a check's disk is full with the index
cell alone.  The disk bytes the process wrote (/proc/self/io) are logged.
"""

import os
import time

import numpy as np
import torch

from portbench import judge, reads
from portbench.harness import log


def _disk_write_bytes():
    """The bytes this process has sent to storage, or None where
    /proc/self/io cannot be read."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


class RamFiles:
    """Files in RAM by name: each a memfd, opened by path."""

    def __init__(self):
        self.fds = {}

    def new(self, name):
        """A fresh empty file under `name` (the old one closed); its
        path."""
        self.close(name)
        self.fds[name] = os.memfd_create(name)
        return self.path(name)

    def path(self, name):
        return f"/proc/self/fd/{self.fds[name]}"

    def rename(self, a, b):
        """File `a` under the name `b` (the old `b` closed)."""
        self.close(b)
        self.fds[b] = self.fds.pop(a)

    def empty(self, name):
        os.ftruncate(self.fds[name], 0)

    def read(self, name):
        """The file's bytes, or None where it is missing or empty."""
        if name not in self.fds:
            return None
        return judge.read_bytes(self.path(name)) or None

    def close(self, name):
        fd = self.fds.pop(name, None)
        if fd is not None:
            os.close(fd)

    def close_all(self):
        for name in list(self.fds):
            self.close(name)


class Driver:
    def __init__(self, cfg, traffic, seed, device, workdir, spans, seconds):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.spans, self.wd = device, spans, workdir
        self.n_inputs = int(cfg["inputs"])
        self.keep = int(reads.rng_for(seed, 2).integers(
            0, int(traffic["keep_units"])))
        self.files = RamFiles()
        self.chunks = [f"chunk{c}.fmd" for c in range(self.n_inputs)]
        self.symbols = 0
        self.n_units = 0

    def setup(self):
        from fermi_tpu_torch.pipeline import driver

        with self.spans("generate"):
            g = reads.genome(reads.rng_for(self.seed, 0), self.cfg)
        self.reads = []
        for c, fmd in enumerate(self.chunks):
            fq = [self.files.new(f"chunk{c}_{m}.fq") for m in (1, 2)]
            with self.spans("generate"):
                r1, r2 = reads.pairs(reads.rng_for(self.seed, 3 + c), g,
                                     self.cfg, fq)
            self.reads.append(np.concatenate([r1, r2]))
            del r1, r2
            with self.spans("build"):
                driver.Pipeline(os.path.join(self.wd, f"chunk{c}"),
                                device=self.device).build_index(
                    iter(()), self.files.new(fmd), paths=fq)
            for m in (1, 2):
                self.files.close(f"chunk{c}_{m}.fq")
        del g
        self.files.new("unit.fmd")
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        log("disk", after="setup", write_bytes=_disk_write_bytes())

    def run_unit(self, i):
        from fermi_tpu_torch import spans as program
        from fermi_tpu_torch.algos import merge as mg
        from fermi_tpu_torch.cli import main as cli

        self.files.empty("unit.fmd")    # a unit that writes nothing shows
        out = self.files.path("unit.fmd")
        t0 = time.time_ns()
        with self.spans("cli_merge"):
            rc = cli.main(["merge", "-f", "-t", "8", "--device",
                           str(self.device), "-o", out,
                           *map(self.files.path, self.chunks)])
        if rc:
            raise RuntimeError(f"fermi merge exited with {rc}")
        # the program's merge and its parts on the benchmark's time line,
        # so that the trace's idle gaps are named by them
        rows = [r for r in program.rows()
                if r.end_ns is not None and r.start_ns >= t0]
        roots = {r.index for r in rows if r.name == "merge"}
        for r in rows:
            if r.index in roots or r.parent in roots:
                self.spans.add(r.name, r.start_ns, r.end_ns,
                               3 + (r.index not in roots))
        if i < 0:
            return
        self.symbols += mg.fmd_counts(out)[0]
        self.n_units += 1
        if i == self.keep:
            self.files.rename("unit.fmd", "kept.fmd")
            self.files.new("unit.fmd")

    def counters(self):
        return {"merged_symbols": self.symbols}

    def work(self):
        return {"index_msym_per_s": self.symbols / 1e6}

    def release(self):
        for fmd in self.chunks:
            self.files.close(fmd)

    def check(self):
        from fermi_tpu_torch.algos import merge as mg

        log("merge", last_unit=mg.FILE_STATS)
        dev = self.device
        try:
            ref, counts = judge.reference_of(
                self.reads[0], np.concatenate(self.reads[1:]), dev)
            names = ["unit.fmd" if self.n_units != self.keep + 1
                     else "kept.fmd"]
            if self.n_units > self.keep + 1:
                names.append("kept.fmd")
            raws = [self.files.read(n) for n in names]
        finally:
            self.files.close_all()
        unit_mismatch = sum(r is None for r in raws) + \
            sum(r != raws[0] for r in raws[1:] if r is not None)
        bwt_mismatch, count_mismatch = judge.fmd_mismatch(raws[0], ref,
                                                          counts, dev)
        del raws
        log("disk", after="check", write_bytes=_disk_write_bytes())
        bad = bwt_mismatch + count_mismatch + unit_mismatch > 0
        return ({"bwt_mismatch": (bwt_mismatch, 0),
                 "count_mismatch": (count_mismatch, 0),
                 "unit_mismatch": (int(unit_mismatch), 0)},
                self.n_units, int(bad))
