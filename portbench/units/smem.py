"""Units of kind "smem": one `smem_all` call of a batch of fresh queries
against an index resident on the device, as `fermi exact` makes its calls
(one call a chunk of its queries; the mix's `batch` is that chunk).

Set-up draws the genome and the read pairs from the seed, writes them as
two FASTQ files, has the port index them by `Pipeline.build_index` (the
raw_fmd route) and restores the `.fmd` with `FMDIndex.restore`, as an
`exact` user does.  It draws the window's batches before the window.  The
check works out the index again from the reads (reference/bwt.py) and
holds the port's `.fmd` and the restored index's counts to it, then
searches a sample of the window's queries, drawn from the seed, with
reference/smem.py on that index.
"""

import os

import numpy as np

from portbench import judge, reads
from portbench.reference import smem as ref_smem

POOL_READS_PER_S = 10000        # batches drawn for up to this rate


class Driver:
    def __init__(self, cfg, traffic, seed, device, workdir, spans, seconds):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.spans, self.seconds = device, spans, seconds
        self.wd = workdir
        self.fq = [os.path.join(workdir, f"reads_{m}.fq") for m in (1, 2)]
        self.fmd = os.path.join(workdir, "index.fmd")
        self.pick = reads.rng_for(seed, 2)
        self.kept = []           # (query row, its SMEMs) drawn to be checked
        self.n_reads = 0

    def setup(self):
        from fermi_tpu_torch.index.fmd import FMDIndex
        from fermi_tpu_torch.pipeline import driver

        cfg, tr = self.cfg, self.traffic
        with self.spans("generate"):
            rng = reads.rng_for(self.seed, 0)
            self.genome = reads.genome(rng, cfg)
            self.r1, self.r2 = reads.pairs(rng, self.genome, cfg, self.fq)
        with self.spans("build"):
            driver.Pipeline(os.path.join(self.wd, "build"),
                            device=self.device).build_index(
                iter(()), self.fmd, paths=self.fq)
        with self.spans("restore"):
            self.index = FMDIndex.restore(self.fmd, self.device)
            self.cnt = self.index.cnt.cpu().numpy().astype(np.int64)
        with self.spans("generate"):
            trng = reads.rng_for(self.seed, 1)
            b, ql = int(tr["batch"]), int(tr["query_len"])
            self.n_batches = max(2, -(-int(POOL_READS_PER_S * self.seconds)
                                      // b))
            self.queries = reads.queries(trng, self.genome,
                                         b * (self.n_batches + 1), ql,
                                         tr["sub_rate"])

    def run_unit(self, i):
        """Batch 0 warms up; unit i searches batch 1 + i (cycling).  Of
        each unit's answers only `check_sample` reads drawn from the seed
        are kept: holding every answer would grow the heap that Python's
        collector walks, where `exact` writes each answer out and drops
        it."""
        from fermi_tpu_torch.search import smem

        b = int(self.traffic["batch"])
        row = 0 if i < 0 else b * (1 + i % self.n_batches)
        seqs = list(self.queries[row: row + b])
        with self.spans("smem_all"):
            res = smem.smem_all(self.index, seqs)
        if i < 0:
            return
        self.n_reads += len(res)
        keep = self.pick.choice(b, min(b, int(self.traffic["check_sample"])),
                                replace=False)
        self.kept += [(row + r, res[r]) for r in keep.tolist()]

    def counters(self):
        from fermi_tpu_torch.ops import rank_cuda
        from fermi_tpu_torch.search import smem

        return {"smem_reads": smem.STATS["reads"],
                "smem_redo": smem.STATS["redo"],
                "k1_launches": sum(rank_cuda.LAUNCHES.values()),
                "maxi": getattr(self.index, "_smem_maxi", None) or 0}

    def work(self):
        return {"smem_reads_per_s": self.n_reads}

    def release(self):
        self.index = None

    def check(self):
        ref, counts = judge.reference_of(self.r1, self.r2, self.device)
        bwt_mismatch, count_mismatch = judge.fmd_mismatch(
            judge.read_bytes(self.fmd), ref, counts, self.device)
        cum = np.concatenate([[0], np.cumsum(counts[1:])])
        count_mismatch += int(np.abs(self.cnt[:7] - cum).sum())
        idx = ref_smem.Index(ref)
        del ref
        k = min(int(self.traffic["check_sample"]), len(self.kept))
        sample = self.pick.choice(len(self.kept), k, replace=False)
        smem_mismatch = 0
        for t in sorted(sample.tolist()):
            row, got = self.kept[t]
            if got != ref_smem.smems(idx, self.queries[row]):
                smem_mismatch += 1
        return ({"bwt_mismatch": (bwt_mismatch, 0),
                 "count_mismatch": (count_mismatch, 0),
                 "smem_mismatch": (smem_mismatch, 0)},
                self.n_reads, smem_mismatch)
