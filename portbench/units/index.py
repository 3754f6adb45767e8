"""Units of kind "index": one `Pipeline.build_index` of the cell's two
FASTQ files to a `.fmd`, the port's raw_fmd route (the native read
encoders, the text, the BWT on the device, the run-length encoder, the
writer).

Set-up draws the genome and the pairs from the seed and writes the two
files under the run's directory.  Each unit overwrites one `.fmd` there,
but the unit drawn from the seed among the first `keep_units` is kept
aside.  The check holds the kept file and the last unit's to each other
byte for byte, decodes the last with the frozen decoder
(reference/rld.py) and holds its BWT and header counts to the BWT that
reference/bwt.py works out from the reads.
"""

import contextlib
import os
import time

from portbench import judge, reads

PARTS = ("frags_s", "text_s", "bwt_s", "rle_s", "dump_s")


class Driver:
    def __init__(self, cfg, traffic, seed, device, workdir, spans, seconds):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.spans, self.wd = device, spans, workdir
        self.fq = [os.path.join(workdir, f"reads_{m}.fq") for m in (1, 2)]
        self.out = os.path.join(workdir, "unit.fmd")
        self.keep = int(reads.rng_for(seed, 2).integers(
            0, int(traffic["keep_units"])))
        self.kept = os.path.join(workdir, "kept.fmd")
        self.symbols = 0
        self.n_units = 0
        self.parts = dict.fromkeys(PARTS + ("fmd_bytes",), 0.0)

    def setup(self):
        with self.spans("generate"):
            rng = reads.rng_for(self.seed, 0)
            g = reads.genome(rng, self.cfg)
            self.r1, self.r2 = reads.pairs(rng, g, self.cfg, self.fq)

    def run_unit(self, i):
        from fermi_tpu_torch.pipeline import driver

        p = driver.Pipeline(os.path.join(self.wd, "unit"),
                            device=self.device)
        with contextlib.suppress(FileNotFoundError):
            os.remove(self.out)         # a unit that writes nothing shows
        driver.BUILD_STATS.clear()     # a unit that builds nothing adds 0
        t0 = time.time_ns()
        with self.spans("build_index"):
            p.build_index(iter(()), self.out, paths=self.fq)
        st = dict(driver.BUILD_STATS)
        # the build's parts, each a host clock that ends on the host, as
        # spans of their own (the trace's idle gaps are named by them)
        at = t0
        for part in PARTS:
            end = at + int(st.get(part, 0.0) * 1e9)
            self.spans.add(part[:-2], at, end, 3)
            at = end
        if i < 0:
            return
        for part in PARTS:
            self.parts[part] += st.get(part, 0.0)
        self.symbols += int(st.get("symbols", 0))
        with contextlib.suppress(FileNotFoundError):
            self.parts["fmd_bytes"] += os.path.getsize(self.out)
        self.n_units += 1
        if i == self.keep:
            with contextlib.suppress(FileNotFoundError):
                os.replace(self.out, self.kept)

    def counters(self):
        return dict(self.parts)

    def work(self):
        return {"index_msym_per_s": self.symbols / 1e6}

    def release(self):
        pass

    def check(self):
        dev = self.device
        ref, counts = judge.reference_of(self.r1, self.r2, dev)
        files = [self.out if self.n_units != self.keep + 1 else self.kept]
        if self.n_units > self.keep + 1:
            files.append(self.kept)
        raws = [judge.read_bytes(p) for p in files]
        unit_mismatch = sum(r is None for r in raws) + \
            sum(r != raws[0] for r in raws[1:] if r is not None)
        bwt_mismatch, count_mismatch = judge.fmd_mismatch(raws[0], ref,
                                                          counts, dev)
        del raws
        bad = bwt_mismatch + count_mismatch + unit_mismatch > 0
        return ({"bwt_mismatch": (bwt_mismatch, 0),
                 "count_mismatch": (count_mismatch, 0),
                 "unit_mismatch": (int(unit_mismatch), 0)},
                self.n_units, int(bad))
