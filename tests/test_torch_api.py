"""The port's embedding API (fermi_tpu_torch.api: read_seqs, write_seqs,
seq_len_quantile, unitig, clean, write_mag) and the CLI `example` built on
it, against fermi_tpu on the CPU: strings and bytes, tolerance zero."""

import contextlib
import gzip
import io

import numpy as np
import pytest
import torch

from fermi_tpu import api as japi
from fermi_tpu.cli.main import main as jmain
from fermi_tpu_torch import api as tapi
from fermi_tpu_torch.cli.main import main as tmain

from native_lock import load_fermi_tpu_native
from util import revcomp_str

torch.set_num_threads(1)
load_fermi_tpu_native()


def _reads(seed=3, n=240, glen=2000, err=0.01, with_n=False):
    """Reads of 40-80 bp from a random genome, either strand, with
    substitutions at low quality; with_n: one in 50 carries an N."""
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, glen))
    seqs, quals = [], []
    for i in range(n):
        ln = int(rng.integers(40, 81))
        p = int(rng.integers(0, glen - ln))
        s = list(genome[p:p + ln])
        q = ["I"] * ln
        for j in np.flatnonzero(rng.random(ln) < err):
            s[j] = "ACGT"[rng.integers(0, 4)]
            q[j] = "+"
        if with_n and i % 50 == 7:
            s[ln // 2] = "N"
        s = "".join(s)
        seqs.append(s if rng.random() < 0.5 else revcomp_str(s))
        quals.append("".join(q))
    return seqs, quals


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A FASTQ of the reads, and a gzipped lower-case FASTA of them with N
    in a few (`clean` of a graph from reads with N raises KeyError in
    fermi_tpu and the port alike: ROADMAP §3, F3)."""
    d = tmp_path_factory.mktemp("api")
    seqs, quals = _reads()
    fq, fa = d / "r.fq", d / "r.fa.gz"
    fq.write_text("".join(f"@r{i} c{i}\n{s}\n+\n{q}\n"
                          for i, (s, q) in enumerate(zip(seqs, quals))))
    fa.write_bytes(gzip.compress("".join(
        f">r{i}\n{s.lower()}\n"
        for i, s in enumerate(_reads(with_n=True)[0])).encode()))
    return str(fq), str(fa)


def test_read_write_seqs_and_quantile(files):
    """read_seqs of FASTQ and gzipped FASTA (qualities filled with Q20),
    write_seqs with and without qualities, and length quantiles."""
    for path in files:
        got = tapi.read_seqs(path)
        assert got == japi.read_seqs(path) and len(got[0]) == 240
        for quals in (got[1], None):
            a, b = io.StringIO(), io.StringIO()
            tapi.write_seqs(got[0], quals, a)
            japi.write_seqs(got[0], quals, b)
            assert a.getvalue() == b.getvalue()
        for q in (0.0, 0.25, 0.5, 0.99):
            assert tapi.seq_len_quantile(got[0], q) == \
                japi.seq_len_quantile(got[0], q)


@pytest.mark.parametrize("min_match", [-1, 25])
def test_unitig_clean_write_mag(files, min_match):
    """api.unitig (auto-sized and given), then api.clean plain and
    aggressive with an override, through write_mag: fermi_tpu's bytes."""
    seqs, _ = tapi.read_seqs(files[0])
    g_t = tapi.unitig(seqs, min_match, device="cpu")
    g_j = japi.unitig(seqs, min_match)
    assert _mag(tapi, g_t) == _mag(japi, g_j) and _mag(tapi, g_t).count("@")
    for kw in (dict(), dict(aggressive=True, min_ovlp=30)):
        tapi.clean(g_t, **kw)
        japi.clean(g_j, **kw)
        assert _mag(tapi, g_t) == _mag(japi, g_j)


def _mag(api, g):
    out = io.StringIO()
    api.write_mag(g, out)
    return out.getvalue()


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), [ln for ln in err.getvalue().splitlines()
                                if not ln.startswith("[M::main]")]


@pytest.mark.parametrize("flags", [["-U"], [], ["-l", "30", "-c"],
                                   ["-e", "-c"], ["-e", "-k", "17", "-U"]])
def test_cli_example(files, flags):
    """`example` with -U (reads out), plain (unitigs, k chosen from the
    lengths), -c (cleaned) and -e (corrected first: the device collect, on
    the CPU here, and the host fix): fermi_tpu's bytes and messages."""
    got = _run(tmain, ["example", "--device", "cpu", *flags, files[0]])
    want = _run(jmain, ["example", *flags, files[0]])
    assert got[0] == 0 and got[1:] == want[1:] and got[1]
    assert ("choose k-mer size" in "".join(got[2])) == \
        ("-U" not in flags and "-l" not in flags)
