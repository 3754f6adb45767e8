"""The generators repeat from a seed, and every seed draws the same
amount of work."""

import numpy as np

from conftest import TINY
from portbench import reads

CFG = dict(TINY, read_len=100, insert_mean=300, insert_sd=20,
           insert_min=110, insert_max=1000, sub_rate=0.01, sub_qual=14,
           qual=38)


def _draw(seed, tmp_path):
    rng = reads.rng_for(seed, 0)
    g = reads.genome(rng, CFG)
    paths = [str(tmp_path / f"{seed}_{m}.fq") for m in (1, 2)]
    r1, r2 = reads.pairs(rng, g, CFG, paths)
    q = reads.queries(reads.rng_for(seed, 1), g, 64, 100, 0.01)
    return g, r1, r2, q, [open(p, "rb").read() for p in paths]


def test_same_seed_same_data(tmp_path):
    a = _draw(2**31 + 5, tmp_path)
    b = _draw(2**31 + 5, tmp_path)
    for x, y in zip(a[:4], b[:4]):
        assert np.array_equal(x, y)
    assert a[4] == b[4]


def test_other_seed_same_sizes(tmp_path):
    a = _draw(1, tmp_path)
    b = _draw(2, tmp_path)
    assert not np.array_equal(a[1], b[1])
    for x, y in zip(a[:4], b[:4]):
        assert x.shape == y.shape
    assert [len(f) for f in a[4]] == [len(f) for f in b[4]]


def test_fastq_holds_the_reads(tmp_path):
    g, r1, r2, q, files = _draw(7, tmp_path)
    lines = files[1].split(b"\n")
    assert lines[0] == b"@p000000000/2" and lines[2] == b"+"
    seq = np.frombuffer(lines[1], np.uint8)
    assert np.array_equal(reads.ASCII[r2[0]], seq)
    assert len(files[0]) == CFG["n_pairs"] * (14 + 2 * 100 + 4)
    assert q.min() >= 1 and q.max() <= 4


def test_repeats_are_written():
    g = reads.genome(reads.rng_for(3, 0), CFG)
    assert g.size == CFG["genome_len"] and g.min() >= 0 and g.max() <= 3


def test_smem_batch_is_the_chunk_exact_calls_with(tmp_path, monkeypatch,
                                                  capsys):
    """A unit of the smem mix is one smem_all call of the size that
    `fermi exact` makes its calls with: the CLI driven on more queries
    than a batch hands smem_all chunks of `batch`."""
    import json
    import os

    from conftest import ROOT
    from fermi_tpu_torch.cli import main as cli
    from fermi_tpu_torch.pipeline import driver
    from fermi_tpu_torch.search import smem

    with open(os.path.join(ROOT, "portbench", "traffic",
                           "smem_fresh.json")) as f:
        batch = json.load(f)["batch"]
    rng = reads.rng_for(11, 0)
    g = reads.genome(rng, CFG)
    fq = [str(tmp_path / f"r{m}.fq") for m in (1, 2)]
    reads.pairs(rng, g, dict(CFG, n_pairs=50), fq)
    fmd = str(tmp_path / "i.fmd")
    driver.Pipeline(str(tmp_path / "b"), device="cpu").build_index(
        iter(()), fmd, paths=fq)
    fa = tmp_path / "q.fa"
    fa.write_text("".join(f">q{i}\nACGTACGTAC\n" for i in range(batch + 5)))
    sizes = []

    def smem_all(index, seqs, *a, **k):
        sizes.append(len(seqs))
        return [[] for _ in seqs]
    monkeypatch.setattr(smem, "smem_all", smem_all)
    assert cli.main(["exact", "--device", "cpu", fmd, str(fa)]) == 0
    capsys.readouterr()
    assert sizes == [batch, 5]
