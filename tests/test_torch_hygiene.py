"""The port stands alone: no jax or fermi_tpu import in fermi_tpu_torch or
chip_smoke.py, and its entry points never fall back to the CPU unasked."""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for d, _, files in os.walk(os.path.join(ROOT, "fermi_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_jax_or_fermi_tpu_imports():
    srcs = list(_sources())
    assert len(srcs) > 15
    rel = {os.path.relpath(p, ROOT) for p in srcs}
    for f in ("dist/sharded.py", "dist/launch.py", "misc/evaltools.py",
              "graft_entry.py", "index/mmapfmd.py", "index/blkidx.py"):
        assert os.path.join("fermi_tpu_torch", f) in rel
    bad = [(os.path.relpath(p, ROOT), m) for p in srcs for m in _imported(p)
           if m.split(".")[0] in ("jax", "jaxlib", "fermi_tpu")]
    assert bad == []


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from fermi_tpu_torch import api
    from fermi_tpu_torch.algos.contrast import fm6_contrast
    from fermi_tpu_torch.algos.merge import fm_append_streaming, fm_merge
    from fermi_tpu_torch.algos.sub import fm_sub
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.construct.bcr_device import bcr_bwt_device
    from fermi_tpu_torch.construct.blocked import device_build_text
    from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device
    from fermi_tpu_torch.construct.wsort import wsort_bwt
    from fermi_tpu_torch.graft_entry import dryrun_multichip, entry
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.ops.sw_cuda import sw_score_batch
    from fermi_tpu_torch.pipeline.driver import Pipeline
    from fermi_tpu_torch.rld import Runs
    from fermi_tpu_torch.search.ecfix_device import build_device_table
    from fermi_tpu_torch.search.unitig_links import compute_links_device

    bwt = np.array([1, 0, 2], np.uint8)
    fa = tmp_path / "r.fa"
    fa.write_text(">r\nACGT\n")
    long_fa = tmp_path / "long.fa"
    long_fa.write_text(">q\n" + "ACGT" * 200 + "\n")
    calls = [lambda: api.build_index(["ACGT"]),
             lambda: api.save_index(["ACGT"], str(tmp_path / "x.fmd")),
             lambda: api.load_index(str(tmp_path / "x.fmd")),
             lambda: FMDIndex.from_bwt(bwt),
             lambda: FMDIndex.from_runs(Runs.from_bwt(bwt)),
             lambda: multistring_bwt_device(np.array([1, 0], np.uint8)),
             lambda: main(["build", "-fo", str(tmp_path / "y.fmd"), str(fa)]),
             lambda: api.correct(["ACGT"]),
             lambda: sw_score_batch([np.array([1], np.int8)],
                                    [np.array([1], np.int8)]),
             lambda: build_device_table(np.zeros(1, np.int64),
                                        np.zeros(1, np.uint32),
                                        np.zeros(1, np.uint8), 17),
             lambda: main(["correct", str(tmp_path / "x.fmd"), str(fa)]),
             lambda: main(["seqsort", str(tmp_path / "x.fmd")]),
             lambda: main(["seqrank", str(tmp_path / "x.fmd")]),
             lambda: main(["unitig", str(tmp_path / "x.fmd")]),
             lambda: main(["unitig", "-t", "4", str(tmp_path / "x.fmd")]),
             lambda: fm_append_streaming(str(tmp_path / "x.fmd"), bwt,
                                         str(tmp_path / "y.fmd")),
             lambda: compute_links_device(None, [np.ones(40, np.uint8)], 30),
             lambda: main(["merge", "-fo", str(tmp_path / "m.fmd"),
                           str(tmp_path / "x.fmd"), str(tmp_path / "x.fmd")]),
             lambda: main(["sub", str(tmp_path / "x.fmd"),
                           str(tmp_path / "x.bits")]),
             lambda: main(["contrast", *[str(tmp_path / f) for f in (
                 "x.fmd", "x.rank", "x.sub", "x.fmd", "x.rank", "y.sub")]]),
             lambda: main(["build", "-fo", str(tmp_path / "y.fmd"), "-i",
                           str(tmp_path / "x.fmd"), str(fa)]),
             lambda: fm_merge(FMDIndex.from_bwt(bwt), bwt,
                              FMDIndex.from_bwt(bwt), bwt),
             lambda: fm_sub(FMDIndex.from_bwt(bwt), bwt, np.ones(1, bool)),
             lambda: fm6_contrast(FMDIndex.from_bwt(bwt),
                                  FMDIndex.from_bwt(bwt), 31, 3),
             lambda: wsort_bwt(bwt[::-1]),
             lambda: device_build_text(bwt[::-1]),
             lambda: bcr_bwt_device([bwt[:1]]),
             lambda: Pipeline(str(tmp_path / "p")),
             lambda: main(["run", "-p", str(tmp_path / "p"), str(fa)]),
             lambda: main(["chkbwt", "-r", str(tmp_path / "x.fmd")]),
             lambda: main(["exact", str(tmp_path / "x.fmd"), str(long_fa)]),
             lambda: main(["run", "-P", "-p", str(tmp_path / "p"), str(fa)]),
             lambda: main(["scaf", str(tmp_path / "x.fmd"), str(fa), "240",
                           "20"]),
             lambda: main(["example", str(fa)]),
             lambda: main(["example", "-e", "-U", str(fa)]),
             lambda: api.unitig(["ACGT"]),
             lambda: main(["ropebwt", "-a", "bcr", str(fa)]),
             lambda: main(["ropebwt", "-a", "sais", "-b", str(fa)]),
             lambda: dryrun_multichip(2),
             lambda: entry()]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "y.fmd").exists()
    assert not (tmp_path / "m.fmd").exists()
    assert not (tmp_path / "y.sub").exists()
    assert not list(tmp_path.glob("p.*"))


def test_host_commands_run_without_cuda(no_cuda, tmp_path, capfdbinary):
    """clean, bitand, recode, remap, fltuniq, `ropebwt -a bpr` and every
    command with -M are host code: they take no device and run with no
    CUDA present (remap restores its index on the CPU and takes the
    contigs' SMEMs from the native engine; -M queries the index off disk)."""
    from fermi_tpu_torch import rld
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.construct import suffix
    from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device
    from fermi_tpu_torch.core import dna

    rng = np.random.default_rng(3)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 700))
    reads = [genome[p:p + 60] for p in range(0, 640, 5)]
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * 60}\n"
                          for i, r in enumerate(reads)))
    fmd = str(tmp_path / "r.fmd")
    text = suffix.build_text([dna.encode(r) for r in reads])
    rld.write_fmd(rld.Runs.from_bwt(multistring_bwt_device(text, "cpu")),
                  fmd)
    contigs = tmp_path / "c.fa"
    contigs.write_text(f">c\n{genome}\n")
    assert main(["fltuniq", "-k", "15", str(fq)]) == 0
    assert main(["remap", fmd, str(contigs)]) == 0
    assert main(["recode", fmd]) == 0
    assert main(["ropebwt", "-a", "bpr", str(fq)]) == 0
    out = capfdbinary.readouterr()
    assert 100 < out.out.count(b"@r") <= len(reads) and b"\n@c\n" in out.out
    assert b"[M::remap] avg" in out.err
    rank = str(tmp_path / "r.rank")
    assert main(["seqsort", "-M", "-t", "2", fmd]) == 0
    with open(rank, "wb") as f:
        f.write(capfdbinary.readouterr().out)
    for argv in (["unpack", "-M", "-i", "3", fmd],
                 ["exact", "-M", fmd, str(fq)],
                 ["correct", "-M", "-k", "15", fmd, str(fq)],
                 ["seqrank", "-M", fmd],
                 ["unitig", "-M", "-t", "2", "-l", "30", "-r", rank, fmd],
                 ["remap", "-M", "-r", rank, fmd, str(contigs)]):
        assert main(argv) == 0, argv
        assert capfdbinary.readouterr().out, argv
    assert main(["chkbwt", "-M", "-r", fmd]) == 0
    assert b"rank check passed" in capfdbinary.readouterr().err
