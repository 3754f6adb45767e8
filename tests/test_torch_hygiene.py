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
    bad = [(os.path.relpath(p, ROOT), m) for p in srcs for m in _imported(p)
           if m.split(".")[0] in ("jax", "jaxlib", "fermi_tpu")]
    assert bad == []


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from fermi_tpu_torch import api
    from fermi_tpu_torch.cli.main import main
    from fermi_tpu_torch.construct.suffix_device import multistring_bwt_device
    from fermi_tpu_torch.index.fmd import FMDIndex
    from fermi_tpu_torch.rld import Runs

    bwt = np.array([1, 0, 2], np.uint8)
    fa = tmp_path / "r.fa"
    fa.write_text(">r\nACGT\n")
    calls = [lambda: api.build_index(["ACGT"]),
             lambda: api.save_index(["ACGT"], str(tmp_path / "x.fmd")),
             lambda: api.load_index(str(tmp_path / "x.fmd")),
             lambda: FMDIndex.from_bwt(bwt),
             lambda: FMDIndex.from_runs(Runs.from_bwt(bwt)),
             lambda: multistring_bwt_device(np.array([1, 0], np.uint8)),
             lambda: main(["build", "-fo", str(tmp_path / "y.fmd"), str(fa)])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "y.fmd").exists()
