"""What the benchmark imports, and what it does without a card."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

PKG = os.path.join(ROOT, "portbench")
JAX_SIDE = {"jax", "jaxlib", "flax", "fermi_tpu"}


def _imports(path):
    """Top-level names of every module a file imports, whole."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


def _files(top):
    for d, _, names in os.walk(top):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_nothing_imports_the_jax_side():
    found = {p: _imports(p) & JAX_SIDE for p in _files(PKG)}
    assert not {p: s for p, s in found.items() if s}
    # a whole-name comparison: the port's name begins with the JAX
    # package's, and is allowed
    assert "fermi_tpu_torch" in set().union(*map(_imports, _files(PKG)))


def test_reference_imports_nothing_of_the_port():
    for p in _files(os.path.join(PKG, "reference")):
        assert not _imports(p) & {"fermi_tpu_torch", "fermi_tpu"}, p
        assert "portbench" not in _imports(p) - {"portbench"} or \
            all(not line.startswith("from portbench.units")
                for line in open(p))


def test_no_card_no_result(tmp_path):
    """Without CUDA the run exits with another code than 0 and prints
    nothing on standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "celegans.index", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the
    run fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "celegans.index", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
