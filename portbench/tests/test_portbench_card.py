"""The tiny cells on the card: the run, its trace, and the control.

    python3 -m pytest -m cuda portbench/tests/test_portbench_card.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", ["tiny.smem", "tiny.index"])
def test_tiny_cells_on_the_card(card, tiny_root, tmp_path, monkeypatch,
                                cell):
    import tempfile
    import time

    from portbench import control, harness

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc, res = harness.run(cell, 2**31 + 9, 0.5, 1, "cuda",
                          time.perf_counter(), root=tiny_root)
    assert rc == 0 and res["correct"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    idle = next(v for k, v in res["metrics"].items()
                if k.startswith("idle_share"))
    assert 0 <= idle["value"] < 100
    with control.controlled():
        rc, res = harness.run(cell, 2**31 + 9, 0.2, 0, "cuda",
                              time.perf_counter(), root=tiny_root)
    assert rc == 0 and not res["correct"]
