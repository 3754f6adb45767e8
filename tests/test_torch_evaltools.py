"""The port's evaluation tools (fermi_tpu_torch/misc/evaltools.py) against
fermi_tpu's, on the inputs of tests/test_evaltools.py: the same output
bytes, called directly and through main(argv)."""

import gzip
import io

import pytest

from fermi_tpu.misc import evaltools as jev
from fermi_tpu_torch.misc import evaltools as tev

SAM = """@SQ\tSN:chr1\tLN:10000
c1\t0\tchr1\t101\t60\t10S90M\t*\t0\t0\t{}\t*\tNM:i:3
c2\t16\tchr1\t201\t60\t100M\t*\t0\t0\t{}\t*\tNM:i:0
c3\t4\t*\t0\t0\t*\t*\t0\t0\t{}\t*
""".format("A" * 100, "C" * 100, "G" * 200)

BREAK_SAM = "\n".join([
    "@SQ\tSN:chr1\tLN:100000",
    "u1\t0\tchr1\t1001\t60\t200M300S\t*\t0\t0\t" + "A" * 500 + "\t*",
    "u1\t0\tchr1\t1301\t60\t200S300M\t*\t0\t0\t" + "A" * 500 + "\t*",
    "u2\t4\t*\t0\t0\t*\t*\t0\t0\t" + "C" * 400 + "\t*",
    "u3\t0\tchr1\t5001\t5\t250M250S\t*\t0\t0\t" + "T" * 500 + "\t*",
    "u3\t16\tchr1\t9001\t60\t250S220M30H\t*\t0\t0\t" + "T" * 470 + "\t*",
]) + "\n"

ASQG = "\n".join([
    "HT\tVN:i:1",
    "VT\tv0\tACGTACGTAC",
    "VT\tv1\tGTACGGGGTT",
    "ED\tv0 v1 6 9 10 0 3 10 0 0".replace(" ", "\t"),
]) + "\n"

CASES = {
    "sam2iden": (SAM, lambda m, p, out: m.sam2iden(p, out), ["sam2iden"]),
    "sam2break": (BREAK_SAM, lambda m, p, out: m.sam2break(p, out=out),
                  ["sam2break"]),
    "sam2break_p": (BREAK_SAM, lambda m, p, out: m.sam2break(
        p, min_len=100, max_gap=300, min_q=20, is_print=True, out=out),
        ["sam2break", "-l", "100", "-g", "300", "-q", "20", "-p"]),
    "asqg2mag": (ASQG, lambda m, p, out: m.asqg2mag(p, out), ["asqg2mag"]),
}


def _fermi(tool, path):
    out = io.StringIO()
    CASES[tool][1](jev, path, out)
    return out.getvalue()


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("tool", sorted(CASES))
def test_tool_bytes_equal(tmp_path, tool, gz):
    text = CASES[tool][0]
    path = tmp_path / ("in.gz" if gz else "in.txt")
    path.write_bytes(gzip.compress(text.encode()) if gz else text.encode())
    out = io.StringIO()
    CASES[tool][1](tev, str(path), out)
    assert out.getvalue() == _fermi(tool, str(path))
    assert out.getvalue()


@pytest.mark.parametrize("tool", sorted(CASES))
def test_main(tmp_path, capsys, tool):
    path = tmp_path / "in.txt"
    path.write_text(CASES[tool][0])
    assert tev.main([*CASES[tool][2], str(path)]) == 0
    assert capsys.readouterr().out == _fermi(tool, str(path))


def test_asqg2mag_rejects_gapped_overlap(tmp_path):
    path = tmp_path / "g.asqg"
    path.write_text(ASQG.replace("6\t9\t10\t0\t3", "6\t9\t10\t0\t4"))
    with pytest.raises(ValueError, match="gapped"):
        tev.asqg2mag(str(path), io.StringIO())
