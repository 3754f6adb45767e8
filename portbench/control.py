"""The control of the benchmark's check: runs of a cell in which the port's
BWT builder is replaced by the plain reference's, with the sentinels not
ordered by their place in the text (every sentinel the same symbol, as a
generic suffix sort of the concatenated reads would take them).  That
breaks the guarantee that every cell's configuration states, fermi's
multi-string BWT, and the check has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds <n,n,...> \\
        [--seconds 1]

runs the control on each seed, one after another in this process, and
prints one JSON line a seed with the numbers the check compared.  The
benchmark's own runs never run this.
"""

import contextlib
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_bwt(text, device=None):
    """The control's BWT of a text: the reference's, sentinels unordered."""
    from portbench.reference import bwt as ref_bwt

    return ref_bwt.bwt_of_text(text, device or "cuda",
                               sentinels_ordered=False).cpu().numpy()


@contextlib.contextmanager
def controlled():
    """The port's BWT builder replaced by control_bwt while inside."""
    from fermi_tpu_torch.construct import blocked

    orig = blocked.device_bwt
    blocked.device_bwt = control_bwt
    try:
        yield
    finally:
        blocked.device_bwt = orig


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)

    from portbench import harness

    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        with controlled():
            rc, res = harness.run(a.workload, seed, a.seconds, 0, "cuda",
                                  t)
        if rc:
            return rc
        sys.stdout.write(json.dumps(
            {"workload": a.workload, "seed": seed,
             "correct": res["correct"], "checks": res["checks"],
             "metrics": res["metrics"]}) + "\n")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
