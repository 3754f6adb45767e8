"""The benchmark of fermi_tpu_torch on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or `python3 -m portbench.run ...`), from the root of a checkout.  Runs
one cell of BENCHMARK.json: set-up, one warm-up unit, whole units back to
back until `--seconds` have passed (with `--trace 1` at most 20, under
the profiler), then the check of what the window produced against the
plain reference.  The last line of standard output
is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` a `breakdown`, and last `checks`, each number
compared beside its limit.  Without as many CUDA devices as the cell
asks for it exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    # run as a file: import from the checkout's root, not from this
    # directory, whose module names (trace, ...) would shadow others
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.Cell(a.workload)
    need = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        sys.stderr.write(
            f"portbench: {a.workload} needs {need} CUDA device(s); "
            f"found {torch.cuda.device_count()}: no result\n")
        return 2
    rc, result = harness.run(a.workload, a.seed, a.seconds, a.trace,
                             "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        sys.stderr.write(f"portbench: the JAX side was loaded: {bad}: "
                         "no result\n")
        return 3
    if result is not None:
        sys.stdout.write(json.dumps(result) + "\n")
        sys.stdout.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
