"""Run one cell of the benchmark of binder_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout on a machine with the chips the cell asks
for.  The cell, its configuration, its traffic mix and its metrics are
those ``BENCHMARK.json`` names.  The last line of standard output is the
result; the last lines of standard error are the numbers the reference
compared, each beside its limit.  Exits 2, printing no result, when CUDA
has fewer devices than the cell needs, and 1 on any other failure.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.harness import cell
    from portbench.harness.device import Card
    return cell.main(args, Card(), T_START)


if __name__ == "__main__":
    sys.exit(main())
