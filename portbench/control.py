"""Run a cell with a fault planted under it, on one seed after another:
the check of every run has to read ``correct`` false.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <n> [--fault stale|drop_half|alter] [--trace 0|1]

``stale`` is the cell's control (``portbench/harness/faults.py``).  Each
run prints its result line as ``portbench/run.py`` does; the last line
is ``{"fault": ..., "correct": [...], "checks": [...]}``.  Exits 0 when
every run came out not correct, 1 otherwise.
"""
import argparse
import io
import json
import os
import sys
import time
from contextlib import redirect_stdout

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench-control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default="stale")
    ap.add_argument("--trace", type=int, default=0)
    a = ap.parse_args(argv)
    from portbench.harness import cell
    from portbench.harness.device import Card
    from portbench.harness.faults import FAULTS
    correct, checks = [], []
    for seed in (int(s) for s in a.seeds.split(",")):
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=a.seconds, trace=a.trace)
        out = io.StringIO()
        with redirect_stdout(out):
            rc = cell.main(args, Card(), time.monotonic(),
                           fault=FAULTS[a.fault]())
        lines = out.getvalue().strip().splitlines()
        print(lines[-1] if lines else "", flush=True)
        if rc != 0 or not lines:
            correct.append(None)
            checks.append(None)
            continue
        result = json.loads(lines[-1])
        correct.append(result["correct"])
        checks.append(result["checks"])
    print(json.dumps({"fault": a.fault, "workload": a.workload,
                      "correct": correct, "checks": checks}), flush=True)
    return 0 if all(c is False for c in correct) else 1


if __name__ == "__main__":
    sys.exit(main())
