"""Find a configuration's knee: one boot, then load steps.

    python3 portbench/sweep.py --config <name> --mix <name> --seed <n> \
        [--step-seconds 10] [--closed 256:2,512:2] \
        [--fractions 0.6,0.7,0.8,0.9,1.0] [--rates 800,1000]

Boots the configuration as a run of the benchmark does (zone from the
seed, the ZooKeeper stand-in, the deployment, the churn of the mix),
then drives one open-loop step at each rate of ``--rates``
(queries/s); then closed-loop saturating steps, one for each
``inflight:client processes`` of ``--closed``, the first of which gives
the capacity; then one open-loop step at each fraction of that
capacity.  Each step prints one
JSON line: offered and answered rate, p50 and p99 from the due time
(unanswered queries as infinite), queries never answered, retried, the
generator's lateness, and each process's busy share.  It judges no
reply: the cells' runs do.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from portbench.harness import cell, client, procs, stats  # noqa: E402
from portbench.harness import traffic  # noqa: E402


def step(blast, port, files, mix, seconds, tmp, name, pids):
    c = client.Clients(blast, port, files, mix, seconds,
                       os.path.join(tmp, name))
    t0 = time.monotonic() + 0.2
    c.go(t0)
    pids = dict(pids, **c.pids())
    time.sleep(max(0.0, t0 - time.monotonic()))
    cpu0 = {r: procs.cpu_seconds(p) for r, p in pids.items()}
    time.sleep(max(0.0, t0 + seconds - time.monotonic()))
    cpu1 = {r: procs.cpu_seconds(p) for r, p in pids.items()}
    recs, _, totals = c.finish(timeout=mix["grace_s"] + 60)
    t_end = t0 + seconds
    due = (recs["t_due"] >= t0) & (recs["t_due"] < t_end)
    ans = recs["answered"] == 1
    right = ans & (recs["rcode"] == 0) & (recs["tc"] == 0) \
        & (recs["qmatch"] == 1)
    arrived = (recs["t_reply"] >= t0) & (recs["t_reply"] < t_end)
    lat = np.where(ans, recs["t_reply"] - recs["t_due"], np.inf)[due]
    return {"step": name, "offered_qps": float(due.sum()) / seconds,
            "qps": float((right & arrived).sum()) / seconds,
            "p50_ms": stats.rank_percentile(lat, 50) * 1e3,
            "p99_ms": stats.rank_percentile(lat, 99) * 1e3,
            "missing": int((due & ~ans).sum()),
            "retried": int((due & (recs["retries"] > 0)).sum()),
            "not_right": int((ans & ~right).sum()),
            "late_max_s": max(t["late_max_s"] for t in totals),
            "busy": {r: (cpu1[r] - cpu0[r]) / seconds for r in cpu1}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench-sweep")
    ap.add_argument("--config", required=True)
    ap.add_argument("--mix", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--step-seconds", type=float, default=10.0)
    ap.add_argument("--closed", default="256:2")
    ap.add_argument("--fractions", default="0.6,0.7,0.8,0.9,1.0")
    ap.add_argument("--rates", default="")
    a = ap.parse_args(argv)
    bench = cell.Bench()
    cfg = bench.config(a.config)
    mix = bench.mix(a.mix)
    procs.child_subreaper()
    cell.cache_dirs()
    build = cell.build_native()
    tmp = tempfile.mkdtemp(prefix="portbench-sweep-")
    dep = None
    try:
        zone, templates, files = cell.make_inputs(cfg, mix, a.seed, tmp)
        zk, zk_port = cell.zk_standin(files["tree"], tmp)
        dep, _ = cell.boot_resident(cfg, zone, zk_port, tmp)
        churn = cell.start_churn(dep, zone, mix, zk_port, tmp,
                                 os.path.join(tmp, "churn"))
        closed_steps = [tuple(int(v) for v in x.split(":"))
                        for x in a.closed.split(",") if x]
        fractions = [float(x) for x in a.fractions.split(",") if x]
        rates = [float(x) for x in a.rates.split(",") if x]
        now = time.monotonic()
        # the churn writes until its standard input closes, after the
        # last step
        churn.stdin.write(f"go {now!r} {now + 86400.0!r}\n".encode())
        churn.stdin.flush()
        pids = dep.pids()
        pids.update(zk=zk.pid, churn=churn.pid)
        capacity = None

        def open_step(k, name, rate):
            opened = dict(mix, loop="open", rate_qps=rate)
            ofiles = dict(files, schedule=os.path.join(tmp, f"open{k}.bin"))
            traffic.schedule(opened, templates, a.seed + k + 1,
                             a.step_seconds).tofile(ofiles["schedule"])
            out = step(build["blast"], dep.port, ofiles, opened,
                       a.step_seconds, tmp, name, pids)
            print(json.dumps(out), flush=True)

        for k, r in enumerate(rates):
            open_step(k, f"open@{r:g}", r)
        for k, (inflight, nprocs) in enumerate(closed_steps):
            closed = dict(mix, loop="closed", inflight=inflight,
                          client_procs=nprocs)
            cfiles = dict(files, schedule=os.path.join(tmp, f"c{k}.bin"))
            traffic.schedule(closed, templates, a.seed,
                             a.step_seconds).tofile(cfiles["schedule"])
            sat = step(build["blast"], dep.port, cfiles, closed,
                       a.step_seconds, tmp, f"closed{inflight}:{nprocs}",
                       pids)
            capacity = capacity or sat["qps"]
            print(json.dumps(sat), flush=True)
        for k, fr in enumerate(fractions):
            open_step(len(rates) + k, f"open{fr}", fr * capacity)
        churn.stdin.close()
        print(churn.stdout.read().decode().strip(), flush=True)
    finally:
        if dep is not None:
            dep.stop()
        left = procs.stop_children()
        shutil.rmtree(tmp, ignore_errors=True)
        if getattr(dep, "rundir", None):
            shutil.rmtree(dep.rundir, ignore_errors=True)
    print(json.dumps({"left": left}), flush=True)
    return 1 if left else 0


if __name__ == "__main__":
    sys.exit(main())
