"""One run of one cell, from ``BENCHMARK.json`` and the files it names
to the result line.

Everything a cell is made of is found by name: the configuration in the
file its ``configs`` entry names, the traffic in
``portbench/mixes/<traffic>.json``, each per-layer metric in
``portbench/metrics/<name>.py``.  A run, in order: the card's check; the
builds (the port's native code through ``binder_torch.fastio_build``,
the client under ``portbench/_build/``); the zone from the seed, bulk-
loaded into the ZooKeeper stand-in; the deployment; every worker's
native zone table resident; the probe sockets matched to workers; the
churn and a warm-up with the cell's traffic; the window; the
teardown; the reference's verdict on the replies and the writes; the
result.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import shutil
import socket
import sys
import tempfile
import time

import numpy as np

from portbench.harness import BUILD_DIR, ROOT, client, deploy, procs, stats
from portbench.harness import traffic, zone as zonemod
from portbench.harness.churn import PROBE_DTYPE, TIMED_DTYPE, WRITE_DTYPE
from portbench.reference import dnswire
from portbench.reference.answers import ChurnLog, ZoneReference
from portbench.reference.judge import Judge

FORBIDDEN = ("jax", "jaxlib", "flax", "binder_tpu", "__graft_entry__")
#: the seed's substream of the reference's sample
STREAM_SAMPLE = 3
#: probe sockets tried when matching them to workers
PROBE_CANDIDATES = 400
#: how long the warm-up's client waits for its last replies
WARMUP_GRACE_S = 0.5
#: the readings of a server that are levels, not counts
GAUGES = ("zone_entries", "mirror_names")


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and what it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return load_json(os.path.join(self.root, "portbench", "mixes",
                                      f"{name}.json"))

    def metrics(self, cell: str, kind: str):
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]


def load_metric(name: str, root: str = ROOT):
    """The reader module ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cache_dirs() -> None:
    """Every build cache under the checkout, at a fixed path."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD_DIR,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD_DIR, "triton")


def build_native() -> dict:
    """The port's native artifacts a deployment runs, built or found in
    ``binder_torch/_build/`` (key-addressed), and the client."""
    from binder_torch import fastio_build
    t0 = time.monotonic()
    built = fastio_build.build_all(("extension", "mbalancer",
                                    "instance_adjust"))
    blast = client.build()
    return {"seconds": time.monotonic() - t0, "blast": blast,
            "compiled": sorted(k for k, (_, s) in built.items()
                               if s is not None)}


def zk_standin(tree: str, tmp: str):
    log_path = os.path.join(tmp, "zk.log")
    proc = procs.spawn(["-m", "portbench.harness.zk_testserver", "0", tree],
                       log_path)
    m = procs.wait_line(proc, log_path,
                        re.compile(rb"listening on [\d.]+:(\d+)"),
                        "ZooKeeper stand-in", 120)
    return proc, int(m.group(1))


def match_probes(dep: deploy.Deployment, port: int, per_worker: int,
                 first_net: int, domain: str):
    """For each worker, ``per_worker`` probe addresses (each the first
    host of its own /24 of 127/8) with a fixed source port that reach
    it: a candidate socket asks eight queries and the worker whose
    completed count rose by eight is its worker."""
    groups = [[] for _ in dep.workers]
    wire = dnswire.encode_query(zonemod.churn_name(0, domain), dnswire.A)
    for c in range(PROBE_CANDIDATES):
        if all(len(g) >= per_worker for g in groups):
            return groups
        addr = f"127.{first_net + (c >> 8)}.{c & 255}.1"
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.bind((addr, 0))
            s.connect(("127.0.0.1", port))
            s.settimeout(2.0)
            before = [deploy.scrape(w["mport"])["completed"]
                      for w in dep.workers]
            for _ in range(8):
                s.send(wire)
                s.recv(65535)
            after = [deploy.scrape(w["mport"])["completed"]
                     for w in dep.workers]
            src_port = s.getsockname()[1]
        rose = [k for k, (a, b) in enumerate(zip(before, after))
                if b - a >= 8]
        if len(rose) == 1 and len(groups[rose[0]]) < per_worker:
            groups[rose[0]].append([addr, src_port])
    raise RuntimeError(f"probe sockets reach workers {[len(g) for g in groups]}"
                       f" after {PROBE_CANDIDATES} candidates")


def take_reading(dep: deploy.Deployment, pids: dict) -> dict:
    cpu = {}
    for role, pid in pids.items():
        try:
            cpu[role] = procs.cpu_seconds(pid)
        except (OSError, IndexError, ValueError):
            cpu[role] = None
    workers = [deploy.scrape(w["mport"]) for w in dep.workers]
    bal = dep.balancer_stats()
    return {"t": time.monotonic(), "cpu": cpu, "workers": workers,
            "balancer": bal}


def reading_delta(a: dict, b: dict) -> dict:
    """What happened between two readings, as the metric readers get it."""
    out = {"window_s": b["t"] - a["t"], "cpu": {}, "workers": [],
           "balancer": None}
    for role, v in b["cpu"].items():
        if v is not None and a["cpu"].get(role) is not None:
            out["cpu"][role] = v - a["cpu"][role]
    for wa, wb in zip(a["workers"], b["workers"]):
        d = {k: wb[k] - wa[k] for k in wb
             if isinstance(wb[k], float) and k != "zone_entries"}
        d["native_install_buckets"] = {
            le: n - wa["native_install_buckets"].get(le, 0.0)
            for le, n in wb["native_install_buckets"].items()}
        out["workers"].append(d)
    if a["balancer"] is not None and b["balancer"] is not None:
        fa = sum(x.get("forwarded", 0) for x in a["balancer"]["backends"])
        fb = sum(x.get("forwarded", 0) for x in b["balancer"]["backends"])
        out["balancer"] = {"forwarded": fb - fa}
    return out


def judge_run(seed: int, zone: zonemod.Zone, templates, sched_tmpl, recs,
              blob, churn_out: str, mix: dict, t0: float, t_end: float):
    """The reference's verdict: ``(numbers compared, details)``;
    ``sched_tmpl`` is the template of each entry of the window's
    schedule."""
    ref = ZoneReference(zone.domain, zone.nodes)
    fresh_limit = mix["churn"]["fresh_limit_s"]
    logs = {}
    for k in range(zone.churn_names):
        logs[zonemod.churn_name(k, zone.domain)] = ChurnLog(
            zonemod.host_json(zonemod.churn_first_addr(k)))
    writes = np.fromfile(os.path.join(churn_out, "writes.bin"), WRITE_DTYPE)
    for row in writes:
        logs[zonemod.churn_name(int(row["k"]), zone.domain)].add(
            float(row["t_sent"]), float(row["t_ack"]),
            zonemod.host_json(zonemod.churn_addr(int(row["w"]))))
    judge = Judge(ref, logs, fresh_limit)
    in_window = (recs["t_due"] >= t0) & (recs["t_due"] < t_end)
    answered = recs["answered"] == 1
    # every reply's rcode, TC bit and question, against the reference
    want_rcode = np.array([ref.expect(n, t).rcode
                           for n, t in templates.question], np.int64)
    tmpl = sched_tmpl[recs["entry"]]
    bad_header = answered & ((recs["rcode"] != want_rcode[tmpl])
                             | (recs["tc"] != 0) | (recs["qmatch"] != 1))
    # a sample of the window's replies, whole, drawn from the seed
    rng = np.random.default_rng([seed, STREAM_SAMPLE])
    pool = np.flatnonzero(in_window & answered)
    take = rng.choice(pool, min(int(mix["check_sample"]), pool.size),
                      replace=False)
    wrong, wrong_at = [], set(np.flatnonzero(bad_header).tolist())
    for i in take:
        r = recs[i]
        data = blob[int(r["reply_off"]):int(r["reply_off"])
                    + int(r["reply_len"])]
        qname, qtype = templates.question[int(tmpl[i])]
        # the client matched the reply to its query by socket and id
        why = judge(data, None, qname, qtype, float(r["t_sent"]),
                    float(r["t_reply"]))
        if why:
            wrong.append(f"{qname} {qtype}: {why}")
            wrong_at.add(int(i))
    # every probe reply: the churned names
    probes = np.fromfile(os.path.join(churn_out, "probes.bin"), PROBE_DTYPE)
    with open(os.path.join(churn_out, "probes.rep"), "rb") as f:
        pblob = f.read()
    n_probes_wrong = 0
    for p in probes:
        data = pblob[int(p["off"]):int(p["off"]) + int(p["len"])]
        qname = zonemod.churn_name(int(p["k"]), zone.domain)
        why = judge(data, int(p["qid"]), qname, dnswire.A,
                    float(p["t_send"]), float(p["t_recv"]))
        if why:
            wrong.append(f"probe {qname}: {why}")
            n_probes_wrong += 1
    timed = np.fromfile(os.path.join(churn_out, "timed.bin"), TIMED_DTYPE)
    checks = {
        "wrong": (len(wrong_at) + n_probes_wrong, 0),
        "missing": (int((in_window & ~answered).sum()), 0),
        "stale": (int(np.isnan(timed["t_fresh"]).sum()), 0),
    }
    details = {"judged": int(take.size) + int(probes.size),
               "headers_checked": int(answered.sum()),
               "wrong_headers": int(bad_header.sum()),
               "wrong_examples": wrong[:5]}
    return checks, details


def make_inputs(cfg: dict, mix: dict, seed: int, tmp: str):
    """The zone of ``seed`` and the client's templates and sources, in
    files under ``tmp``: ``(zone, templates, files)``."""
    zone = zonemod.Zone(cfg["zone"], seed)
    files = {"tree": os.path.join(tmp, "tree.json"),
             "templates": os.path.join(tmp, "templates.bin"),
             "sources": os.path.join(tmp, "sources.txt")}
    zone.write_tree(files["tree"])
    templates = traffic.Templates(mix, zone)
    templates.write(files["templates"])
    with open(files["sources"], "w") as f:
        f.write("".join(traffic.source_addr(k) + "\n"
                        for k in range(int(mix["sources"]))))
    return zone, templates, files


def boot_resident(cfg: dict, zone: zonemod.Zone, zk_port: int,
                  tmp: str):
    """The configuration's deployment, once every worker is filled, and
    what its boot read: the seconds to serving and to filled, and each
    worker's native zone table against the zone's address answers."""
    t_boot = time.monotonic()
    short = [os.environ.get("TMPDIR"), os.environ.get("HOME"),
             os.environ.get("XDG_CACHE_HOME"), ROOT, tempfile.gettempdir()]
    dep = deploy.boot(cfg, zk_port, tmp, short)
    served_s = time.monotonic() - t_boot
    got = dep.wait_resident(zone.names(), t_boot + deploy.BOOT_DEADLINE_S)
    entries = 2 * zone.host_like_leaves()
    tables = [int(e) for _, e in got]
    boot = {"serving_s": served_s,
            "filled_s": time.monotonic() - t_boot,
            "names": zone.names(), "mirror_names": [int(m) for m, _ in got],
            "entries": entries, "tables": tables,
            "short": [entries - t for t in tables]}
    log(f"deployment serving after {served_s:.3f}s, filled after "
        f"{boot['filled_s']:.3f}s: zone tables {tables} of {entries} "
        f"entries, short {boot['short']}")
    return dep, boot


def start_churn(dep: deploy.Deployment, zone: zonemod.Zone, mix: dict,
                zk_port: int, tmp: str, out_dir: str, fault=None):
    """The registrar's process (:mod:`portbench.harness.churn`), its
    probe sockets matched to the workers, once it is ready."""
    ch = mix["churn"]
    groups = match_probes(dep, dep.port, ch["probe_per_worker"],
                          ch["probe_first_net"], zone.domain)
    os.makedirs(out_dir)
    spec = {"zk_port": zk_port, "dns_port": dep.port,
            "domain": zone.domain, "names": zone.churn_names,
            "writes_per_s": ch["writes_per_s"],
            "timed_every": ch["timed_every"],
            "fresh_limit_s": ch["fresh_limit_s"],
            "probe_period_s": ch["probe_period_s"],
            "probe_max_per_round": ch["probe_max_per_round"],
            "groups": groups, "out_dir": out_dir}
    if fault is not None:
        spec = fault.churn_spec(spec, tmp)
    spec_path = os.path.join(tmp, "churn.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(tmp, "churn.log")
    with open(log_path, "wb") as err:
        churn = procs.subprocess.Popen(
            [sys.executable, "-m", "portbench.harness.churn", spec_path],
            cwd=ROOT, stdin=procs.subprocess.PIPE,
            stdout=procs.subprocess.PIPE, stderr=err)
    if churn.stdout.readline().strip() != b"ready":
        raise RuntimeError(f"churn did not start: {procs.tail(log_path)}")
    return churn


class Run:
    """The state of one run, torn down by :meth:`close` whatever
    happened."""

    def __init__(self, args, card, t_start: float, root: str = ROOT,
                 fault=None):
        self.args, self.card, self.t_start = args, card, t_start
        self.bench = Bench(root)
        self.fault = fault
        self.dep = None
        self.tmp = None

    def teardown(self) -> list:
        """Stop every process of the run; the pids of any left."""
        if self.fault is not None:
            self.fault.close()
        if self.dep is not None:
            try:
                self.dep.stop()
            except Exception as e:        # teardown goes on regardless
                log(f"stopping the deployment: {e!r}")
            if getattr(self.dep, "rundir", None):
                shutil.rmtree(self.dep.rundir, ignore_errors=True)
            self.dep = None
        return procs.stop_children()

    def close(self) -> list:
        left = self.teardown()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
        return left

    def execute(self) -> dict:
        a = self.args
        cell = self.bench.cell(a.workload)
        cfg = self.bench.config(cell["config"])
        mix = self.bench.mix(cell["traffic"])
        device = self.card.check(int(cell["chips"]))
        log(f"card: {self.card.power()}")
        procs.child_subreaper()
        cache_dirs()
        build = build_native()
        log(f"builds: {json.dumps(build)}")

        self.tmp = tmp = tempfile.mkdtemp(prefix="portbench-")
        zone, templates, files = make_inputs(cfg, mix, a.seed, tmp)
        window = traffic.schedule(mix, templates, a.seed, a.seconds)
        warm = traffic.schedule(mix, templates, a.seed, mix["warmup_s"],
                                traffic.STREAM_WARMUP)
        files["schedule"] = os.path.join(tmp, "schedule.bin")
        window.tofile(files["schedule"])
        warm_files = dict(files, schedule=os.path.join(tmp, "warm.bin"))
        warm.tofile(warm_files["schedule"])

        zk, zk_port = zk_standin(files["tree"], tmp)
        self.dep, boot = boot_resident(cfg, zone, zk_port, tmp)
        dep = self.dep
        churn_out = os.path.join(tmp, "churn")
        churn = start_churn(dep, zone, mix, zk_port, tmp, churn_out,
                            self.fault)

        port = dep.port
        if self.fault is not None:
            port = self.fault.front(dep.port, tmp)
        if a.trace:
            self.card.trace_start()
        # the warm-up: the cell's traffic for warmup_s, its replies
        # waited for briefly and not judged
        warm_c = client.Clients(build["blast"], port, warm_files, mix,
                                mix["warmup_s"], os.path.join(tmp, "warm"),
                                grace_s=WARMUP_GRACE_S)
        t_warm = time.monotonic() + 0.05
        t0 = t_warm + mix["warmup_s"] + WARMUP_GRACE_S + 1.0
        t_end = t0 + a.seconds
        churn.stdin.write(f"go {t0!r} {t_end!r}\n".encode())
        churn.stdin.flush()
        warm_c.go(t_warm)
        win_c = client.Clients(build["blast"], port, files, mix, a.seconds,
                               os.path.join(tmp, "window"))
        warm_recs, _, _ = warm_c.finish(timeout=60)
        warm_answered = int(warm_recs["answered"].sum())
        if time.monotonic() >= t0:
            raise RuntimeError("the warm-up ran past the window's start")
        win_c.go(t0)
        pids = dep.pids()
        pids.update(zk=zk.pid, churn=churn.pid, harness=os.getpid())
        pids.update(win_c.pids())
        setup_s = t0 - self.t_start
        time.sleep(max(0.0, t0 - time.monotonic()))
        r0 = take_reading(dep, pids)
        if a.trace:
            self.card.util_start()
        time.sleep(max(0.0, t_end - time.monotonic()))
        r1 = take_reading(dep, pids)
        util = self.card.util_stop() if a.trace else None
        recs, blob, totals = win_c.finish(
            timeout=mix["grace_s"] + 60)
        churn.stdin.close()
        churn_sum = json.loads(churn.stdout.read().decode().strip()
                               .splitlines()[-1])
        churn.wait(timeout=60)

        # the program's device path, on the window's latencies
        in_window = (recs["t_due"] >= t0) & (recs["t_due"] < t_end)
        if not in_window.any():
            raise RuntimeError("no query was due in the window")
        answered = recs["answered"] == 1
        lat_ms = ((recs["t_reply"] - recs["t_due"]) * 1e3)[
            in_window & answered]
        summary = self.card.summary(lat_ms.tolist() or [0.0])
        trace = self.card.trace_stop() if a.trace else None
        device["memory_peak_bytes"] = self.card.memory_peak()
        left = self.teardown()
        if left:
            raise RuntimeError(f"processes left after teardown: {left}")

        delta = reading_delta(r0, r1)
        delta["gpu_util"] = util
        delta["boot"] = boot
        host_cpus = len(os.sched_getaffinity(0))
        busy = {role: cpu / delta["window_s"]
                for role, cpu in delta["cpu"].items()}
        print("portbench: processes " + json.dumps(
            {"host_cpus": host_cpus, "busy": busy,
             "client": totals, "churn": churn_sum,
             "warmup_answered": warm_answered, "summary": summary,
             "built": build, "boot": boot}), flush=True)

        t_judge = time.monotonic()
        checks, details = judge_run(a.seed, zone, templates,
                                    window["tmpl"].astype(np.int64), recs,
                                    blob, churn_out, mix, t0, t_end)
        details["seconds"] = time.monotonic() - t_judge
        log("reference: " + json.dumps(details))

        n_due = int(in_window.sum())
        timed = np.fromfile(os.path.join(churn_out, "timed.bin"),
                            TIMED_DTYPE)
        values = client_values(recs, timed, t0, t_end)
        values["setup_s"] = setup_s
        delta["client"] = {k: (v if finite(v) else None)
                           for k, v in values.items()}
        print("portbench: window " + json.dumps(delta["client"]),
              flush=True)
        first_try = answered & (recs["retries"] == 0) & (recs["rcode"] == 0) \
            & (recs["tc"] == 0) & (recs["qmatch"] == 1)
        failed = int((in_window & ~first_try).sum()) \
            + int(np.isnan(timed["t_fresh"]).sum())
        result = {"correct": all(v <= lim for v, lim in checks.values()),
                  "attempted": n_due + int(timed.size), "failed": failed}
        if a.trace:
            delta["trace"] = trace
            metrics = {}
            for m in self.bench.metrics(a.workload, "per_layer"):
                value = load_metric(m["name"], self.bench.root).read(delta)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["metrics"] = metrics
            device["busy_s"] = trace["busy_s"]
            device["window_s"] = trace["window_s"]
            result["device"] = device
            result["breakdown"] = {"device_ops": trace["device_ops"],
                                   "idle_gaps": trace["idle_gaps"]}
        else:
            result["metrics"] = self.end_to_end(values)
            result["device"] = device
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        return result

    def end_to_end(self, values: dict) -> dict:
        """The end-to-end metrics this cell reports, from ``values``."""
        out = {}
        for m in self.bench.metrics(self.args.workload, "end_to_end"):
            v = values[m["name"]]
            # a query or write never answered makes a tail infinite: no
            # number, and the run is not correct
            out[m["name"]] = {"value": v if finite(v) else None,
                              "unit": m["unit"]}
        return out


def client_values(recs, timed, t0: float, t_end: float) -> dict:
    """What the clients saw in the window: ``qps``, the right replies
    that arrived in it over its seconds; ``p99_ms`` over every query due
    in it, from its due time, a query never answered counting as
    infinite; ``freshness_p99_ms`` over its timed writes, one never read
    back counting as infinite."""
    in_window = (recs["t_due"] >= t0) & (recs["t_due"] < t_end)
    answered = recs["answered"] == 1
    right = answered & (recs["rcode"] == 0) & (recs["tc"] == 0) \
        & (recs["qmatch"] == 1)
    arrived = (recs["t_reply"] >= t0) & (recs["t_reply"] < t_end)
    lat = np.where(answered, recs["t_reply"] - recs["t_due"], np.inf)
    fresh = np.where(np.isnan(timed["t_fresh"]), np.inf, timed["t_fresh"])
    return {"qps": float((right & arrived).sum()) / (t_end - t0),
            "p99_ms": stats.rank_percentile(lat[in_window], 99) * 1e3,
            "freshness_p99_ms": stats.rank_percentile(fresh, 99) * 1e3}


def forbidden_modules():
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def main(args, card, t_start: float, root: str = ROOT, fault=None) -> int:
    """One run; prints the result line and returns the exit code."""
    from portbench.harness.device import NoCard
    run = Run(args, card, t_start, root, fault)
    try:
        result = run.execute()
    except NoCard as e:
        log(f"no card: {e}")
        run.close()
        return 2
    except Exception:
        import traceback
        traceback.print_exc()
        left = run.close()
        if left:
            log(f"processes left: {left}")
        return 1
    left = run.close()
    if left:
        log(f"processes left after teardown: {left}")
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or its package loaded: {bad}")
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def finite(x: float) -> bool:
    return not (math.isinf(x) or math.isnan(x))
