"""The deployments a configuration names by its ``layout``: boot, the
readings the per-layer metrics take, and teardown.

- ``shards``: ``python -m binder_torch.main`` with ``shards`` set, the
  port's reuseport group (docs/operations.md:59-87): a supervisor that
  holds the ZooKeeper session and the mirror, and workers on one port.
- ``topology``: ``python -m binder_torch.topology start -n N``, the
  shipped layout (upstream ``boot/setup.sh:145-149``): N servers, each
  with its own session and mirror, under ``instance_adjust``, behind
  ``mbalancer`` on the public port.

Both take the configuration's rendered ``options`` with its
``overrides`` on top, each printed; ``{zk_port}`` in an override is the
stand-in's port.
"""
from __future__ import annotations

import json
import os
import random
import re
import socket
import subprocess
import sys
import time
import urllib.request

from portbench.harness import ROOT, procs

BOOT_DEADLINE_S = 240.0
#: a worker is filled once its mirror holds every name of the zone and
#: its native zone table's count has not moved for this long
SETTLE_S = 3
#: a UNIX socket path holds at most 107 bytes and its terminating NUL
SUN_PATH_MAX = 107


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def write_options(cfg: dict, zk_port: int, path: str) -> str:
    options = json.loads(json.dumps(cfg["options"]))
    for key, value in cfg["overrides"].items():
        if value == "{zk_port}":
            value = zk_port
        *parents, leaf = key.split(".")
        node = options
        for name in parents:
            node = node[name]
        node[leaf] = value
        log(f"override: {key} = {json.dumps(value)}")
    with open(path, "w") as f:
        json.dump(options, f)
    return path


def http_get(port: int, path: str, timeout: float = 5.0) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read()


#: what a reading takes of a server's ``/metrics``
FAMILIES = {
    "completed": "binder_requests_completed",
    "zone_serves": "binder_zone_serves",
    "cache_hits": "binder_answer_cache_hits",
    "zone_entries": "binder_zone_entries",
    "mirror_names": "binder_mirror_names",
    "rrl_dropped": "binder_rrl_dropped_total",
    "rrl_slipped": "binder_rrl_slipped_total",
    "loop_lag_max_s": "binder_loop_lag_max_seconds",
}
NATIVE_INSTALL = re.compile(
    r'^binder_propagation_seconds_bucket\{[^}]*stage="native-install"'
    r'[^}]*le="([^"]+)"\} (\S+)$')


def scrape(mport: int) -> dict:
    """One reading of a server: the sums of :data:`FAMILIES`, the Python
    answer cache's own hits (``/status``), and the cumulative buckets
    of ``binder_propagation_seconds{stage="native-install"}``."""
    text = http_get(mport, "/metrics").decode()
    out = dict.fromkeys(FAMILIES, 0.0)
    by_family = {fam: key for key, fam in FAMILIES.items()}
    buckets = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        fam = line.split("{", 1)[0].split(" ", 1)[0]
        key = by_family.get(fam)
        if key is not None:
            out[key] += float(line.rsplit(" ", 1)[1])
            continue
        m = NATIVE_INSTALL.match(line)
        if m:
            buckets[m.group(1)] = buckets.get(m.group(1), 0.0) \
                + float(m.group(2))
    out["native_install_buckets"] = buckets
    status = json.loads(http_get(mport, "/status"))
    out["python_cache_hits"] = float(
        status.get("answer_cache", {}).get("hits", 0))
    return out


class Deployment:
    """A booted deployment: its public ``port``, its ``workers`` (each
    ``{"pid", "mport"}``, the processes that answer), its other
    processes by role (``roles``), and how to stop it."""

    def __init__(self):
        self.port = None
        self.workers = []
        self.roles = {}
        self.sockdir = None

    def pids(self) -> dict:
        out = dict(self.roles)
        for k, w in enumerate(self.workers):
            out[f"worker{k}"] = w["pid"]
        return out

    def balancer_stats(self):
        if self.sockdir is None:
            return None
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.settimeout(2)
            c.connect(os.path.join(self.sockdir, ".balancer.stats"))
            buf = b""
            while True:
                chunk = c.recv(65536)
                if not chunk:
                    break
                buf += chunk
        return json.loads(buf)

    def wait_resident(self, names: int, deadline: float) -> list:
        """Until every worker is filled: its mirror holds the zone's
        ``names`` and its native zone table's count is unchanged over
        :data:`SETTLE_S`.  Returns each worker's ``(mirror names, zone
        table entries)``."""
        history = []
        while True:
            got = []
            for w in self.workers:
                try:
                    r = scrape(w["mport"])
                    got.append((r["mirror_names"], r["zone_entries"]))
                except (OSError, ValueError):
                    got.append((0.0, 0.0))
            history = (history + [got])[-int(SETTLE_S) - 1:]
            if len(history) > SETTLE_S and all(h == got for h in history) \
                    and all(m >= names for m, _ in got):
                return got
            if time.monotonic() > deadline:
                raise RuntimeError(f"(mirror names, zone table entries) "
                                   f"{got}, zone of {names} names, at the "
                                   "boot deadline")
            time.sleep(1.0)

    def stop(self) -> None:
        pass


class Shards(Deployment):
    def __init__(self, cfg: dict, zk_port: int, tmp: str):
        super().__init__()
        options = write_options(cfg, zk_port, os.path.join(tmp,
                                                            "config.json"))
        self.log = os.path.join(tmp, "group.log")
        group = procs.spawn(["-m", "binder_torch.main", "-f", options, "-p",
                             "0"], self.log)
        self.roles["supervisor"] = group.pid
        self.proc = group
        m = procs.wait_line(group, self.log,
                            re.compile(rb"UDP DNS service started on "
                                       rb"[\d.]+:(\d+)"),
                            "shard group", BOOT_DEADLINE_S)
        self.port = int(m.group(1))
        mport = int(procs.wait_line(
            group, self.log, re.compile(rb"metrics server started on port "
                                        rb"(\d+)"),
            "shard group", 10).group(1))
        want = cfg["processes"]["workers"]
        deadline = time.monotonic() + BOOT_DEADLINE_S
        while True:
            try:
                workers = json.loads(http_get(mport, "/status"))[
                    "shards"]["workers"]
            except (OSError, ValueError, KeyError):
                workers = []
            if len(workers) == want and all(
                    w.get("up") and w.get("metrics_port") for w in workers):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"shard group: {len(workers)} of {want} "
                                   "workers up")
            time.sleep(0.2)
        self.workers = [{"pid": w["pid"], "mport": w["metrics_port"]}
                        for w in workers]

    def stop(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def port_free(port: int) -> bool:
    for kind in (socket.SOCK_DGRAM, socket.SOCK_STREAM):
        with socket.socket(socket.AF_INET, kind) as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                return False
    return True


def free_base(n: int) -> int:
    """A base port ``B`` with ``B .. B+n-1`` and their metrics ports
    (each + 1000) free, below the kernel's ephemeral range (copied from
    ``chip_smoke.py``)."""
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20_000, 29_000)
        if all(port_free(p) for k in range(n)
               for p in (base + k, base + 1000 + k)):
            return base
    raise RuntimeError("no free range of ports")


def short_dir(candidates, prefix: str) -> str:
    """A new directory under the shortest of ``candidates``, so that the
    balancer's socket paths under it fit a UNIX socket address."""
    import tempfile
    parent = min((c for c in candidates if c and os.path.isdir(c)),
                 key=len)
    path = tempfile.mkdtemp(prefix=prefix, dir=parent)
    # <path>/sockets/.balancer.stats is the longest name under it
    if len(os.path.join(path, "sockets", ".balancer.stats")) > SUN_PATH_MAX:
        os.rmdir(path)
        raise RuntimeError(f"no directory short enough for the balancer's "
                           f"sockets: {path}")
    return path


class Topology(Deployment):
    def __init__(self, cfg: dict, zk_port: int, tmp: str, short: str):
        super().__init__()
        n = cfg["processes"]["backends"]
        options = write_options(cfg, zk_port, os.path.join(tmp,
                                                            "config.json"))
        self.rundir = short
        self.sockdir = os.path.join(short, "sockets")
        base = free_base(n)
        self.log = os.path.join(tmp, "topology.log")
        with open(self.log, "wb") as out:
            rc = subprocess.run(
                [sys.executable, "-m", "binder_torch.topology", "start",
                 "-n", str(n), "-c", options, "-D", self.rundir, "-p", "0",
                 "--bind", "127.0.0.1", "-B", str(base)],
                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                timeout=BOOT_DEADLINE_S).returncode
        if rc != 0:
            raise RuntimeError(f"topology start exited {rc}: "
                               f"{procs.tail(self.log)}")

        def read_int(name):
            with open(os.path.join(self.rundir, name)) as f:
                return int(f.read().strip())

        self.port = read_int("balancer.port")
        self.roles["balancer"] = read_int("balancer.pid")
        self.workers = [{"pid": read_int(os.path.join(
                             "state", f"binder-{base + k}.pid")),
                         "mport": base + 1000 + k} for k in range(n)]
        deadline = time.monotonic() + BOOT_DEADLINE_S
        while True:
            try:
                up = [b for b in self.balancer_stats()["backends"]
                      if b["healthy"] and b.get("direct")]
            except (OSError, ValueError, KeyError):
                up = []
            if len(up) == n:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"balancer: {len(up)} of {n} backends "
                                   "healthy on direct return")
            time.sleep(0.2)

    def stop(self) -> None:
        subprocess.run([sys.executable, "-m", "binder_torch.topology",
                        "stop", "-D", self.rundir], cwd=ROOT,
                       capture_output=True, timeout=60)


def boot(cfg: dict, zk_port: int, tmp: str, short_parents) -> Deployment:
    layout = cfg["layout"]
    if layout == "shards":
        return Shards(cfg, zk_port, tmp)
    if layout == "topology":
        return Topology(cfg, zk_port, tmp,
                        short_dir(short_parents, "pb"))
    raise ValueError(f"unknown layout {layout!r}")
