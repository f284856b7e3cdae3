"""The port's zone topology: ``python -m binder_torch.topology``.

The counterpart of ``tests/test_topology.py`` (which drives
``bin/binder-topology`` over ``native/build/`` and skips where that is
not built): ``binder_torch.topology`` builds ``instance_adjust`` and
``mbalancer`` into ``binder_torch/_build/``, starts port servers under
the reconciler behind the balancer, and is held here to the
reference's scenario (answers through the balancer, ``metric_ports``,
status, scale down, stop), to running only the port, to restoring a
killed instance, to the reference script's options, and to stopping on
a failed build.  The smoke's topology phase runs here at a small zone.
"""
import asyncio
import importlib
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time

import pytest

import chip_smoke
from binder_torch import fastio_build, topology
from binder_torch.dns import Message, Rcode, Type, make_query

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "bin", "binder-topology")
#: the topologies these tests start are several busy processes each;
#: they run at a low CPU priority (inherited by every instance) so that
#: they do not starve timing-sensitive tests running beside them
NICE = ["nice", "-n", "10"]


def run_topology(*args, timeout=120):
    return subprocess.run(
        NICE + [sys.executable, "-m", "binder_torch.topology", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def udp_ask(port, name, qid):
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(5)
        s.sendto(make_query(name, Type.A, qid=qid).encode(),
                 ("127.0.0.1", port))
        return s.recv(4096)


@pytest.fixture()
def zone(tmp_path):
    config = tmp_path / "config.json"
    fixture = tmp_path / "fixture.json"
    fixture.write_text(json.dumps({
        "/com/foo/web": {"type": "host", "host": {"address": "10.7.7.7"}},
    }))
    config.write_text(json.dumps({
        "dnsDomain": "foo.com", "datacenterName": "dc0",
        "host": "127.0.0.1",
        "store": {"backend": "fake", "fixture": str(fixture)},
    }))
    rundir = str(tmp_path / "run")
    yield rundir, str(config)
    run_topology("stop", "-D", rundir, timeout=60)


def start(rundir, config, n, baseport):
    proc = run_topology("start", "-n", str(n), "-c", config, "-D", rundir,
                        "-p", "0", "-B", str(baseport), "--bind",
                        "127.0.0.1")
    assert proc.returncode == 0, proc.stderr + proc.stdout
    with open(os.path.join(rundir, "balancer.port")) as f:
        return int(f.read())


def instance_pids(rundir):
    state = os.path.join(rundir, "state")
    out = {}
    for name in sorted(os.listdir(state)):
        if name.endswith(".pid"):
            with open(os.path.join(state, name)) as f:
                out[name[:-4]] = int(f.read())
    return out


def wait_answer(port, name, qid, deadline_s=10.0):
    """The first reply for ``name`` through the balancer (it finds new
    backends on its next directory scan, every second)."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return udp_ask(port, name, qid)
        except socket.timeout:
            assert time.monotonic() < deadline, f"no answer for {name}"


def test_full_zone_up_scale_down(zone):
    rundir, config = zone
    base = chip_smoke.free_base(2)
    port = start(rundir, config, 2, base)
    via = wait_answer(port, "web.foo.com", 7)
    m = Message.decode(via)
    assert m.rcode == Rcode.NOERROR
    assert m.answers[0].address == "10.7.7.7"
    # the balancer's reply is a port server's own
    assert via == udp_ask(base, "web.foo.com", 7)

    with open(os.path.join(rundir, "metric_ports")) as f:
        assert f.read().split() == [str(base + 1000), str(base + 1001)]
    out = run_topology("status", "-D", rundir).stdout
    assert out.count("online") == 3

    # scale down to 1: the reconciler removes the surplus instance
    start(rundir, config, 1, base)
    time.sleep(1.2)      # the balancer notices the socket left
    r = Message.decode(udp_ask(port, "web.foo.com", 8))
    assert r.rcode == Rcode.NOERROR
    state = os.path.join(rundir, "state")
    assert not os.path.exists(os.path.join(state, f"binder-{base + 1}.props"))
    assert os.path.exists(os.path.join(state, f"binder-{base}.props"))

    pids = list(instance_pids(rundir).values())
    with open(os.path.join(rundir, "balancer.pid")) as f:
        pids.append(int(f.read()))
    proc = run_topology("stop", "-D", rundir)
    assert proc.returncode == 0
    deadline = time.monotonic() + 15
    while any(chip_smoke.pid_running(p) for p in pids):
        assert time.monotonic() < deadline, "a process outlived stop"
        time.sleep(0.05)
    out = run_topology("status", "-D", rundir).stdout
    assert "online" not in out and "balancer: down" in out
    assert not os.listdir(os.path.join(rundir, "sockets")) or \
        os.listdir(os.path.join(rundir, "sockets")) == [".balancer.stats"]


def test_instances_run_the_port(zone):
    rundir, config = zone
    start(rundir, config, 2, chip_smoke.free_base(2))
    pids = instance_pids(rundir)
    assert len(pids) == 2
    for pid in pids.values():
        line = chip_smoke.cmdline(pid)
        assert "-m binder_torch.main" in line, line
        assert "binder_tpu" not in line, line


def test_sigkilled_instance_is_restored_by_next_start(zone):
    rundir, config = zone
    base = chip_smoke.free_base(2)
    port = start(rundir, config, 2, base)
    name = f"binder-{base + 1}"
    old = instance_pids(rundir)[name]
    os.kill(old, signal.SIGKILL)
    deadline = time.monotonic() + 10
    while chip_smoke.pid_running(old):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert f"{name}: dead" in run_topology("status", "-D", rundir).stdout
    proc = run_topology("start", "-n", "2", "-c", config, "-D", rundir,
                        "-p", "0", "-B", str(base), "--bind", "127.0.0.1")
    assert proc.returncode == 0, proc.stderr
    assert f"restore {name}" in proc.stdout
    # the balancer was alive and is left alone
    assert "balancer up" not in proc.stdout
    new = instance_pids(rundir)[name]
    assert new != old and chip_smoke.pid_running(new)
    assert "-m binder_torch.main" in chip_smoke.cmdline(new)
    assert run_topology("status", "-D", rundir).stdout.count("online") == 3
    m = Message.decode(udp_ask(base + 1, "web.foo.com", 9))
    assert m.answers[0].address == "10.7.7.7"
    m = Message.decode(wait_answer(port, "web.foo.com", 10))
    assert m.answers[0].address == "10.7.7.7"


async def balancer_join(package, sockdir):
    """Whether a balancer can connect to ``package``'s server on its
    balancer socket before its store's first session, and after."""
    server_mod = importlib.import_module(package + ".server")
    store_mod = importlib.import_module(package + ".store")
    collector = importlib.import_module(package + ".metrics.collector")
    store = store_mod.FakeStore()
    cache = store_mod.MirrorCache(store, "foo.com")
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "10.7.7.7"}})
    path = os.path.join(sockdir, package)
    server = server_mod.BinderServer(
        zk_cache=cache, dns_domain="foo.com", datacenter_name="dc0",
        host="127.0.0.1", port=0, balancer_socket=path,
        collector=collector.MetricsCollector(), query_log=False)
    await server.start()

    def connects():
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            try:
                c.connect(path)
                return True
            except ConnectionRefusedError:
                return False

    try:
        before = (os.path.exists(path), connects())
        store.start_session()
        await asyncio.sleep(0.3)
        return before, connects()
    finally:
        await server.stop()


@pytest.mark.parametrize("package", ["binder_torch", "binder_tpu"])
def test_backend_joins_the_balancer_once_its_mirror_is_whole(package,
                                                             tmp_path):
    # a backend restarted under the balancer inherits its predecessor's
    # clients: the port binds its socket at once (instance_adjust -w
    # waits for the file) but refuses the balancer until the mirror
    # holds the zone; the reference accepts at once and answers those
    # clients from an empty mirror
    before, after = asyncio.run(balancer_join(package, str(tmp_path)))
    assert before == (True, package == "binder_tpu")
    assert after is True


def help_options(command):
    """``{subcommand: option set}`` from ``--help`` of a topology CLI."""
    out = {}
    for sub in ("", "start", "stop", "status", "metric-ports"):
        text = subprocess.run(command + ([sub] if sub else []) + ["--help"],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=30).stdout
        out[sub] = set(re.findall(r"(?<![\w-])(--?[A-Za-z][\w-]*)", text))
    return out


def test_help_options_equal_the_reference():
    port = help_options([sys.executable, "-m", "binder_torch.topology"])
    reference = help_options([sys.executable, REFERENCE])
    assert port == reference
    assert port["start"] >= {"-n", "-c", "-D", "-p", "-B", "--bind"}


def test_failed_instance_adjust_build_stops_start(tmp_path, monkeypatch,
                                                  capsys):
    native = tmp_path / "native"
    shutil.copytree(os.path.join(ROOT, "native", "adjust"),
                    native / "adjust")
    with open(native / "adjust" / "instance_adjust.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(fastio_build, "NATIVE_DIR", str(native))
    monkeypatch.setattr(fastio_build, "BUILD_DIR", str(tmp_path / "build"))
    rundir = tmp_path / "run"
    with pytest.raises(SystemExit) as stop:
        topology.main(["start", "-n", "2", "-c", os.path.join(
            ROOT, "etc", "config.json"), "-D", str(rundir), "-p", "0",
            "-B", str(chip_smoke.free_base(2)), "--bind", "127.0.0.1"])
    assert stop.value.code != 0
    err = capsys.readouterr().err
    assert "instance_adjust" in err and "this is not C++" in err
    # nothing was started
    assert not rundir.exists()
    assert not os.path.exists(fastio_build.artifact_path("instance_adjust"))


TOPOLOGY_SMALL = """
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
native = {{}}
lat = chip_smoke.topology_phase(hosts=2000, n_udp=3000, backends=2,
                                native=native)
print(json.dumps({{"answered": len(lat), "native": native,
                  "left": chip_smoke.descendants(os.getpid())}}))
"""


def test_chip_smoke_topology_phase_on_the_cpu():
    # the smoke's topology phase at a small zone: 2 backends over the
    # port's ZooKeeper server, one relaying through the balancer's
    # cache and one on direct return, churn, a SIGKILL and its
    # restore, the query log checked line for line, stop
    out = subprocess.run(
        NICE + [sys.executable, "-c", TOPOLOGY_SMALL.format(root=ROOT)],
        cwd=ROOT, capture_output=True, timeout=300)
    lines = out.stdout.decode().splitlines()
    assert out.returncode == 0, (lines[-5:], out.stderr.decode()[-3000:])
    report = json.loads(next(x for x in lines
                             if x.startswith('{"topology"')))["topology"]
    assert report["errors"] == 0 and report["left_after_stop"] == []
    assert report["host_cpus"] == len(os.sched_getaffinity(0))
    assert report["udp_answered"] == 3000
    assert report["status_online"] == 3
    assert report["metric_ports"] == [report["base_port"] + 1000,
                                      report["base_port"] + 1001]
    assert report["churn"]["stale_samples"] == 0
    assert report["churn"]["all_read_back"]
    assert report["mbalancer"]["cache_invalidations"] > 0
    assert report["mbalancer"]["direct_forwards"] > 0
    killed = report["per_backend"][1]
    assert len(killed["pid"]) == 2 and killed["direct"]
    for backend in report["per_backend"]:
        assert backend["log_lines"] == backend["completed"] > 0
        assert backend["c_zone_hits"] + backend["c_cache_hits"] > 0
    # the 1 Hz series from the stream's start to the restored backend
    # serving: each second's client counts, per-process busy shares,
    # per-backend completions and the balancer's forwards, and the
    # summary that names a saturated process
    rows, summary = report["series"], report["series_summary"]
    assert rows and all(r["lost"] == 0 for r in rows)
    assert {"balancer", "zk", "smoke", "backend0"} <= \
        set(summary["busy_max"])
    assert sum(sum(x or 0 for x in r["completed"]) for r in rows) > 0
    assert any(r.get("forwarded") for r in rows)
    assert summary["kill_s"] < summary["restored_s"]
    assert summary["lost"] == 0 and "saturated" in summary
    got = json.loads(lines[-1])
    assert got["answered"] == 3000 and got["left"] == []


def test_topology_series_arithmetic():
    # three readings: backend 1 (the victim) killed after the first and
    # restarted with fresh counters by the third; the balancer's stats
    # missing from the second; the churn's acknowledgements beside them
    import chip_smoke

    def reading(answered, retries, lost, cpu, completed, sessions,
                forwarded, healthy):
        return {"client": {"answered": answered, "retries": retries,
                           "lost": lost},
                "cpu": cpu,
                "backends": {k: {"completed": c, "zk_connected": 1.0,
                                 "zk_sessions": sessions[k],
                                 "rebuilds": 0.0, "zk_outstanding": 0.0,
                                 "degraded": 0.0, "stalls": 0.0,
                                 "lag_max": 0.01}
                             for k, c in completed.items()},
                "balancer": None if forwarded is None else {
                    "forwarded": forwarded, "healthy": healthy,
                    "udp_queries": sum(forwarded.values()), "drops": 0,
                    "wq_overflows": 0, "backend_stalls": 0}}
    points = [
        (100.0, reading(0, 0, 0, {"balancer": 1.0, "backend1": 5.0},
                        {0: 10.0, 1: 20.0}, {0: 1.0, 1: 1.0},
                        {0: 10, 1: 20}, {0: True, 1: True})),
        (101.0, reading(900, 4, 0, {"balancer": 1.95, "backend1": 5.5},
                        {0: 400.0}, {0: 1.0, 1: 1.0},
                        {0: 410, 1: 24}, {0: True, 1: False})),
        (102.0, reading(1900, 4, 1, {"balancer": 2.9, "backend1": 0.4},
                        {0: 900.0, 1: 3.0}, {0: 1.0, 1: 1.0},
                        None, None)),
    ]
    rows, summary = chip_smoke.topology_series(
        points, 2, 99.5, kill_at=100.5, restored_at=101.8,
        acks=[[101, 500, 0.8, 9.0], [102, 480, 1.1, 30.0]],
        victim_forwarded_at_kill=21)
    assert [r["t"] for r in rows] == [1.5, 2.5]
    assert [r["answered_per_s"] for r in rows] == [900.0, 1000.0]
    assert rows[0]["completed"] == [390.0, None]
    # the restarted backend's counters count again from zero
    assert rows[1]["completed"] == [500.0, None] and \
        rows[1]["zk_sessions"][1] is None
    assert rows[0]["busy"] == {"balancer": 0.95, "backend1": 0.5}
    assert rows[1]["busy"] == {"balancer": 0.95}
    assert rows[0]["forwarded"] == [400, 4] and "forwarded" not in rows[1]
    assert (rows[1]["acks"], rows[1]["ack_max_ms"]) == (480, 30.0)
    assert summary["answered_per_s"] == [900.0, 950.0, 1000.0]
    assert summary["saturated"] == ["balancer"]
    assert (summary["retries"], summary["lost"]) == (4, 1)
    # the balancer dealt the dead backend 3 more after the kill
    assert summary["victim_forwarded_while_down"] == 3
    assert summary["kill_s"] == 1.0
    assert summary["restored_s"] == pytest.approx(2.3)
