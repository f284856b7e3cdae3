"""Loop accounting and boot phases (``binder_torch/introspect/
loopacct.py``).

- Over a synthetic loop the ``binder_loop_cpu_seconds_total`` family,
  ``activity="other"`` included, moves by the process's CPU.
- A nested span gives its parent its self time, and nothing is counted
  twice; an interval's CPU is shared among the spans that ran in it by
  their self wall time.
- A feed callback held past the stall threshold records a
  ``long-callback`` flight event naming its activity and the trace id
  of the mutation it applied; the event's CPU tells a callback that
  burned the loop from one that blocked it.
- Each step of a task made by ``steps`` is one span; the accounted
  loop's busy wall no span covers is the ``dispatch`` activity.
- Unbound (the modules used as a library), the accountant reads no
  clock.
- A 2,000-name shard group (``python -m binder_torch.main`` with
  ``shards: 2`` over ``binder_torch.store.zk_testserver``) under churn
  exposes non-zero ``udp``, ``feed`` and ``precompile`` CPU in every
  worker, every boot phase in every process, and scrapes that pass
  ``tools/lint.py validate_exposition``; each worker's family sums to
  its ``/proc`` CPU.
"""
import asyncio
import gc
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from binder_torch.dns import wire
from binder_torch.introspect import FlightRecorder
from binder_torch.introspect import loopacct
from binder_torch.introspect.loopacct import ACCOUNT, LoopAccountant
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.shard import ReplicaStore, protocol
from binder_torch.store import MirrorCache
from binder_torch.store.zk_client import ZKClient
from binder_torch.verify.tracer import PropagationTracer
from tools.lint import validate_exposition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = "foo.com"
SAMPLE = re.compile(r'^(\w+)(?:\{([^}]*)\})? (\S+)$')


def samples(text: str, family: str) -> dict:
    """``{labels: value}`` of ``family``'s samples in an exposition."""
    out = {}
    for line in text.splitlines():
        m = SAMPLE.match(line)
        if m and m.group(1) == family:
            labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(2) or ""))
            out[tuple(sorted(labels.items()))] = float(m.group(3))
    return out


def by_label(text: str, family: str, label: str) -> dict:
    """``family``'s samples keyed by one label's value (summed)."""
    out = {}
    for labels, v in samples(text, family).items():
        key = dict(labels).get(label)
        out[key] = out.get(key, 0.0) + v
    return out


def spin(seconds: float) -> None:
    end = time.thread_time() + seconds
    while time.thread_time() < end:
        pass


@pytest.fixture
def global_account():
    """The process's accountant, bound to a test collector and recorder
    with a 50 ms threshold; unbound again afterwards."""
    threshold = ACCOUNT.threshold_ns
    collector, recorder = MetricsCollector(), FlightRecorder()
    ACCOUNT.bind(collector, recorder, stall_threshold=0.05)
    try:
        yield collector, recorder
    finally:
        ACCOUNT.unbind()
        ACCOUNT.threshold_ns = threshold


@pytest.fixture
def accountant():
    """A bound accountant of the test's own, unbound afterwards."""
    acct, collector = LoopAccountant(), MetricsCollector()
    acct.bind(collector)
    try:
        yield acct, collector
    finally:
        acct.unbind()


def test_families_sum_to_the_process_cpu_over_a_synthetic_loop(
        accountant):
    acct, collector = accountant

    async def scenario():
        loop = asyncio.get_running_loop()
        done = loop.create_future()
        left = [12]

        def tick(work):
            spin(work)
            left[0] -= 1
            if left[0] <= 0 and not done.done():
                done.set_result(None)

        for k in range(12):
            name = ("udp", "feed", "precompile")[k % 3]
            loop.call_soon(acct.wrap(name, tick), 0.01)
        loop.call_soon(spin, 0.01)           # unnamed: "other"
        await done

    before = sum(by_label(collector.expose(), loopacct.METRIC_CPU,
                          "activity").values())
    cpu0 = time.process_time()
    asyncio.run(scenario())
    acct.settle()
    text = collector.expose()
    cpu1 = time.process_time()
    cpu = by_label(text, loopacct.METRIC_CPU, "activity")
    moved = sum(cpu.values()) - before
    assert moved == pytest.approx(cpu1 - cpu0, rel=0.05)
    assert sum(cpu.values()) == pytest.approx(cpu1, rel=0.05)
    named = sum(v for k, v in cpu.items() if k != loopacct.OTHER)
    assert named >= 0.8 * 0.12
    assert by_label(text, loopacct.METRIC_CALLBACKS, "activity") == {
        "udp": 4.0, "feed": 4.0, "precompile": 4.0}
    assert validate_exposition(text) == []


def test_nested_spans_give_self_time(accountant):
    acct, _ = accountant
    parent, child = acct.activity("udp"), acct.activity("udp.clane")
    cpu0 = time.thread_time_ns()
    acct.begin(parent)
    spin(0.02)
    acct.begin(child)
    spin(0.03)
    assert acct.end() == 0                  # a nested span's: none
    spin(0.01)
    acct.end()
    acct.settle()
    cpu = time.thread_time_ns() - cpu0
    (p_cpu, p_wall, p_calls), (c_cpu, c_wall, c_calls) = (
        acct.totals()["udp"], acct.totals()["udp.clane"])
    # the parent holds its own 30 ms, the child its 30 ms, each at the
    # interval's one CPU-to-wall ratio, and nothing twice
    assert p_calls == c_calls == 1
    assert p_wall >= 0.03e9 and c_wall >= 0.03e9
    assert 0.9 * 0.06e9 <= p_cpu + c_cpu <= cpu
    assert abs(c_cpu * p_wall - p_cpu * c_wall) <= p_wall + c_wall
    assert acct.end() == 0                  # an unmatched end is a no-op


def test_an_interval_shares_its_cpu_by_wall(accountant):
    acct, _ = accountant
    feed, verify = acct.activity("feed"), acct.activity("verify")
    for _ in range(10):
        acct.begin(feed)
        spin(0.004)
        acct.end()
        acct.begin(verify)
        spin(0.002)
        acct.end()
    assert feed.cpu_ns == verify.cpu_ns == 0   # the interval is open
    acct.settle()
    assert feed.cpu_ns == pytest.approx(2 * verify.cpu_ns, rel=0.3)
    assert feed.cpu_ns + verify.cpu_ns == pytest.approx(0.06e9, rel=0.2)


def test_the_select_activity_is_the_loops_wait(accountant):
    acct, collector = accountant

    async def scenario():
        await asyncio.sleep(0.05)
        acct.wrap("udp", spin)(0.01)

    loop = acct.loop()
    try:
        loop.run_until_complete(scenario())
    finally:
        loop.close()
    cpu, wall, calls = acct.totals()[loopacct.SELECT]
    # no interval closed (under 100 ms): the selector's CPU, what an
    # interval spent beyond its busy wall, is not read yet
    assert calls >= 1 and wall >= 0.045e9 and cpu == 0
    text = collector.expose()
    assert by_label(text, loopacct.METRIC_CALLBACKS, "activity")[
        loopacct.SELECT] == calls


def test_a_tasks_steps_are_one_span_each(accountant):
    acct, _ = accountant

    async def session():
        spin(0.01)
        await asyncio.sleep(0)
        spin(0.01)
        try:
            await asyncio.sleep(5)
        except asyncio.CancelledError:
            spin(0.01)
            return "cancelled"

    async def scenario():
        task = asyncio.ensure_future(acct.steps("zk", session()))
        await asyncio.sleep(0.01)
        task.cancel()
        return await task

    loop = acct.loop()
    try:
        assert loop.run_until_complete(scenario()) == "cancelled"
    finally:
        loop.close()
    acct.settle()
    cpu, wall, calls = acct.totals()["zk"]
    # the steps to each await, and the one the cancellation was thrown
    # into; the awaits' waits are not counted
    assert calls == 3 and 0.03e9 <= wall < 0.05e9
    assert cpu >= 0.8 * 0.03e9


def test_the_accounted_loop_names_its_dispatch(accountant):
    acct, _ = accountant

    async def scenario():
        loop = asyncio.get_running_loop()
        loop.call_soon(spin, 0.03)           # a callback no span names
        loop.call_soon(acct.wrap("udp", spin), 0.01)
        await asyncio.sleep(0.01)
        # past an interval: the next select closes it
        await asyncio.sleep(loopacct.INTERVAL_S)

    loop = acct.loop()
    try:
        loop.run_until_complete(scenario())
    finally:
        loop.close()
    totals = acct.totals()
    cpu, wall, calls = totals[loopacct.DISPATCH]
    assert calls >= 1 and wall >= 0.03e9 and cpu >= 0.8 * 0.03e9
    assert totals["udp"][0] >= 0.8 * 0.01e9
    # the interval's CPU beyond its busy wall: the selector's, well
    # under its wait
    cpu, wall, _ = totals[loopacct.SELECT]
    assert 0 <= cpu < 0.5 * wall


def test_an_unbound_accountant_reads_no_clock(monkeypatch):
    """An accountant no server bound (the modules used as a library):
    its spans, wrapped callbacks, task steps and selector then read no
    clock and count nothing."""
    def no_clock():
        raise AssertionError("an unbound accountant read a clock")

    monkeypatch.setattr(loopacct, "_wall_ns", no_clock)
    monkeypatch.setattr(loopacct, "_cpu_ns", no_clock)
    acct = LoopAccountant()
    udp = acct.activity("udp")
    acct.begin(udp)
    assert acct.end() == 0
    assert acct.wrap("feed", lambda x: x + 1)(41) == 42

    async def scenario():
        await asyncio.sleep(0.01)
        return acct.wrap("verify", len)("abc")

    loop = acct.loop()
    try:
        assert loop.run_until_complete(acct.steps("zk", scenario())) == 3
    finally:
        loop.close()
    assert all(calls == 0 for _, _, calls in acct.totals().values())
    assert acct._threads == {}


def test_a_long_callback_tells_cpu_from_blocking():
    """A ``long-callback`` event's CPU is read at the span's end: a
    callback that burned its wall reads its wall, one that slept reads
    far less."""
    acct, recorder = LoopAccountant(stall_threshold=0.05), FlightRecorder()
    acct.bind(MetricsCollector(), recorder)
    try:
        acct.settle()
        acct.wrap("verify", spin, cause="audit")(0.08)
        acct.settle()                      # as the loop does at select
        acct.wrap("feed", time.sleep, cause="m7-2b")(0.08)
    finally:
        acct.unbind()
    busy, blocked = [e for e in recorder.events()
                     if e["type"] == "long-callback"]
    assert (busy["activity"], busy["cause"]) == ("verify", "audit")
    assert 0.079 <= busy["cpu_s"] <= busy["wall_s"]
    assert (blocked["activity"], blocked["cause"]) == ("feed", "m7-2b")
    assert blocked["wall_s"] >= 0.08
    assert 0 <= blocked["cpu_s"] < 0.5 * blocked["wall_s"]


def test_concurrent_scrapes_fold_each_span_once(accountant):
    """Scrape threads folding while the loop thread keeps closing
    spans: every span is counted once (without the fold's lock, two
    folds of one delta count it twice)."""
    acct, collector = accountant
    acts = [acct.activity(f"a{k}") for k in range(20)]
    stop = threading.Event()

    def scrape():
        while not stop.is_set():
            collector.expose()

    threads = [threading.Thread(target=scrape) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        end = time.monotonic() + 0.5
        while time.monotonic() < end:
            for act in acts:
                acct.begin(act)
                acct.end()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    text = collector.expose()
    calls = by_label(text, loopacct.METRIC_CALLBACKS, "activity")
    cpu = by_label(text, loopacct.METRIC_CPU, "activity")
    totals = acct.totals()
    for act in acts:
        assert calls[act.name] == totals[act.name][2] > 0
        assert cpu[act.name] == pytest.approx(totals[act.name][0] / 1e9,
                                              rel=1e-6, abs=1e-9)


def test_an_older_collection_is_the_gc_activity(accountant):
    acct, _ = accountant
    udp = acct.activity("udp")
    gc.collect(2)                           # outside any span
    acct.begin(udp)
    spin(0.005)
    gc.collect(1)                           # nested: its own wall
    acct.end()
    acct.settle()
    cpu, wall, calls = acct.totals()[loopacct.GC]
    assert calls == 2 and 0 < cpu and wall > 0
    acct.unbind()
    gc.collect(2)
    assert acct.totals()[loopacct.GC][2] == 2   # no longer watched


def test_a_long_feed_callback_names_its_activity_and_trace(
        global_account):
    _, recorder = global_account
    owner, end = socket.socketpair()
    web = "web." + DOMAIN
    owner.sendall(b"".join(protocol.encode_frame(f) for f in (
        protocol.state_frame("connected", True, None, 1),
        protocol.node_frame(DOMAIN, None),
        protocol.node_frame(web, {"type": "host",
                                  "host": {"address": "10.0.0.1"}}),
        protocol.snap_end_frame(2))))
    replica = ReplicaStore(end, 0)
    replica.read_snapshot(timeout=5.0)
    cache = MirrorCache(replica, DOMAIN)
    tracer = PropagationTracer()
    cache.tracer = replica.tracer = tracer
    cache.on_invalidate(lambda tags: time.sleep(0.08))

    async def scenario():
        replica.start(asyncio.get_running_loop())
        applied = replica.frames_applied
        # an update of a mirrored name: one store event, traced
        owner.sendall(protocol.encode_frame(protocol.node_frame(
            web, {"type": "host", "host": {"address": "10.0.0.2"}},
            "m7-2a", time.monotonic())))
        for _ in range(200):
            if replica.frames_applied > applied:
                return
            await asyncio.sleep(0.01)

    # the shard worker's loop: its interval closes at the selector
    loop = ACCOUNT.loop()
    try:
        loop.run_until_complete(scenario())
    finally:
        replica.close()
        owner.close()
        loop.close()
    events = [e for e in recorder.events() if e["type"] == "long-callback"]
    assert events, recorder.events()
    ev = events[-1]
    assert ev["activity"] == "feed" and ev["cause"] == "m7-2a"
    # the invalidation slept: the loop was held, not busy
    assert ev["wall_s"] >= 0.08 and 0 <= ev["cpu_s"] < 0.5 * ev["wall_s"]
    assert ev["start_mono"] <= time.monotonic() - ev["wall_s"]


def test_boot_phases_export_once_bound():
    acct = LoopAccountant()
    acct.boot_phase("replay", 10.0, 12.5, 1.25)
    collector, recorder = MetricsCollector(), FlightRecorder()
    acct.bind(collector, recorder)
    acct.boot_phase("snapshot", 11.0, 11.5, 0.25, shard=1)
    text = collector.expose()
    assert samples(text, loopacct.METRIC_PHASE) == {
        (("phase", "replay"),): 2.5,
        (("phase", "snapshot"), ("shard", "1")): 0.5}
    assert samples(text, loopacct.METRIC_PHASE_END)[
        (("phase", "replay"),)] == 12.5
    assert samples(text, loopacct.METRIC_PHASE_CPU)[
        (("phase", "snapshot"), ("shard", "1"))] == 0.25
    events = [e for e in recorder.events() if e["type"] == "boot-phase"]
    assert [(e["phase"], e["start_mono"], e["end_mono"]) for e in events] \
        == [("replay", 10.0, 12.5), ("snapshot", 11.0, 11.5)]
    assert validate_exposition(text) == []


# -- a shard group under churn ---------------------------------------------

HOSTS = 2000
CHURN = 8


def zone_tree(path: str) -> None:
    rows = [["/com", ""], ["/com/foo", ""], ["/com/foo/zs", ""]]
    for r in range(4):
        rows.append([f"/com/foo/zs/r{r}", ""])
    for i in range(HOSTS):
        rows.append([f"/com/foo/zs/r{i % 4}/h{i}", json.dumps(
            {"type": "host",
             "host": {"address": f"10.{64 + i // 65536}."
                                 f"{i // 256 % 256}.{i % 256}"}})])
    for k in range(CHURN):
        rows.append([f"/com/foo/c{k}", json.dumps(
            {"type": "host", "host": {"address": f"10.9.0.{k + 1}"}})])
    with open(path, "w") as f:
        json.dump(rows, f)


def spawn(args, log_path, pattern, deadline_s=90.0):
    out = open(log_path, "wb")
    proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, stdout=out,
                            stderr=subprocess.STDOUT)
    out.close()
    deadline = time.monotonic() + deadline_s
    text = b""
    while time.monotonic() < deadline:
        with open(log_path, "rb") as f:
            text = f.read()
        m = re.search(pattern, text)
        if m:
            return proc, m
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    proc.wait()
    raise AssertionError(f"{args} did not start: {text[-2000:]!r}")


def http(port: int, path: str) -> bytes:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.read()


def ask(port: int, name: str, qid: int) -> None:
    """One A query on a fresh socket (a fresh reuseport draw)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(2)
        s.sendto(wire.make_query(name, wire.Type.A, qid=qid).encode(),
                 ("127.0.0.1", port))
        try:
            s.recv(65535)
        except socket.timeout:
            pass


async def churn(zk_port: int, writes: int) -> None:
    w = ZKClient(address="127.0.0.1", port=zk_port)
    w.start()
    for _ in range(500):
        if w.is_connected():
            break
        await asyncio.sleep(0.01)
    for n in range(writes):
        k = n % CHURN
        await w.set_data(f"/com/foo/c{k}", json.dumps(
            {"type": "host",
             "host": {"address": f"10.9.{n // 250 + 1}.{n % 250 + 1}"}}
        ).encode())
    w.close()


def proc_cpu(pid: int) -> float:
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def wait_filled(mport: int, deadline_s: float = 60.0) -> list:
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            workers = json.loads(http(mport, "/status"))["shards"]["workers"]
            names = [sum(by_label(http(w["metrics_port"], "/metrics")
                                  .decode(), "binder_mirror_names",
                                  None).values())
                     for w in workers]
            if len(names) == 2 and min(names) >= HOSTS:
                return workers
        except (OSError, KeyError, TypeError, ValueError):
            pass
        assert time.monotonic() < deadline, "shard group never filled"
        time.sleep(0.2)


def test_shard_group_under_churn_exposes_its_loop_and_boot(tmp_path):
    tree = str(tmp_path / "tree.json")
    zone_tree(tree)
    procs = []
    try:
        zk, m = spawn(["-m", "binder_torch.store.zk_testserver", "0", tree],
                      tmp_path / "zk.log", rb"listening on [\d.]+:(\d+)")
        procs.append(zk)
        zk_port = int(m.group(1))
        config = str(tmp_path / "group.json")
        with open(config, "w") as f:
            json.dump({"dnsDomain": DOMAIN, "datacenterName": "dc0",
                       "host": "127.0.0.1", "shards": 2,
                       "store": {"backend": "zookeeper",
                                 "host": "127.0.0.1", "port": zk_port,
                                 "sessionTimeout": 5000}}, f)
        sup, m = spawn(["-m", "binder_torch.main", "-f", config, "-p", "0"],
                       tmp_path / "group.log",
                       rb"UDP DNS service started on [\d.]+:(\d+)")
        procs.append(sup)
        port = int(m.group(1))
        with open(tmp_path / "group.log", "rb") as f:
            mport = int(re.search(rb"metrics server started on port (\d+)",
                                  f.read()).group(1))
        workers = wait_filled(mport)

        # serve the churned names from every worker (fresh source ports
        # spread them), churn them, and serve them again
        # the workers attached after the owner's walk: it fanned out
        # nothing, and every fan-out event below is the churn's
        assert sum(samples(http(mport, "/metrics").decode(),
                           "binder_shard_fanout_events_total")
                   .values()) == 0
        names = [f"c{k}.{DOMAIN}" for k in range(CHURN)]
        for r in range(6):
            for k, name in enumerate(names):
                ask(port, name, 8 * r + k)
        asyncio.run(churn(zk_port, 40))
        for r in range(6):
            for k, name in enumerate(names):
                ask(port, name, 100 + 8 * r + k)
        time.sleep(1.5)

        sup_text = http(mport, "/metrics").decode()
        assert validate_exposition(sup_text) == []
        sup_phases = [dict(k) for k in
                      samples(sup_text, loopacct.METRIC_PHASE)]
        assert "walk" in {p["phase"] for p in sup_phases}
        assert {p.get("shard") for p in sup_phases
                if p["phase"] == "snapshot"} == {"0", "1"}
        sup_cpu = by_label(sup_text, loopacct.METRIC_CPU, "activity")
        assert sup_cpu.get("mirror", 0) > 0 and sup_cpu.get("fanout", 0) > 0
        # one event a changed record: every churned name changed, and
        # the 40 writes are all the changes (ZooKeeper's one-shot watch
        # may fold writes made between a notification and its fetch)
        assert CHURN <= sum(samples(
            sup_text, "binder_shard_fanout_events_total").values()) <= 40
        for w in workers:
            text = http(w["metrics_port"], "/metrics").decode()
            cpu_proc = proc_cpu(w["pid"])
            assert validate_exposition(text) == []
            cpu = by_label(text, loopacct.METRIC_CPU, "activity")
            for act in ("udp", "udp.clane", "udp.python", "feed",
                        "precompile"):
                assert cpu.get(act, 0) > 0, (act, cpu)
            assert sum(cpu.values()) == pytest.approx(
                cpu_proc, rel=0.05, abs=0.05), cpu
            phases = by_label(text, loopacct.METRIC_PHASE, "phase")
            assert set(phases) >= {"replay", "serving", "zone-fill", "seed"}
            ends = samples(text, loopacct.METRIC_PHASE_END)
            assert all(0 < t <= time.monotonic() for t in ends.values())
            assert sum(samples(text, "binder_replica_frames_applied_total")
                       .values()) >= 40
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
