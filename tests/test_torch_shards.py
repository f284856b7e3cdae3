"""Shard-group parity: ``binder_torch.shard`` against ``binder_tpu.shard``.

- Mutation-log frames: an in-process ``ShardSupervisor`` from each
  package, over the same FakeStore script, writes the snapshot and the
  delta feed to two socketpair links.  The streams must be
  byte-identical frame by frame, except each delta's ``t0`` (the
  owner's ``time.monotonic`` stamp, which no two runs share): it is
  set to 0 on both sides before the comparison.  The frame functions
  are held the same way on their own.
- Replica catch-up: the reference's stream, replayed into a
  ``ReplicaStore`` of each package, leaves both worker mirrors equal to
  each other and to the owner's mirror; the port's stream does the same.
- The production process tree: ``python -m binder_torch.main`` as the
  supervisor of 2 workers over ``python -m binder_torch.store.
  zk_testserver``.  Every worker's ``/proc/<pid>/cmdline`` runs
  ``binder_torch.main`` and never ``binder_tpu``; answers equal the
  reference's single-process server over the same ZooKeeper tree
  (same query ID, so the whole wire is compared; the rotating service
  names compare as the header plus sorted record sets); a SIGKILLed
  worker comes back under a new PID and serves a write made after the
  kill; SIGTERM to the supervisor exits 0 and leaves no worker.  Every
  worker, the first ones, the respawned one and the rolled
  replacements alike, attaches with the owner's whole mirror in its
  snapshot.
- The group's boot: the supervisor spawns no worker until the owner
  mirror's first walk is done, so every worker's attach snapshot
  carries the whole tree and the walk fans out no delta; over a store
  that never connects the group boots at once and answers SERVFAIL.
"""
import asyncio
import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from binder_torch.metrics.collector import MetricsCollector as PortMetrics
from binder_torch.shard import ReplicaStore as PortReplica
from binder_torch.shard import protocol as port_proto
from binder_torch.shard import supervisor as port_sup
from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortCache
from binder_torch.store import zk_client
from binder_torch.store.zk_client import ZKClient
from binder_torch.dns import wire
from binder_tpu.metrics.collector import MetricsCollector as RefMetrics
from binder_tpu.shard import ReplicaStore as RefReplica
from binder_tpu.shard import protocol as ref_proto
from binder_tpu.shard import supervisor as ref_sup
from binder_tpu.store import FakeStore as RefStore
from binder_tpu.store import MirrorCache as RefCache
from tests.test_torch_fastio import LANE_MAIN
from tests.test_torch_loopacct import by_label, samples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = "foo.com"
T = wire.Type
SIDES = {"port": (PortStore, PortCache, port_sup, PortMetrics, PortReplica),
         "ref": (RefStore, RefCache, ref_sup, RefMetrics, RefReplica)}


def host(addr, **extra):
    return {"type": "host", "host": dict(address=addr, **extra)}


def lb(addr):
    return {"type": "load_balancer", "load_balancer": {"address": addr}}


SERVICE = {"type": "service",
           "service": {"srvce": "_http", "proto": "_tcp", "port": 8080}}

ZONE = {
    **{f"/com/foo/w{i}": host(f"10.50.0.{i + 1}") for i in range(4)},
    "/com/foo/svc": SERVICE,
    **{f"/com/foo/svc/m{i}": lb(f"10.50.1.{i + 1}") for i in range(3)},
    **{f"/com/foo/zs/r{i % 3}/h{i:03d}": host(f"10.60.{i // 250}.{i % 250}")
       for i in range(40)},
}

#: (method, args) applied to the owner store after the snapshot
SCRIPT = [
    ("put_json", ("/com/foo/w0", host("10.50.9.9", ttl=5))),
    ("delete", ("/com/foo/svc/m2",)),
    ("put_json", ("/com/foo/new", host("10.50.7.7"))),
    ("set_data", ("/com/foo/w1", b"not json")),
    ("rmr", ("/com/foo/zs/r1",)),
    ("put_json", ("/com/foo/zs/r1/h999", host("10.61.0.1"))),
    ("tick", ()),
    ("put_json", ("/dcs/east", {"zones": ["east"],
                                "peers": ["10.9.0.1:53"]})),
    ("expire_session", ()),
    ("tick", ()),
]


class _StubProc:
    pid = 0

    def poll(self):
        return None


def drain(sock):
    out = bytearray()
    while True:
        try:
            chunk = sock.recv(1 << 16)
        except BlockingIOError:
            return bytes(out)
        if not chunk:
            return bytes(out)
        out += chunk


def bodies(stream):
    out, off = [], 0
    while off < len(stream):
        n = int.from_bytes(stream[off:off + 4], "big")
        out.append(re.sub(rb'"t0":[-+0-9.eE]+', b'"t0":0',
                          stream[off + 4:off + 4 + n]))
        off += 4 + n
    assert off == len(stream)
    return out


async def owner_streams(side):
    """The mutation-log bytes an owner of ``side`` writes to each of
    two links over the script; plus its final mirror."""
    store_cls, cache_cls, sup_mod, metrics_cls, _ = SIDES[side]
    store = store_cls()
    for path, obj in ZONE.items():
        store.put_json(path, obj)
    cache = cache_cls(store, DOMAIN)
    store.start_session()
    sup = sup_mod.ShardSupervisor(
        options={"shards": 2, "host": "127.0.0.1", "port": 0,
                 "dnsDomain": DOMAIN},
        store=store, cache=cache, collector=metrics_cls())
    sup._loop = asyncio.get_running_loop()
    ends = []
    for i in range(2):
        sup_end, worker_end = socket.socketpair()
        sup_end.setblocking(False)
        worker_end.setblocking(False)
        link = sup_mod.ShardLink(i, _StubProc(), sup_end)
        sup.links[i] = link
        sup._send_snapshot(link)
        ends.append(worker_end)
    await asyncio.sleep(0)
    streams = [bytearray(drain(e)) for e in ends]
    for method, args in SCRIPT:
        if method == "tick":
            sup._tick()
        else:
            getattr(store, method)(*args)
        await asyncio.sleep(0)
        for buf, e in zip(streams, ends):
            buf += drain(e)
    for link in list(sup.links.values()):
        sup._close_link(link)
    for e in ends:
        e.close()
    return [bytes(s) for s in streams], mirror_view(cache)


def mirror_view(cache):
    return {
        "records": {d: (n.data, n.ip, sorted(k.domain for k in n.children))
                    for d, n in sorted(cache.nodes.items())},
        "reverse": {ip: n.domain
                    for ip, n in sorted(cache.rev_lookup.items())},
    }


def snap_end_offset(stream):
    """Byte offset just past the ``snap-end`` frame of ``stream``."""
    off = 0
    while True:
        n = int.from_bytes(stream[off:off + 4], "big")
        off += 4 + n
        if json.loads(stream[off - n:off])["op"] == "snap-end":
            return off


def replay(side, stream, split):
    """Feed ``stream`` to a fresh ``ReplicaStore`` of ``side`` the way a
    worker reads it; return the worker mirror's view.  With ``split``
    the feed holds back everything after ``snap-end`` until the
    snapshot is read; without it the whole stream is there at once."""
    _, cache_cls, _, _, replica_cls = SIDES[side]
    feed, worker_end = socket.socketpair()
    replica = replica_cls(worker_end, 0)
    cut = snap_end_offset(stream) if split else len(stream)
    feed.sendall(stream[:cut])
    replica.read_snapshot(timeout=5.0)
    feed.sendall(stream[cut:])
    feed.shutdown(socket.SHUT_WR)
    cache = cache_cls(replica, DOMAIN)
    worker_end.setblocking(False)
    down = []
    replica.on_link_down = lambda: down.append(True)
    while not down:
        replica._on_readable()
    view = mirror_view(cache)
    state = (replica.frames_applied, replica.snapshot_nodes,
             replica._dg, replica.session_state(),
             replica.exists("/dcs/east"))
    feed.close()
    replica.close()
    return view, state


def test_mutation_log_frames_byte_identical():
    async def run():
        return {side: await owner_streams(side) for side in SIDES}

    got = asyncio.run(run())
    (port_streams, port_view), (ref_streams, ref_view) = \
        got["port"], got["ref"]
    assert port_view == ref_view
    for mine, theirs in zip(port_streams, ref_streams):
        assert bodies(mine) == bodies(theirs)
    # both links carry one stream: snapshot, then deltas and heartbeats
    assert bodies(port_streams[0]) == bodies(port_streams[1])
    ops = [json.loads(b)["op"] for b in bodies(ref_streams[0])]
    assert ops[0] == "state" and "snap-end" in ops
    assert {"node", "gone", "digest", "pnode"} <= set(ops)
    # the replicas of both packages end where the owner did
    for stream in (ref_streams[0], port_streams[0]):
        port_replica = replay("port", stream, split=True)
        assert port_replica == replay("ref", stream, split=True)
        assert port_replica[0] == ref_view
        assert port_replica[1][4]          # /dcs/east rode the log


def test_replica_keeps_the_deltas_read_with_snap_end():
    """The one place the port departs from the reference: when the read
    that brings ``snap-end`` also brings the first deltas (a worker
    that boots while the owner's mirror is still filling, or a respawn
    under churn), the reference's ``read_snapshot`` returns at
    ``snap-end`` and drops the rest of that read, so those mutations
    never reach the worker.  The port applies them."""
    streams, owner = asyncio.run(owner_streams("ref"))
    port_view, port_state = replay("port", streams[0], split=False)
    assert port_view == owner
    assert port_state == replay("port", streams[0], split=True)[1]
    ref_view, _ = replay("ref", streams[0], split=False)
    assert "new.foo.com" in owner["records"]
    assert "new.foo.com" not in ref_view["records"]


def test_frame_functions_byte_identical():
    frames = [
        ("node_frame", ("w0.foo.com", host("10.1.1.1"), "m1-2", 12.5)),
        ("node_frame", ("bare.foo.com", None)),
        ("gone_frame", ("w0.foo.com", "m1-3", 13.0)),
        ("gone_frame", ("w0.foo.com",)),
        ("path_node_frame", ("/dcs/east", {"zones": ["east"]})),
        ("path_gone_frame", ("/dcs/east",)),
        ("state_frame", ("degraded", False, 1.25, 3)),
        ("snap_end_frame", (17,)),
        ("hello_frame", (1, 4242, 5353, 5353, 6353)),
        ("stats_frame", (12.0, 5, 1, True, 2, 3, 4)),
        ("digest_frame", (9, "abcdef0123456789")),
        ("digest_report_frame", (1, 9, False, "aa", "bb")),
    ]
    dg_port = dg_ref = "0"
    for name, args in frames:
        got = getattr(port_proto, name)(*args)
        want = getattr(ref_proto, name)(*args)
        assert port_proto.encode_frame(got) == \
            ref_proto.encode_frame(want), name
        dg_port = port_proto.delta_digest(dg_port, got)
        dg_ref = ref_proto.delta_digest(dg_ref, want)
        assert dg_port == dg_ref
    buf = bytearray(b"".join(port_proto.encode_frame(
        getattr(port_proto, n)(*a)) for n, a in frames))
    tail = bytearray(buf[-5:])
    head = bytearray(buf[:-5])
    assert ref_proto.decode_frames(head) == \
        [getattr(ref_proto, n)(*a) for n, a in frames[:-1]]
    assert port_proto.decode_frames(head + tail) == \
        [getattr(ref_proto, n)(*a) for n, a in frames[-1:]]
    names = ["b.x", "a.b.x", "x", "c.a.b.x", "a.x"]
    assert port_proto.snapshot_order(names) == ref_proto.snapshot_order(names)
    for const in ("SHARD_PROTO_VERSION", "SHARD_FD_ENV", "MAX_FRAME"):
        assert getattr(port_proto, const) == getattr(ref_proto, const)
    with pytest.raises(ValueError):
        port_proto.decode_frames(bytearray(b"\xff\xff\xff\xff"))


# -- the production process tree ------------------------------------------


def boot(args, log_path, pattern, env=None, deadline_s=60.0):
    out = open(log_path, "wb")
    proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, stdout=out,
                            stderr=subprocess.STDOUT, env=env)
    out.close()
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        with open(log_path, "rb") as f:
            text = f.read()
        m = re.search(pattern, text)
        if m:
            return proc, text
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    proc.wait()
    raise AssertionError(f"{args} did not start: {text[-2000:]!r}")


def boot_binder(package, config, log_path):
    # on the C lane: the port's workers load the extension the port
    # builds, and the reference is given the same build
    proc, text = boot(["-c", LANE_MAIN, "native", package, "-f", config,
                       "-p", "0"], log_path,
                      rb"TCP DNS service started on [\d.]+:\d+")
    udp = int(re.search(rb"UDP DNS service started on [\d.]+:(\d+)",
                        text).group(1))
    mport = int(re.search(rb"metrics server started on port (\d+)",
                          text).group(1))
    return proc, udp, mport


def ask(port, name, qtype, qid):
    """One query on a fresh socket (a fresh reuseport draw), retried."""
    q = wire.make_query(name, qtype, qid=qid).encode()
    for _ in range(3):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(2)
            s.sendto(q, ("127.0.0.1", port))
            try:
                return s.recv(65535)
            except socket.timeout:
                continue
    raise AssertionError(f"no answer for {name}")


def rr_sets(data):
    m = wire.Message.decode(data)

    def rows(section):
        return sorted(repr(dataclasses.astuple(r)) for r in section)
    return (data[:12], rows(m.answers), rows(m.additionals))


def status(mport):
    for _ in range(20):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/status", timeout=5) as r:
                return json.load(r)
        except OSError:
            time.sleep(0.1)
    raise AssertionError("no /status")


def cmdline(pid):
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().replace(b"\0", b" ").decode()


def alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(") ", 1)[1].split()[0] != "Z"
    except OSError:
        return False


async def zk_write(port, items):
    w = ZKClient(address="127.0.0.1", port=port)
    w.start()
    for _ in range(500):
        if w.is_connected():
            break
        await asyncio.sleep(0.01)
    for path, obj in items:
        await w.mkdirp(path, json.dumps(obj).encode())
    w.close()


def metrics(mport):
    with urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics",
                                timeout=5) as r:
        return r.read().decode()


def owner_names(mport):
    """The node count of the supervisor's owner mirror."""
    return int(sum(samples(metrics(mport), "binder_mirror_names").values()))


def snapshots(log_path):
    """``{pid: nodes}`` of every worker's ``snapshot applied`` line."""
    out = {}
    with open(log_path, "rb") as f:
        for line in f:
            try:
                entry = json.loads(line)
            except ValueError:
                continue
            m = re.match(r"shard \d+: snapshot applied \((\d+) node",
                         str(entry.get("msg", "")))
            if m:
                out[entry["pid"]] = int(m.group(1))
    return out


def wait_snapshot(log_path, pid, timeout=20.0):
    deadline = time.monotonic() + timeout
    while pid not in snapshots(log_path):
        assert time.monotonic() < deadline, f"pid {pid} logged no snapshot"
        time.sleep(0.05)
    return snapshots(log_path)[pid]


def wait_served(port, served, flows=12, timeout=20.0):
    """Poll until ``flows`` fresh sockets each get every name's address
    (fresh source ports spread the asks over the worker group)."""
    deadline = time.monotonic() + timeout
    while True:
        got = {(name, ip, [a.address for a in wire.Message.decode(
            ask(port, name, T.A, 300 + k)).answers] == [ip])
            for k in range(flows) for name, ip in served.items()}
        if all(ok for _, _, ok in got):
            return
        assert time.monotonic() < deadline, sorted(got)
        time.sleep(0.1)


SINGLE = [("w0.foo.com", T.A), ("w3.foo.com", T.A),
          ("1.0.50.10.in-addr.arpa", T.PTR), ("h007.r1.zs.foo.com", T.A),
          ("nosuch.foo.com", T.A), ("w0.other.test", T.A),
          ("w0.foo.com", T.TXT)]
ROTATED = [("svc.foo.com", T.A), ("_http._tcp.svc.foo.com", T.SRV)]


def test_port_supervisor_spawns_port_workers(tmp_path):
    procs = []
    try:
        zk, text = boot(["-m", "binder_torch.store.zk_testserver", "0"],
                        tmp_path / "zk.log", rb"listening on [\d.]+:\d+")
        procs.append(zk)
        zk_port = int(re.search(rb"listening on [\d.]+:(\d+)",
                                text).group(1))
        asyncio.run(zk_write(zk_port, ZONE.items()))
        base = {"dnsDomain": DOMAIN, "datacenterName": "dc0",
                "host": "127.0.0.1", "queryLog": False,
                "store": {"backend": "zookeeper", "host": "127.0.0.1",
                          "port": zk_port, "sessionTimeout": 5000}}
        configs = {}
        for name, extra in (("group", {"shards": 2}), ("single", {})):
            configs[name] = str(tmp_path / f"{name}.json")
            with open(configs[name], "w") as f:
                json.dump(dict(base, **extra), f)
        sup, port, mport = boot_binder("binder_torch", configs["group"],
                                       tmp_path / "group.log")
        procs.append(sup)
        ref, ref_port, _ = boot_binder("binder_tpu", configs["single"],
                                       tmp_path / "single.log")
        procs.append(ref)

        workers = status(mport)["shards"]["workers"]
        pids = [w["pid"] for w in workers]
        assert len(set(pids)) == 2 and sup.pid not in pids
        names = owner_names(mport)
        for pid in pids:
            line = cmdline(pid)
            assert "-m binder_torch.main" in line and "--shard-worker" in line
            assert "binder_tpu" not in line
            assert wait_snapshot(tmp_path / "group.log", pid) == names

        # every worker's mirror fills from the owner over the log
        served = {"w0.foo.com": "10.50.0.1", "w3.foo.com": "10.50.0.4",
                  "h039.r0.zs.foo.com": "10.60.0.39"}
        wait_served(port, served)
        for k, (name, qtype) in enumerate(SINGLE):
            want = ask(ref_port, name, qtype, 100 + k)
            for _ in range(6):
                assert ask(port, name, qtype, 100 + k) == want, name
        for k, (name, qtype) in enumerate(ROTATED):
            want = rr_sets(ask(ref_port, name, qtype, 200 + k))
            for _ in range(6):
                assert rr_sets(ask(port, name, qtype, 200 + k)) == want

        # a crashed worker comes back under a new pid, still the port
        os.kill(pids[0], signal.SIGKILL)
        deadline = time.monotonic() + 30
        while True:
            snap = status(mport)["shards"]
            w0 = snap["workers"][0]
            if w0["pid"] not in (None, pids[0]) and w0["up"]:
                break
            assert time.monotonic() < deadline, snap
            time.sleep(0.1)
        assert snap["respawns_total"] == 1 and w0["respawns"] == 1
        assert "-m binder_torch.main" in cmdline(w0["pid"])
        assert "binder_tpu" not in cmdline(w0["pid"])
        # the respawn attaches by snapshot, the owner's whole mirror
        assert wait_snapshot(tmp_path / "group.log", w0["pid"]) == names
        # a write after the kill reaches every worker
        asyncio.run(zk_write(zk_port, [("/com/foo/w0", host("10.50.9.9"))]))
        wait_served(port, {"w0.foo.com": "10.50.9.9"})

        # a rolled group: each replacement attaches by snapshot too, and
        # a write after the roll reaches every one of them
        before = {w["pid"] for w in snap["workers"]}
        sup.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 60
        while True:
            snap = status(mport)["shards"]
            if snap["rolls_total"] == 2 and snap["rolling_shard"] is None \
                    and all(w["up"] for w in snap["workers"]):
                break
            assert time.monotonic() < deadline, snap
            time.sleep(0.2)
        assert snap["roll_aborts"] == 0
        rolled = [w["pid"] for w in snap["workers"]]
        assert not before & set(rolled)
        for pid in rolled:
            assert wait_snapshot(tmp_path / "group.log", pid) == names
        asyncio.run(zk_write(zk_port, [("/com/foo/w3", host("10.50.8.8"))]))
        wait_served(port, {"w3.foo.com": "10.50.8.8"})

        # SIGTERM drains the group: exit 0, no worker left
        live = [w["pid"] for w in snap["workers"]]
        sup.send_signal(signal.SIGTERM)
        assert sup.wait(timeout=20) == 0
        deadline = time.monotonic() + 10
        while any(alive(pid) for pid in live):
            assert time.monotonic() < deadline, live
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


BOOT_HOSTS = 3000


def boot_tree(path):
    """A zk_testserver tree of ``BOOT_HOSTS`` hosts in 12 racks."""
    rows = [["/com", ""], ["/com/foo", ""], ["/com/foo/zs", ""]]
    rows += [[f"/com/foo/zs/r{r}", ""] for r in range(12)]
    rows += [[f"/com/foo/zs/r{i % 12}/h{i}", json.dumps(
        host(f"10.{64 + i // 65536}.{i // 256 % 256}.{i % 256}"))]
        for i in range(BOOT_HOSTS)]
    with open(path, "w") as f:
        json.dump(rows, f)


def boot_group(tmp_path, store_port):
    """``python -m binder_torch.main`` over 2 workers and the ZooKeeper
    at ``store_port``; the supervisor, its log, UDP and metrics ports."""
    config = str(tmp_path / "group.json")
    with open(config, "w") as f:
        json.dump({"dnsDomain": DOMAIN, "datacenterName": "dc0",
                   "host": "127.0.0.1", "queryLog": False, "shards": 2,
                   "store": {"backend": "zookeeper", "host": "127.0.0.1",
                             "port": store_port, "sessionTimeout": 5000}},
                  f)
    log = tmp_path / "group.log"
    sup, text = boot(["-m", "binder_torch.main", "-f", config, "-p", "0"],
                     log, rb"TCP DNS service started on [\d.]+:\d+")
    udp = int(re.search(rb"UDP DNS service started on [\d.]+:(\d+)",
                        text).group(1))
    mport = int(re.search(rb"metrics server started on port (\d+)",
                          text).group(1))
    return sup, log, udp, mport


def stop(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def test_group_spawns_its_workers_after_the_owners_walk(tmp_path):
    """No worker exists before the owner mirror's first walk ends; each
    attaches with the whole tree in its snapshot, and the walk fanned
    out no delta."""
    tree = str(tmp_path / "tree.json")
    boot_tree(tree)
    procs = []
    try:
        zk, text = boot(["-m", "binder_torch.store.zk_testserver", "0",
                         tree], tmp_path / "zk.log",
                        rb"listening on [\d.]+:\d+")
        procs.append(zk)
        zk_port = int(re.search(rb"listening on [\d.]+:(\d+)",
                                text).group(1))
        sup, log, port, mport = boot_group(tmp_path, zk_port)
        procs.append(sup)
        workers = status(mport)["shards"]["workers"]
        sup_text = metrics(mport)
        names = owner_names(mport)
        assert names >= BOOT_HOSTS
        ends = by_label(sup_text, "binder_boot_phase_end_seconds", "phase")
        assert ends["hold"] >= ends["walk"]
        assert by_label(sup_text, "binder_shard_boot_attach_total",
                        "after") == {"walk": 1, "no-session": 0,
                                     "session-lost": 0}
        assert sum(samples(sup_text, "binder_shard_fanout_events_total")
                   .values()) == 0
        for w in workers:
            assert wait_snapshot(log, w["pid"]) == names
            text = metrics(w["metrics_port"])
            replay = by_label(text, "binder_boot_phase_seconds", "phase")
            replay_end = by_label(text, "binder_boot_phase_end_seconds",
                                  "phase")
            # the replay phase starts at the spawn, on the same clock
            assert replay_end["replay"] - replay["replay"] >= ends["hold"]
        wait_served(port, {"h0.r0.zs.foo.com": "10.64.0.0",
                           f"h{BOOT_HOSTS - 1}.r{(BOOT_HOSTS - 1) % 12}"
                           ".zs.foo.com": "10.64.11.183"})
    finally:
        stop(procs)


def test_group_without_a_store_session_boots_and_serves_servfail(tmp_path):
    """A store that refuses every connection holds nothing up: the hold
    ends with the first attempt, the group announces and answers
    SERVFAIL."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    procs = []
    try:
        sup, _, port, mport = boot_group(tmp_path, closed)
        procs.append(sup)
        sup_text = metrics(mport)
        assert by_label(sup_text, "binder_shard_boot_attach_total",
                        "after") == {"walk": 0, "no-session": 1,
                                     "session-lost": 0}
        hold = by_label(sup_text, "binder_boot_phase_seconds", "phase")
        assert hold["hold"] < zk_client.CONNECT_TIMEOUT
        assert "walk" not in hold
        for k in range(6):
            reply = wire.Message.decode(ask(port, "w0.foo.com", T.A, 500 + k))
            assert reply.rcode == wire.Rcode.SERVFAIL
    finally:
        stop(procs)


class _SlowSocket:
    """A worker socket that takes at most ``take`` bytes of every
    second send and blocks on the others: a worker behind on its log."""

    def __init__(self, take):
        self.take = take
        self.calls = 0
        self.sent = []

    def fileno(self):
        return -1

    def send(self, data):
        self.calls += 1
        if self.calls % 2:
            raise BlockingIOError
        self.sent.append(bytes(data[:self.take]))
        return len(self.sent[-1])


def backed_up_sends(side):
    """What a supervisor of ``side`` hands a slow worker's socket for
    200 frames, then the flushes its writable callback makes."""
    sup_mod = SIDES[side][2]
    sup = sup_mod.ShardSupervisor.__new__(sup_mod.ShardSupervisor)
    armed = []
    sup._loop = type("Loop", (), {"add_writer": lambda self, fd, cb, link:
                                  armed.append(link)})()
    sock = _SlowSocket(take=700)
    link = sup_mod.ShardLink(0, _StubProc(), sock)
    proto = port_proto if side == "port" else ref_proto
    frames = [proto.node_frame(f"h{k}.foo.com", host(f"10.0.0.{k}"))
              for k in range(200)]
    for frame in frames:
        sup._send(link, frame)
    during = (list(sock.sent), sock.calls, len(armed))
    while link.wbuf:
        sup._flush(link)
    return during, sock.sent


def test_backed_up_link_sends_like_reference():
    """A worker that takes its mutation log slower than the owner
    writes it gets the same sends, in the same order, from both
    supervisors, and together they are every frame, in order."""
    port, ref = backed_up_sends("port"), backed_up_sends("ref")
    assert port == ref
    frames = [port_proto.node_frame(f"h{k}.foo.com", host(f"10.0.0.{k}"))
              for k in range(200)]
    assert b"".join(port[1]) == b"".join(port_proto.encode_frame(f)
                                         for f in frames)
