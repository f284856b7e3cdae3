"""Zone-scale parity: ``binder_torch``'s compact mirror, chunked rebuild,
late-drop accounting, mirror metrics, shared watches and scale-aware
backpressure against ``binder_tpu``'s, and the port's zone and verify
probes against ``tools/``'s.

The cases of the reference's ``tests/test_zone_scale.py`` that
``test_torch_store.py`` does not hold (``TestCompactMirror``,
``TestChunkedRebuild``, ``TestLateDropAccounting``,
``TestMirrorMetricsExposition``, ``TestSharedWatchScaling``,
``TestScaleAwareBackpressure``), each run as one scenario against each
package.  A scenario returns what the reference test asserts on plus
the counters and wire it can observe; the two packages' observations
must be equal and meet the reference test's expectations.  Timings
(rebuild chunk counts, latencies) differ from run to run and are
compared as the reference test compares them, against its bounds.

The probes run as the zone smoke runs them, each in a process of its
own, at 2,000 names: ``python -m binder_torch.probe.zone`` against
``tools/zone_probe.py`` and ``python -m binder_torch.probe.verify``
against ``tools/verify_probe.py``.  Their JSON keys and their
deterministic readings must be equal.  Each process interns into its
own package's name pool, so each probe's ``pool`` stats are its own.
"""
import asyncio
import json
import os
import subprocess
import sys
import time

import pytest

from binder_torch import server as port_server
from binder_torch.dns import server as port_dns_server
from binder_torch.dns.server import DnsServer as PortDnsServer
from binder_torch.introspect import FlightRecorder as PortRecorder
from binder_torch.metrics.collector import MetricsCollector as PortMetrics
from binder_torch.probe import zone as port_probe
from binder_torch.server import BinderServer as PortServer
from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortCache
from binder_torch.store.fake import populate_synthetic as port_populate
from binder_torch.store.zk_client import ZKClient as PortZK
from binder_torch.store.zk_testserver import ZKTestServer as PortZKServer
from binder_tpu import server as ref_server
from binder_tpu.dns import server as ref_dns_server
from binder_tpu.dns.server import DnsServer as RefDnsServer
from binder_tpu.introspect import FlightRecorder as RefRecorder
from binder_tpu.metrics.collector import MetricsCollector as RefMetrics
from binder_tpu.server import BinderServer as RefServer
from binder_tpu.store import FakeStore as RefStore
from binder_tpu.store import MirrorCache as RefCache
from binder_tpu.store.fake import populate_synthetic as ref_populate
from binder_tpu.store.zk_client import ZKClient as RefZK
from binder_tpu.store.zk_testserver import ZKTestServer as RefZKServer
from tests.test_torch_fastio import pin_python_lane
from tools import zone_probe as ref_probe
from tools.lint import validate_mirror_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = "foo.com"


class Side:
    def __init__(self, **kw):
        self.__dict__.update(kw)


SIDES = {
    "port": Side(store=PortStore, cache=PortCache, populate=port_populate,
                 probe=port_probe, server=PortServer, metrics=PortMetrics,
                 recorder=PortRecorder, dns_server=PortDnsServer,
                 zk=PortZK, zk_server=PortZKServer),
    "ref": Side(store=RefStore, cache=RefCache, populate=ref_populate,
                probe=ref_probe, server=RefServer, metrics=RefMetrics,
                recorder=RefRecorder, dns_server=RefDnsServer,
                zk=RefZK, zk_server=RefZKServer),
}


def both(scenario):
    """``scenario(side)`` on both packages; asserts equal observations
    and returns the port's."""
    got = {name: scenario(s) for name, s in SIDES.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def host_name_under(domain: str, i: int, racks: int) -> str:
    return f"h{i:06d}.r{i % racks:04d}.zs.{domain}"


def zone(s, n, domain=DOMAIN, racks=4, **kw):
    store = s.store()
    s.populate(store, domain, n, racks=racks)
    return store, s.cache(store, domain, **kw)


# -- TestCompactMirror ------------------------------------------------


def test_node_rec_is_tuple_for_hosts():
    def scenario(s):
        store = s.store()
        cache = s.cache(store, DOMAIN)
        store.start_session()
        store.put_json("/com/foo/web",
                       {"type": "host", "host": {"address": "10.0.0.5"}})
        node = cache.lookup("web.foo.com")
        return (type(node.rec).__name__, node.rec, node.data, node.ip,
                node.name, node.path, node.kids)

    got = both(scenario)
    assert got[0] == "tuple"
    assert got[2] == {"type": "host", "host": {"address": "10.0.0.5"}}
    assert got[3:] == ("10.0.0.5", "web", "/com/foo/web", None)


def test_children_resolve_through_node_index():
    def scenario(s):
        store = s.store()
        cache = s.cache(store, DOMAIN)
        store.start_session()
        store.put_json("/com/foo/svc", {
            "type": "service",
            "service": {"srvce": "_http", "proto": "_tcp", "port": 80}})
        for i in range(3):
            store.put_json(f"/com/foo/svc/h{i}",
                           {"type": "load_balancer",
                            "load_balancer": {"address": f"10.0.1.{i}"}})
        node = cache.lookup("svc.foo.com")
        return (sorted(k.name for k in node.children),
                [type(k.rec).__name__ for k in node.children],
                sorted(k.rec for k in node.children))

    names, types, _ = both(scenario)
    assert names == ["h0", "h1", "h2"]
    assert types == ["tuple"] * 3


def test_canon_returns_mirror_domain_object():
    def scenario(s):
        store = s.store()
        cache = s.cache(store, DOMAIN)
        store.start_session()
        store.put_json("/com/foo/web",
                       {"type": "host", "host": {"address": "10.0.0.5"}})
        node = cache.lookup("web.foo.com")
        copy = "web" + ".foo.com"
        return copy is not node.domain, cache.canon(copy) is node.domain

    assert both(scenario) == (True, True)


# -- TestChunkedRebuild -----------------------------------------------


def test_inline_rebuild_without_loop():
    def scenario(s):
        store, cache = zone(s, 500)
        store.start_session()
        pending0, epoch0 = cache.rebuild_pending(), cache.epoch
        store.expire_session()
        node = cache.lookup(host_name_under(DOMAIN, 7, 4))
        return (pending0, cache.rebuild_pending(), cache.epoch - epoch0,
                node.ip, len(cache.nodes),
                cache.last_rebuild_duration_s is not None)

    assert both(scenario) == (0, 0, 1, "10.0.0.7", 506, True)


def test_chunked_rebuild_serves_throughout():
    def scenario(s):
        async def run():
            store, cache = zone(s, 4000)
            store.start_session()
            name = host_name_under(DOMAIN, 123, 4)
            assert cache.lookup(name) is not None
            epoch0, chunks0 = cache.epoch, cache.rebuild_chunks
            store.expire_session()
            in_flight = cache.rebuild_pending() > 0
            bumped = cache.epoch - epoch0
            served, ips = 0, set()
            while cache.rebuild_pending():
                node = cache.lookup(name)
                assert node is not None, "lookup went dark mid-rebuild"
                ips.add(node.ip)
                served += 1
                await asyncio.sleep(0.001)
            return (in_flight, bumped, served > 0,
                    cache.rebuild_chunks - chunks0 > 1,
                    cache.epoch - epoch0, sorted(ips),
                    cache.lookup(name).data["host"]["address"],
                    len(cache.nodes))

        return asyncio.run(run())

    got = both(scenario)
    assert got == (True, 1, True, True, 1, ["10.0.0.123"], "10.0.0.123",
                   4006)


def test_rebuild_superseded_by_newer_session():
    def scenario(s):
        async def run():
            store, cache = zone(s, 3000)
            store.start_session()
            store.expire_session()
            in_flight = cache.rebuild_pending() > 0
            epoch1 = cache.epoch
            store.expire_session()      # churn mid-rebuild: restart walk
            bumped = cache.epoch - epoch1
            while cache.rebuild_pending():
                await asyncio.sleep(0.001)
            return (in_flight, bumped,
                    cache.lookup(host_name_under(DOMAIN, 42, 4)).ip,
                    len(cache.nodes), len(cache.rev_lookup))

        return asyncio.run(run())

    assert both(scenario) == (True, 1, "10.0.0.42", 3006, 3000)


def test_mutation_latency_independent_of_zone_size():
    """O(delta): p50 single-name mutation latency at 20x the zone size
    stays within the reference test's factor of 6, on each package."""
    def scenario(s):
        h_mod = s.probe

        def measure(n):
            store = s.store()
            s.populate(store, "bench.zone", n)
            cache = s.cache(store, "bench.zone")
            store.start_session()
            h = h_mod.Harness(cache)
            racks = max(1, min(1024, n // 512))
            lats = []
            for j in range(60):
                i = (j * max(1, n // 60)) % n
                h.prime(h_mod.host_name(i, racks))
                body = json.dumps(
                    {"type": "host",
                     "host": {"address": f"10.77.{j // 250}.{j % 250}"}}
                ).encode()
                t0 = time.perf_counter()
                store.set_data(h_mod.host_path(i, racks), body)
                lats.append(time.perf_counter() - t0)
            lats.sort()
            return lats[len(lats) // 2], h.pc.compiled

        (small, c_small), (large, c_large) = measure(1000), measure(20000)
        assert large / small < 6.0, (small, large)
        return c_small, c_large

    assert both(scenario) == (120, 120)


# -- TestLateDropAccounting -------------------------------------------


def test_late_drop_counter_and_flight_event():
    def scenario(s):
        recorder = s.recorder(capacity=16)
        collector = s.metrics()
        counter = collector.counter("binder_udp_late_drops_total", "test")
        srv = s.dns_server()
        srv.recorder = recorder
        srv.late_drop_counter = counter.labelled()
        srv.note_late_drops(3)
        srv.note_late_drops(2)          # same window: no second event
        first = (srv.udp_late_drops, counter.total(),
                 [(e["dropped"], e["total"]) for e in recorder.events()
                  if e["type"] == "udp-late-drop"])
        srv._late_drop_event_last -= srv.LATE_DROP_EVENT_WINDOW_S + 1
        srv.note_late_drops(1)
        return first, (srv.udp_late_drops, counter.total(),
                       [(e["dropped"], e["total"])
                        for e in recorder.events()
                        if e["type"] == "udp-late-drop"])

    first, later = both(scenario)
    assert first == (5, 5, [(3, 3)])
    assert later[:2] == (6, 6)
    assert len(later[2]) == 2 and later[2][-1][1] == 6


def test_late_drop_zero_is_a_noop():
    def scenario(s):
        srv = s.dns_server()
        srv.note_late_drops(0)
        return srv.udp_late_drops

    assert both(scenario) == 0


# -- TestMirrorMetricsExposition --------------------------------------


def families(text: str):
    """The ``# TYPE`` lines of an exposition, in order."""
    return [line for line in text.splitlines()
            if line.startswith("# TYPE ")]


def test_server_scrape_passes_mirror_validator(monkeypatch):
    """On the Python lane for the comparison (the reference has no C
    lane in this tree: its native gauges are the only families the
    port's C lane adds); the port's C-lane server passes as well."""
    def scenario(s):
        collector = s.metrics()
        store = s.store()
        store.put_json("/com/foo/web",
                       {"type": "host", "host": {"address": "10.0.0.1"}})
        cache = s.cache(store, DOMAIN, collector=collector)
        store.start_session()
        s.server(zk_cache=cache, dns_domain=DOMAIN, collector=collector,
                 cache_size=16)
        text = collector.expose()
        return validate_mirror_metrics(text), families(text)

    errs, c_fams = scenario(SIDES["port"])
    assert errs == []
    assert "# TYPE binder_zone_entries gauge" in c_fams
    pin_python_lane(monkeypatch, (port_server, port_dns_server),
                    (ref_server, ref_dns_server))
    errs, fams = both(scenario)
    assert errs == []
    assert any("binder_mirror_names" in f for f in fams)
    assert set(c_fams) - set(fams) == {
        f"# TYPE binder_{t}_{k} gauge" for t in ("fastpath", "zone")
        for k in ("entries", "bytes")}


def test_validator_rejects_missing_family():
    def scenario(s):
        collector = s.metrics()
        s.cache(s.store(), DOMAIN, collector=collector)
        return validate_mirror_metrics(collector.expose())

    errs = both(scenario)
    assert any("binder_udp_late_drops_total" in e for e in errs)


def test_rebuild_metrics_move():
    def scenario(s):
        collector = s.metrics()
        store = s.store()
        s.populate(store, DOMAIN, 1000, racks=2)
        cache = s.cache(store, DOMAIN, collector=collector)
        store.start_session()
        store.expire_session()
        text = collector.expose()
        chunks = [line for line in text.splitlines()
                  if line.startswith("binder_mirror_rebuild_chunks")]
        names = [line for line in text.splitlines()
                 if line.startswith("binder_mirror_names")]
        return ("binder_mirror_names" in text, bool(chunks)
                and float(chunks[0].split()[-1]) >= 1.0, names,
                families(text))

    present, moved, names, _ = both(scenario)
    assert present and moved
    assert names and float(names[0].split()[-1]) == 1004.0


# -- TestSharedWatchScaling -------------------------------------------

N_HOSTS, N_SVC, N_LB = 40, 4, 3
HOST = {"type": "host", "host": {"address": "10.3.0.1"}}
SVC = {"type": "service",
       "service": {"srvce": "_http", "proto": "_tcp", "port": 80}}
LB = {"type": "load_balancer", "load_balancer": {"address": "10.4.0.1"}}


async def wait_for(pred, timeout=8.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if pred():
            return True
        await asyncio.sleep(0.01)
    return False


def test_watch_table_scales_with_directories_not_names():
    """One data watch per mirrored znode, children watches only on the
    root and the service containers, through every mutation class and a
    session re-establishment, on each package's ZooKeeper client and
    test server."""
    def scenario(s):
        async def run():
            server = s.zk_server()
            await server.start()
            writer = s.zk("127.0.0.1", port=server.port,
                          session_timeout_ms=4000)
            client = None
            seen = []
            try:
                assert await wait_for(writer.is_connected)
                for i in range(N_HOSTS):
                    await writer.mkdirp(f"/com/foo/h{i:03d}",
                                        json.dumps(HOST).encode())
                for k in range(N_SVC):
                    await writer.mkdirp(f"/com/foo/svc{k}",
                                        json.dumps(SVC).encode())
                    for j in range(N_LB):
                        await writer.mkdirp(f"/com/foo/svc{k}/lb{j}",
                                            json.dumps(LB).encode())
                client = s.zk("127.0.0.1", port=server.port,
                              session_timeout_ms=4000)
                cache = s.cache(client, DOMAIN)
                seen.append(client._shared_nodes is cache.nodes)
                client.start()
                total = 1 + N_HOSTS + N_SVC * (1 + N_LB)
                seen.append(await wait_for(
                    lambda: len(cache.nodes) == total))
                state = server.state
                sid = client._session_id

                def mine(table):
                    return {p for p, sids in table.items() if sid in sids}

                seen.append(await wait_for(
                    lambda: len(mine(state.data_watches)) == total))
                dirs = {"/com/foo"} | {f"/com/foo/svc{k}"
                                       for k in range(N_SVC)}
                seen.append(sorted(mine(state.child_watches)))
                await writer.mkdirp("/com/foo/hnew",
                                    json.dumps(HOST).encode())
                seen.append(await wait_for(
                    lambda: cache.lookup("hnew.foo.com") is not None))
                await writer.set_data(
                    "/com/foo/svc0/lb0",
                    b'{"type": "load_balancer", '
                    b'"load_balancer": {"address": "10.4.9.9"}}')
                seen.append(await wait_for(
                    lambda: cache.lookup("lb0.svc0.foo.com").ip
                    == "10.4.9.9"))
                await writer.mkdirp("/com/foo/svc1/lbnew",
                                    json.dumps(LB).encode())
                seen.append(await wait_for(
                    lambda: cache.lookup("lbnew.svc1.foo.com")
                    is not None))
                await writer.mkdirp("/com/foo/svc9",
                                    json.dumps(SVC).encode())
                seen.append(await wait_for(
                    lambda: cache.lookup("svc9.foo.com") is not None))
                await writer.mkdirp("/com/foo/svc9/lb0",
                                    json.dumps(LB).encode())
                seen.append(await wait_for(
                    lambda: cache.lookup("lb0.svc9.foo.com") is not None))
                total += 4
                dirs |= {"/com/foo/svc9"}
                server.expire_session(client._session_id)
                seen.append(await wait_for(
                    lambda: client.is_connected()
                    and client._session_id != sid))
                sid = client._session_id
                seen.append(await wait_for(
                    lambda: len(mine(state.data_watches)) == total))
                seen.append(await wait_for(
                    lambda: mine(state.child_watches) == dirs))
                seen.append(sorted(mine(state.child_watches)))
                seen.append(len(cache.nodes))
                return seen
            finally:
                if client is not None:
                    client.close()
                writer.close()
                await server.stop()

        return asyncio.run(run())

    got = both(scenario)
    dirs = ["/com/foo"] + [f"/com/foo/svc{k}" for k in range(N_SVC)]
    assert got[:3] == [True, True, True]
    assert got[3] == dirs
    assert len(dirs) * 8 < 1 + N_HOSTS + N_SVC * (1 + N_LB)
    assert got[4:12] == [True] * 8
    assert got[12] == sorted(dirs + ["/com/foo/svc9"])
    assert got[13] == 1 + N_HOSTS + N_SVC * (1 + N_LB) + 4


# -- TestScaleAwareBackpressure ---------------------------------------


def test_precompile_bound_scales_with_zone():
    def scenario(s):
        store, cache = zone(s, 5000, domain="bench.zone", racks=0)
        store.start_session()
        h = s.probe.Harness(cache)
        return h.pc._max_pending(), h.pc.MAX_PENDING_CAP

    bound, cap = both(scenario)
    assert 5000 <= bound <= cap


def test_compiled_answers_match_engine_at_scale():
    def scenario(s):
        n = 3000
        store, cache = zone(s, n, domain="bench.zone", racks=0)
        store.start_session()
        h = s.probe.Harness(cache)
        racks = max(1, min(1024, n // 512))
        wires = []
        for i in (0, n // 2, n - 1):
            name = s.probe.host_name(i, racks)
            h.prime(name)
            before = (h.compiled_wire(name), h.engine_wire(name))
            store.set_data(s.probe.host_path(i, racks),
                           b'{"type": "host", '
                           b'"host": {"address": "10.99.0.1"}}')
            wires.append((before, (h.compiled_wire(name),
                                   h.engine_wire(name))))
        return wires, h.pc.compiled

    wires, _ = both(scenario)
    for before, after in wires:
        assert before[0] == before[1] and before[0] is not None
        assert after[0] == after[1] and after[0] != before[0]


def test_ptr_follows_compact_representation():
    def scenario(s):
        store, cache = zone(s, 600, domain="bench.zone", racks=0)
        store.start_session()
        h = s.probe.Harness(cache)
        racks = max(1, min(1024, 600 // 512))
        name = s.probe.host_name(0, racks)
        node = cache.lookup(name)
        rev = cache.reverse_lookup(node.ip)
        plan = h.resolver.plan_ptr(
            ".".join(reversed(node.ip.split("."))) + ".in-addr.arpa")
        return (rev is node, name, node.ip,
                [[r.target for r in g[0]] for g in plan.groups])

    same, name, ip, targets = both(scenario)
    assert same and targets[0][0] == name and ip == "10.0.0.0"


# -- the probes -------------------------------------------------------

PROBE_NAMES = 2_000


def run_probe(argv):
    out = subprocess.run([sys.executable, *argv], cwd=ROOT,
                         capture_output=True, timeout=120, check=True)
    return json.loads(out.stdout.decode().splitlines()[-1])


@pytest.mark.parametrize("kind,args,keys", [
    ("zone", ("100", "500"),
     ("names", "racks", "mirror_nodes", "mutation_samples",
      "parity_failures", "storm_burst", "storm_shed", "rebuild_miss_mid",
      "compiled")),
    ("verify", ("400",),
     ("names", "audit_sample", "mutation_samples", "checks",
      "violations", "skipped")),
])
def test_probe_matches_the_reference_probe(kind, args, keys):
    port = run_probe(["-m", f"binder_torch.probe.{kind}",
                      str(PROBE_NAMES), *args])
    ref = run_probe([os.path.join("tools", f"{kind}_probe.py"),
                     str(PROBE_NAMES), *args])
    assert list(port) == list(ref)
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["names"] == PROBE_NAMES
    if kind == "zone":
        assert port["parity_failures"] == 0
        assert port["rebuild_chunks"] >= 2
        assert port["pool"].keys() == ref["pool"].keys()
    else:
        assert port["violations"] == 0
        assert {s: v["count"] for s, v in port["propagation"].items()} \
            == {s: v["count"] for s, v in ref["propagation"].items()}
