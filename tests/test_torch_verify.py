"""Verifier parity: ``binder_torch.verify`` against ``binder_tpu.verify``.

The cases of the reference's ``tests/test_verify.py``
(``TestIncrementalChecker``, ``TestViolationRoundTrip``,
``TestPropagationTracer``, ``TestReplicaDigest``), each run as one
scenario against each package.  A scenario returns what the reference
test asserts on plus the checker's counters (checks, violations,
skips), the violation events and the replies' wire; the two packages'
observations must be equal and meet the reference test's expectations.
Live servers run on the Python lane for the comparison (the reference
has no C lane in this tree); the corrupt-answer round trip runs once
more on the port with its C lane resident.

The port changed one path of the checker (``checker.py:239-243``): a
drained delta queue starts again from an empty container.  It is held
here too: a burst drained, then single tags, give the same checks and
violations on both packages, and the port's queue ends empty.
"""
import asyncio
import socket
import time

import pytest

from binder_torch import server as port_server
from binder_torch.chaos import ChaosDriver as PortDriver
from binder_torch.chaos import FaultPlan as PortPlan
from binder_torch.dns import server as port_dns_server
from binder_torch.dns import wire as port_wire
from binder_torch.introspect import FlightRecorder as PortRecorder
from binder_torch.introspect import Introspector as PortIntrospector
from binder_torch.metrics.collector import MetricsCollector as PortMetrics
from binder_torch.shard import ReplicaStore as PortReplica
from binder_torch.shard import protocol as port_protocol
from binder_torch.shard import supervisor as port_supervisor
from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortCache
from binder_torch.store.cache import domain_to_path
from binder_torch.verify import PropagationTracer as PortTracer
from binder_torch.verify import Verifier as PortVerifier
from binder_tpu import server as ref_server
from binder_tpu.chaos import ChaosDriver as RefDriver
from binder_tpu.chaos import FaultPlan as RefPlan
from binder_tpu.dns import server as ref_dns_server
from binder_tpu.dns import wire as ref_wire
from binder_tpu.introspect import FlightRecorder as RefRecorder
from binder_tpu.introspect import Introspector as RefIntrospector
from binder_tpu.metrics.collector import MetricsCollector as RefMetrics
from binder_tpu.shard import ReplicaStore as RefReplica
from binder_tpu.shard import protocol as ref_protocol
from binder_tpu.shard import supervisor as ref_supervisor
from binder_tpu.store import FakeStore as RefStore
from binder_tpu.store import MirrorCache as RefCache
from binder_tpu.verify import PropagationTracer as RefTracer
from binder_tpu.verify import Verifier as RefVerifier
from chip_smoke import render_bstat
from tests.test_torch_fastio import pin_python_lane
from tools.lint import validate_status_snapshot, validate_verify_metrics

DOMAIN = "verify.unit"


class Side:
    def __init__(self, **kw):
        self.__dict__.update(kw)


SIDES = {
    "port": Side(server=port_server, wire=port_wire, metrics=PortMetrics,
                 recorder=PortRecorder, introspector=PortIntrospector,
                 store=PortStore, cache=PortCache, verifier=PortVerifier,
                 tracer=PortTracer, replica=PortReplica,
                 protocol=port_protocol, supervisor=port_supervisor,
                 plan=PortPlan, driver=PortDriver),
    "ref": Side(server=ref_server, wire=ref_wire, metrics=RefMetrics,
                recorder=RefRecorder, introspector=RefIntrospector,
                store=RefStore, cache=RefCache, verifier=RefVerifier,
                tracer=RefTracer, replica=RefReplica,
                protocol=ref_protocol, supervisor=ref_supervisor,
                plan=RefPlan, driver=RefDriver),
}


@pytest.fixture
def python_lane(monkeypatch):
    pin_python_lane(monkeypatch, (port_server, port_dns_server),
                    (ref_server, ref_dns_server))


def both(scenario, run=lambda x: x):
    """``scenario(side)`` on both packages; asserts equal observations
    and returns the port's."""
    got = {name: run(scenario(s)) for name, s in SIDES.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def both_async(scenario):
    return both(scenario, asyncio.run)


def make_fixture(s, recorder=None, collector=None):
    """8 hosts, one service with 3 members — every invariant has
    something to bite on."""
    store = s.store(recorder=recorder)
    cache = s.cache(store, DOMAIN, collector=collector, recorder=recorder)
    for i in range(8):
        store.put_json(domain_to_path(f"w{i}.{DOMAIN}"),
                       {"type": "host",
                        "host": {"address": f"10.77.0.{i + 1}"}})
    store.put_json(domain_to_path(f"svc.{DOMAIN}"),
                   {"type": "service",
                    "service": {"srvce": "_http", "proto": "_tcp",
                                "port": 80}})
    for i in range(3):
        store.put_json(domain_to_path(f"m{i}.svc.{DOMAIN}"),
                       {"type": "host",
                        "host": {"address": f"10.77.9.{i + 1}"}})
    store.start_session()
    return store, cache


def counters(vf):
    return {"checks": dict(vf.checks), "violations": dict(vf.violations),
            "skipped": dict(vf.skipped)}


def violation_events(recorder):
    """The recorder's verify-violation events without their clocks."""
    return [{k: v for k, v in e.items() if k not in ("t_mono", "t_wall")}
            for e in recorder.events() if e["type"] == "verify-violation"]


async def start_server(s, recorder, collector, **kw):
    store, cache = make_fixture(s, recorder=recorder, collector=collector)
    server = s.server.BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        host="127.0.0.1", port=0, collector=collector,
        query_log=kw.pop("query_log", False), flight_recorder=recorder,
        answer_precompile=True, verify={"auditIntervalSeconds": 0.05},
        **kw)
    await server.start()
    return server, store


async def udp_ask(s, port, name, qtype, qid=1):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class Proto(asyncio.DatagramProtocol):
        def connection_made(self, transport):
            transport.sendto(s.wire.make_query(name, qtype,
                                               qid=qid).encode())

        def datagram_received(self, data, addr):
            if not fut.done():
                fut.set_result(data)

    transport, _ = await loop.create_datagram_endpoint(
        Proto, remote_addr=("127.0.0.1", port))
    try:
        return await asyncio.wait_for(fut, 5.0)
    finally:
        transport.close()


# -- TestIncrementalChecker (no loop: enqueue drains inline) -------------


def test_clean_zone_checks_without_violations():
    def scenario(s):
        _, cache = make_fixture(s)
        vf = s.verifier(zk_cache=cache)
        vf.enqueue_tags(list(cache.nodes))
        return counters(vf)

    got = both(scenario)
    assert sum(got["checks"].values()) > 0
    assert sum(got["violations"].values()) == 0


def test_dropped_reverse_entry_is_ptr_coherence():
    def scenario(s):
        recorder = s.recorder(capacity=64)
        _, cache = make_fixture(s)
        vf = s.verifier(zk_cache=cache, recorder=recorder)
        popped = cache.rev_lookup.pop("10.77.0.3") is not None
        vf.enqueue_tags([f"w2.{DOMAIN}"])
        return popped, counters(vf), violation_events(recorder)

    popped, got, events = both(scenario)
    assert popped
    assert got["violations"]["ptr-coherence"] == 1
    assert events and events[-1]["invariant"] == "ptr-coherence"
    assert events[-1]["ip"] == "10.77.0.3"


def test_reverse_name_tag_checks_the_reverse_side():
    def scenario(s):
        _, cache = make_fixture(s)
        vf = s.verifier(zk_cache=cache)
        # the reverse entry points at a node the mirror no longer has
        node = cache.rev_lookup["10.77.0.1"]
        del cache.nodes[node.domain]
        vf.enqueue_tags(["1.0.77.10.in-addr.arpa"])
        return counters(vf)

    assert both(scenario)["violations"]["ptr-coherence"] == 1


def test_missing_service_member_is_dangling_srv():
    def scenario(s):
        _, cache = make_fixture(s)
        vf = s.verifier(zk_cache=cache)
        del cache.nodes[f"m1.svc.{DOMAIN}"]
        vf.enqueue_tags([f"svc.{DOMAIN}"])
        return counters(vf)

    assert both(scenario)["violations"]["dangling-srv"] == 1


def test_queue_sheds_past_cap_and_counts():
    def scenario(s):
        _, cache = make_fixture(s)
        vf = s.verifier(zk_cache=cache)
        n = vf.MAX_QUEUE + 500

        class _Tags:
            """Generator-shaped tag feed: shedding must not need a
            materialized list."""
            def __iter__(self):
                return (f"ghost{i}.{DOMAIN}" for i in range(n))

        vf.enqueue_tags(_Tags())
        return counters(vf)

    assert both(scenario)["skipped"]["queue-shed"] == 500


def test_note_digest_counts_and_violates():
    def scenario(s):
        recorder = s.recorder(capacity=64)
        _, cache = make_fixture(s)
        vf = s.verifier(zk_cache=cache, recorder=recorder)
        vf.note_digest(7, True)
        vf.note_digest(8, False, have="aaaa", want="bbbb")
        return counters(vf), violation_events(recorder)

    got, events = both(scenario)
    assert got["checks"]["replica-digest"] == 2
    assert got["violations"]["replica-digest"] == 1
    assert events[-1]["generation"] == 8
    assert events[-1]["have"] == "aaaa"


def test_a_drained_queue_checks_like_the_reference():
    """``checker.py:239-243``: a burst drained by the loop's budgeted
    passes, then single tags with a corruption between them: the same
    checks and violations on both packages, and the port's drained
    queue is empty."""
    async def scenario(s):
        _, cache = make_fixture(s)
        vf = s.verifier(zk_cache=cache)
        burst = list(cache.nodes) * 50
        vf.enqueue_tags(burst)
        while vf._queue:
            await asyncio.sleep(0.01)
        drained = counters(vf)
        cache.rev_lookup.pop("10.77.0.5")
        for tag in (f"w4.{DOMAIN}", f"w0.{DOMAIN}", f"svc.{DOMAIN}"):
            vf.enqueue_tags([tag])
            while vf._queue:
                await asyncio.sleep(0.01)
        return drained, counters(vf), vf._queue

    got = {name: asyncio.run(scenario(s)) for name, s in SIDES.items()}
    assert got["port"][:2] == got["ref"][:2]
    drained, after, queue = got["port"]
    assert sum(drained["violations"].values()) == 0
    assert after["violations"]["ptr-coherence"] == 1
    assert sum(after["checks"].values()) > sum(drained["checks"].values())
    assert queue == {}


# -- TestViolationRoundTrip ---------------------------------------------


async def corrupt_answer_run(s):
    recorder = s.recorder(capacity=256)
    collector = s.metrics()
    server, store = await start_server(s, recorder, collector)
    vf = server._verify
    try:
        # query evidence keeps the shape in the compiled table
        reply = await udp_ask(s, server.udp_port, f"w0.{DOMAIN}",
                              s.wire.Type.A)
        ckey = server.corrupt_answer()
        vf.audit_cycle()
        text = collector.expose()
        intro = s.introspector(server=server, recorder=recorder, name="t")
        intro.set_loop(asyncio.get_running_loop())
        snap = intro.snapshot()
        return {
            "reply": reply[2:], "ckey": ckey,
            "violations": vf.violations["compiled-bytes"],
            "events": [e["invariant"] for e in violation_events(recorder)],
            "counter": 'invariant="compiled-bytes"' in text,
            "metrics_errors": validate_verify_metrics(text),
            "status_errors": validate_status_snapshot(snap),
            "status_violations": snap["verify"]["violations"][
                "compiled-bytes"],
            "recent": sorted({v["invariant"] for v in
                              snap["verify"]["recent_violations"]}),
            "bstat": "VIOLATION compiled-bytes" in render_bstat(snap),
        }
    finally:
        await server.stop()


def corrupt_answer_expectations(got):
    assert s_rcode(got["reply"]) == ref_wire.Rcode.NOERROR
    assert got["ckey"] is not None
    assert got["violations"] >= 1
    assert "compiled-bytes" in got["events"]
    assert got["counter"]
    assert got["metrics_errors"] == [] and got["status_errors"] == []
    assert got["status_violations"] >= 1
    assert "compiled-bytes" in got["recent"]
    assert got["bstat"]


def s_rcode(reply_tail: bytes) -> int:
    return reply_tail[1] & 0x0F


@pytest.mark.usefixtures("python_lane")
def test_corrupt_answer_to_flight_metrics_status():
    corrupt_answer_expectations(both_async(corrupt_answer_run))


def test_corrupt_answer_round_trip_on_the_c_lane():
    got = asyncio.run(corrupt_answer_run(SIDES["port"]))
    corrupt_answer_expectations(got)


async def drop_reverse_run(s):
    recorder = s.recorder(capacity=256)
    collector = s.metrics()
    server, store = await start_server(s, recorder, collector)
    vf = server._verify
    try:
        ip = server.drop_reverse()
        vf.audit_cycle()
        return ip, counters(vf)["violations"]
    finally:
        await server.stop()


@pytest.mark.usefixtures("python_lane")
def test_drop_reverse_detected_by_audit():
    ip, violations = both_async(drop_reverse_run)
    assert ip is not None
    assert violations["ptr-coherence"] >= 1


async def stale_epoch_run(s):
    recorder = s.recorder(capacity=256)
    collector = s.metrics()
    server, store = await start_server(s, recorder, collector)
    vf = server._verify
    cache = server.zk_cache
    ac = server.answer_cache
    try:
        # flush: the epoch bump invalidates everything compiled; the
        # sweep purges old-epoch entries WITHOUT violating
        cache.invalidate_all("test-flush")
        vf.audit_cycle()
        swept = (vf._sweep_done, vf.violations["stale-epoch"],
                 all(e[0] == cache.epoch for e in ac._compiled.values()))
        # an old-epoch entry AFTER the table was declared clean is the
        # violation, and the zombie is purged
        ac.put_compiled(s.wire.Type.A, f"w3.{DOMAIN}", cache.epoch - 1,
                        [(b"\x00" * 24, 0)], False, f"w3.{DOMAIN}")
        vf.audit_cycle()
        return swept, vf.violations["stale-epoch"], \
            (s.wire.Type.A, f"w3.{DOMAIN}") in ac._compiled
    finally:
        await server.stop()


@pytest.mark.usefixtures("python_lane")
def test_stale_epoch_survivor_past_sweep():
    swept, violations, zombie = both_async(stale_epoch_run)
    assert swept == (True, 0, True)
    assert violations == 1
    assert not zombie


# -- TestPropagationTracer ----------------------------------------------


def test_distinct_ids_per_store_event():
    def scenario(s):
        tr = s.tracer()
        tr.on_store_event(1)
        a = tr.current[0]
        tr.on_store_event(2)
        return a != tr.current[0]

    assert both(scenario)


def test_observe_without_context_is_noop():
    def scenario(s):
        tr = s.tracer()
        tr.observe("mirror-apply")
        return tr.observed

    assert both(scenario) == 0


def test_inherited_context_consumed_exactly_once():
    def scenario(s):
        tr = s.tracer()
        tr.inherit("m1-aa", time.monotonic() - 0.5)
        tr.on_store_event(3)
        first = tr.current[0]
        tr.on_store_event(4)
        second = tr.current[0]
        # malformed handed-down fields never become a context
        tr.inherit(None, "not-a-time")
        tr.on_store_event(5)
        return first, second != "m1-aa", tr.current[0] != "m1-aa"

    assert both(scenario) == ("m1-aa", True, True)


def test_stage_latencies_fold_into_introspection():
    def scenario(s):
        tr = s.tracer()
        tr.inherit("m1-bb", time.monotonic() - 0.25)
        tr.on_store_event(1)
        tr.observe("mirror-apply")
        tr.observe("replica-apply")
        snap = tr.introspect()
        st = snap["stages"]["mirror-apply"]
        return (snap["observed"], sorted(snap["stages"]), st["count"],
                0.2 < st["p50_seconds"] < 5.0,
                [x["trace"] for x in snap["slowest"]][:1])

    observed, stages, count, p50_ok, slowest = both(scenario)
    assert (observed, count, p50_ok, slowest) == (2, 1, True, ["m1-bb"])
    assert "mirror-apply" in stages


async def mutation_to_install_run(s):
    recorder = s.recorder(capacity=256)
    collector = s.metrics()
    # query_log on without the JSON log ring keeps the queries in
    # Python (only evidenced shapes re-render on mutation)
    server, store = await start_server(s, recorder, collector,
                                       zone_precompile=False,
                                       query_log=True)
    vf = server._verify
    try:
        reply = await udp_ask(s, server.udp_port, f"w1.{DOMAIN}",
                              s.wire.Type.A)
        store.put_json(domain_to_path(f"w1.{DOMAIN}"),
                       {"type": "host", "host": {"address": "10.77.0.99"}})
        want = ("mirror-apply", "precompile-render", "compiled-install")
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            prop = vf.introspect()["propagation"]
            if all(prop["stages"][st]["count"] >= 1 for st in want):
                break
            await asyncio.sleep(0.02)
        return (reply[2:], {st: prop["stages"][st]["count"] >= 1
                            for st in want}, prop["observed"] >= 3)
    finally:
        await server.stop()


@pytest.mark.usefixtures("python_lane")
def test_mutation_to_install_traced_through_live_server():
    reply, stages, observed = both_async(mutation_to_install_run)
    assert s_rcode(reply) == ref_wire.Rcode.NOERROR
    assert all(stages.values()), stages
    assert observed


# -- TestReplicaDigest --------------------------------------------------


def node_frame(s, name, addr, tr=None, t0=None):
    return s.protocol.node_frame(
        f"{name}.{DOMAIN}", {"type": "host", "host": {"address": addr}},
        tr, t0)


def test_digest_deterministic_and_blind_to_trace_freight():
    def scenario(s):
        f1 = node_frame(s, "x", "10.1.1.1")
        f2 = node_frame(s, "x", "10.1.1.1", "m1-ff", 123.25)
        f3 = node_frame(s, "x", "10.1.1.2")
        d = s.protocol.delta_digest
        return (d("0", f1), d("0", f2), d("0", f3),
                d(d("0", f1), f3), d(d("0", f3), f1))

    d1, d2, d3, ab, ba = both(scenario)
    assert d1 == d2 and d1 != d3
    # chaining is order-sensitive (a log digest, not a set)
    assert ab != ba


def test_replica_flags_divergence_once_and_resyncs():
    def scenario(s):
        sup_end, worker_end = socket.socketpair()
        try:
            replica = s.replica(worker_end, 0)
            replica._dg = "0"           # as armed at snap-end
            outcomes = []
            replica.on_digest = lambda gen, ok, have, want: \
                outcomes.append((gen, ok))
            f = node_frame(s, "y", "10.2.2.2")
            replica._apply(f)
            good = s.protocol.delta_digest("0", f)
            replica._apply(s.protocol.digest_frame(1, good))
            first = list(outcomes)
            # the owner claims a digest we never saw the frames for
            replica._apply(s.protocol.digest_frame(2, "feedbeefdead0000"))
            sup_end.settimeout(5.0)
            frames = s.protocol.decode_frames(
                bytearray(sup_end.recv(65536)))
            reports = [(fr["ok"], fr["want"]) for fr in frames
                       if fr.get("op") == "digest-report"]
            return first, outcomes[-1], replica._dg, reports
        finally:
            sup_end.close()
            worker_end.close()

    first, last, dg, reports = both(scenario)
    assert first == [(1, True)]
    assert last == (2, False)
    # resynced to the owner's roll: no cascade on the next frame
    assert dg == "feedbeefdead0000"
    assert reports == [(False, "feedbeefdead0000")]


def test_delta_frame_trace_feeds_replica_tracer():
    def scenario(s):
        sup_end, worker_end = socket.socketpair()
        try:
            replica = s.replica(worker_end, 0)
            tracer = s.tracer()
            replica.tracer = tracer
            cache = s.cache(replica, DOMAIN)
            cache.tracer = tracer
            replica.start_session()
            # an untraced create first (a CREATE fires the parent's
            # children watch too); the traced flow is an UPDATE
            replica._apply(node_frame(s, "z", "10.3.3.1"))
            replica._apply(node_frame(s, "z", "10.3.3.3", "m9-01",
                                      time.monotonic() - 0.1))
            snap = tracer.introspect()
            traced = [x for x in snap["slowest"] if x["trace"] == "m9-01"]
            return (snap["stages"]["replica-apply"]["count"] >= 1,
                    bool(traced) and traced[0]["seconds"] > 0.05,
                    cache.lookup(f"z.{DOMAIN}").data["host"]["address"])
        finally:
            sup_end.close()
            worker_end.close()

    assert both(scenario) == (True, True, "10.3.3.3")


def test_parity_across_snapshot_reattach():
    """The shard-kill/respawn path: a replica re-attached through a
    fresh snapshot re-arms at "0" beside the owner's roll, so digests
    agree again."""
    class _StubProc:
        pid = 0

        def poll(self):
            return None

    async def scenario(s):
        store, cache = make_fixture(s)
        sup = s.supervisor.ShardSupervisor(
            options={"shards": 1, "host": "127.0.0.1", "port": 0,
                     "dnsDomain": DOMAIN},
            store=store, cache=cache, collector=s.metrics())
        sup._loop = asyncio.get_running_loop()

        def attach(shard):
            sup_end, worker_end = socket.socketpair()
            sup_end.setblocking(False)
            link = s.supervisor.ShardLink(shard, _StubProc(), sup_end)
            sup.links[shard] = link
            sup._send_snapshot(link)
            replica = s.replica(worker_end, shard)
            while link.snap_queue is not None:
                sup._pump_snapshot(link)
            replica.read_snapshot(timeout=30.0)
            return link, replica

        def drain_until(replica, done):
            replica._sock.settimeout(5.0)
            while not done():
                for frame in replica._recv_frames():
                    replica._apply(frame)

        out = []
        link, replica = attach(0)
        outcomes = []
        replica.on_digest = lambda gen, ok, have, want: outcomes.append(ok)
        out.append((replica._dg, link.dg))
        store.put_json(domain_to_path(f"w0.{DOMAIN}"),
                       {"type": "host", "host": {"address": "10.77.0.201"}})
        drain_until(replica, lambda: outcomes)
        out.append((list(outcomes), replica._dg == link.dg != "0",
                    replica._dg))
        # kill and respawn: a fresh link, snapshot and roll
        sup._close_link(link)
        del sup.links[0]
        replica.close()
        link2, replica2 = attach(0)
        outcomes2 = []
        replica2.on_digest = lambda gen, ok, have, want: \
            outcomes2.append(ok)
        out.append((replica2._dg, link2.dg,
                    replica2.exists(domain_to_path(f"w0.{DOMAIN}"))))
        store.put_json(domain_to_path(f"w0.{DOMAIN}"),
                       {"type": "host", "host": {"address": "10.77.0.202"}})
        drain_until(replica2, lambda: outcomes2)
        out.append((list(outcomes2), replica2._dg == link2.dg,
                    replica2._dg))
        sup._close_link(link2)
        replica2.close()
        return out

    armed, first, rearmed, second = both_async(scenario)
    assert armed == ("0", "0")
    assert first[0] and all(first[0]) and first[1]
    assert rearmed == ("0", "0", True)
    assert second[0] and all(second[0]) and second[1]


def test_chaos_verify_actions_reach_the_server():
    """The verify-plane actions through each package's driver against
    its own live server (Python lane): the same targets corrupted."""
    async def scenario(s):
        recorder = s.recorder(capacity=256)
        server, store = await start_server(s, recorder, s.metrics())
        try:
            plan = s.plan(seed=3).at(0.0, "corrupt-answer") \
                .at(0.01, "drop-reverse")
            driver = s.driver(plan, store=store, verify_target=server,
                              recorder=recorder)
            await driver.run()
            server._verify.audit_cycle()
            return ([a for _, a in driver.applied],
                    counters(server._verify)["violations"])
        finally:
            await server.stop()

    pin = pytest.MonkeyPatch()
    try:
        pin_python_lane(pin, (port_server, port_dns_server),
                        (ref_server, ref_dns_server))
        applied, violations = both_async(scenario)
    finally:
        pin.undo()
    assert applied == ["corrupt-answer", "drop-reverse"]
    assert violations["compiled-bytes"] >= 1
    assert violations["ptr-coherence"] >= 1
