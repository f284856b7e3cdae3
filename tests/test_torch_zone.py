"""Zone precompilation (fpcore.h zone table) on the C lane, through
both packages.

The cases of the reference's ``tests/test_zone.py``, each run as one
scenario against ``binder_torch`` and against ``binder_tpu``, both on
the C lane.  The reference finds no ``binder_tpu/_binderfastio`` in
this tree (its own test skips), so it gets the port's build of the same
``native/`` sources, loaded from a copy of the file under its own
module name (``ref_lane``), as ``test_torch_fastio.LANE_MAIN`` does for
a reference process.  Every scenario asserts the reference test's
values on each package; every answer wire and the zone-hit delta of
each ask are recorded, and the two packages' records must be equal.

Layers here:
- differential: every zone-served response must be byte-identical to
  the same server's generic-path response (zonePrecompile off), id
  aside — the zone can never answer differently, only faster;
- coherence: store mutations re-point zone answers through the same
  tag-invalidation path as the caches; deletions fall back to Python;
- policy: shapes the raw lane declines (service records, doubled
  dnsDomain suffixes, non-IN classes) are never zone-served;
- after events (``TestZoneAfterEvents``, the port's own): what the zone
  lane serves for an unchanged name after a session rebuild and after a
  degradation cycle, the same on both packages.
"""
import asyncio
import importlib.util
import os
import random
import re
import shutil
import struct

import pytest

import binder_torch.dns as port_dns
import binder_tpu.dns as ref_dns
from binder_torch import _binderfastio as port_fastio
from binder_torch import fastio_build
from binder_torch import server as port_server
from binder_torch.metrics.collector import MetricsCollector as PortMetrics
from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortCache
from binder_tpu import server as ref_server
from binder_tpu.dns import server as ref_dns_server
from binder_tpu.metrics.collector import MetricsCollector as RefMetrics
from binder_tpu.store import FakeStore as RefStore
from binder_tpu.store import MirrorCache as RefCache

DOMAIN = "foo.com"
SEED = 7

#: ``binder_tpu.dns.server``'s names for the extension's serve entries
SERVE_ENTRIES = {"_fp_serve_wire": "fastpath_serve_wire",
                 "_fp_serve_frames": "fastpath_serve_frames",
                 "_fp_serve_balancer": "fastpath_serve_balancer"}


class Side:
    """One package's names, and the record of what its scenario saw:
    per ask, the answer wire and the asked server's zone-hit delta."""

    def __init__(self, dns, server, metrics, store, cache, fastio):
        self.Message, self.Rcode = dns.Message, dns.Rcode
        self.Type, self.make_query = dns.Type, dns.make_query
        self.BinderServer = server.BinderServer
        self.MetricsCollector = metrics
        self.FakeStore, self.MirrorCache = store, cache
        self.fastio = fastio
        self.seen = []


@pytest.fixture(scope="module")
def ref_extension(tmp_path_factory):
    """The port's build of the extension, loaded a second time from a
    copy as ``binder_tpu._binderfastio`` (a copy, so each package's
    module has the shared object's static state to itself)."""
    built = fastio_build.build("extension")[0]
    copy = tmp_path_factory.mktemp("ref_lane") / os.path.basename(built)
    shutil.copy(built, copy)
    spec = importlib.util.spec_from_file_location(
        "binder_tpu._binderfastio", copy)
    ext = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ext)
    return ext


@pytest.fixture
def ref_lane(monkeypatch, ref_extension):
    """``binder_tpu`` on the C lane for the test."""
    monkeypatch.setattr(ref_server, "_fastio", ref_extension)
    monkeypatch.setattr(ref_dns_server, "_fastio", ref_extension)
    for attr, entry in SERVE_ENTRIES.items():
        monkeypatch.setattr(ref_dns_server, attr,
                            getattr(ref_extension, entry))
    return ref_extension


@pytest.fixture
def both(ref_lane):
    """``both(scenario)`` runs ``await scenario(side)`` on each package
    and asserts that the two recorded the same answers and zone-hit
    deltas."""
    def run(scenario):
        sides = {
            "port": Side(port_dns, port_server, PortMetrics, PortStore,
                         PortCache, port_fastio),
            "ref": Side(ref_dns, ref_server, RefMetrics, RefStore,
                        RefCache, ref_lane),
        }
        for s in sides.values():
            asyncio.run(scenario(s))
        assert sides["port"].seen, "the scenario recorded nothing"
        assert sides["port"].seen == sides["ref"].seen
    return run


def fixture_store(s):
    store = s.FakeStore()
    cache = s.MirrorCache(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "192.168.0.1"}})
    store.put_json("/com/foo/ttlhost",
                   {"type": "host", "ttl": 120,
                    "host": {"address": "10.9.9.9", "ttl": 77}})
    store.put_json("/com/foo/svc", {
        "type": "service",
        "service": {"srvce": "_pg", "proto": "_tcp", "port": 5432},
    })
    for i in range(2):
        store.put_json(f"/com/foo/svc/lb{i}",
                       {"type": "load_balancer",
                        "load_balancer": {"address": f"10.0.1.{i + 1}"}})
    store.start_session()
    return store, cache


async def start_server(s, cache, **kw):
    kw.setdefault("query_log", False)
    server = s.BinderServer(zk_cache=cache, dns_domain=DOMAIN,
                            datacenter_name="coal", host="127.0.0.1",
                            port=0, collector=s.MetricsCollector(), **kw)
    # the Python lane shuffles multi-record answers: the same draws on
    # both packages, so that their wires compare
    server.resolver.rng = random.Random(SEED)
    await server.start()
    return server


def zone_stats(s, server):
    return s.fastio.fastpath_stats(server._fastpath)


async def udp_ask_raw(port, wire, timeout=2.0):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class Proto(asyncio.DatagramProtocol):
        def connection_made(self, transport):
            self.transport = transport
            transport.sendto(wire)

        def datagram_received(self, data, addr):
            if not fut.done():
                fut.set_result(data)

    transport, _ = await loop.create_datagram_endpoint(
        Proto, remote_addr=("127.0.0.1", port))
    try:
        return await asyncio.wait_for(fut, timeout)
    finally:
        transport.close()


async def tcp_ask_raw(port, wire):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(struct.pack(">H", len(wire)) + wire)
    await writer.drain()
    (length,) = struct.unpack(">H", await reader.readexactly(2))
    data = await reader.readexactly(length)
    writer.close()
    await writer.wait_closed()
    return data


async def ask(s, server, wire, tcp=False):
    """``wire`` to ``server`` over UDP (or TCP); the answer's wire,
    recorded with the zone hits it added."""
    before = zone_stats(s, server)["zone_hits"]
    if tcp:
        got = await tcp_ask_raw(server.tcp_port, wire)
    else:
        got = await udp_ask_raw(server.udp_port, wire)
    s.seen.append((got, zone_stats(s, server)["zone_hits"] - before))
    return got


async def ask_msg(s, server, q, tcp=False):
    return s.Message.decode(await ask(s, server, q.encode(), tcp))


def _mixed_case(wire: bytes, lower: bytes, mixed: bytes) -> bytes:
    """Patch a query wire with true mixed-case qname bytes — make_query
    normalizes to lowercase, so dns0x20 shapes must be crafted at the
    wire level or the probe is vacuous."""
    assert lower in wire and lower.lower() == mixed.lower()
    return wire.replace(lower, mixed)


def probes(s):
    Type, make_query = s.Type, s.make_query
    return [
        ("A no-edns", make_query("web.foo.com", Type.A, qid=1,
                                 edns_payload=None).encode()),
        ("A rd", make_query("web.foo.com", Type.A, qid=2, rd=True,
                            edns_payload=None).encode()),
        ("A edns", make_query("web.foo.com", Type.A, qid=3,
                              edns_payload=1400).encode()),
        ("A 0x20", _mixed_case(
            make_query("web.foo.com", Type.A, qid=4).encode(),
            b"\x03web\x03foo\x03com", b"\x03WeB\x03fOo\x03CoM")),
        ("A ttl precedence", make_query("ttlhost.foo.com", Type.A,
                                        qid=5).encode()),
        ("PTR", make_query("1.0.168.192.in-addr.arpa", Type.PTR,
                           qid=6).encode()),
        ("PTR 0x20", _mixed_case(
            make_query("9.9.9.10.in-addr.arpa", Type.PTR, qid=7).encode(),
            b"\x07in-addr\x04arpa", b"\x07IN-aDdR\x04ArPa")),
    ]


class TestZoneDifferential:
    def test_zone_answers_equal_generic_and_never_reach_python(self, both):
        """Byte-differential: for every probe shape the zone-enabled
        server's FIRST response equals the zone-disabled server's, and
        it really came from the zone (zone_hits advanced, no Python
        resolve counted)."""
        async def run(s):
            _, cache_on = fixture_store(s)
            _, cache_off = fixture_store(s)
            on = await start_server(s, cache_on)
            off = await start_server(s, cache_off, zone_precompile=False)
            try:
                for label, wire in probes(s):
                    got = await ask(s, on, wire)
                    assert s.seen[-1][1] == 1, (label,
                                                "expected a zone serve")
                    want = await ask(s, off, wire)
                    assert got == want, label
                    if "0x20" in label:
                        # the requester's exact mixed-case bytes echo
                        assert wire[12:24] in got, label
                # and the decoded answer is actually right
                r = await ask_msg(s, on, s.make_query("web.foo.com",
                                                      s.Type.A, qid=9))
                assert r.rcode == s.Rcode.NOERROR
                assert r.answers[0].address == "192.168.0.1"
                # deepest-object-wins TTL precedence baked in at push
                r = await ask_msg(s, on, s.make_query("ttlhost.foo.com",
                                                      s.Type.A, qid=10))
                assert r.answers[0].ttl == 77
            finally:
                await on.stop()
                await off.stop()

        both(run)

    def test_shapes_the_zone_declines_are_not_zone_served(self, both):
        """Negative SRV shapes, missing names, and non-precompiled
        qtypes go through Python; the zone table must not touch them."""
        async def run(s):
            _, cache = fixture_store(s)
            server = await start_server(s, cache)
            Type, make_query = s.Type, s.make_query
            try:
                for q in (
                        # SRV with the WRONG srvce/proto: NXDOMAIN (engine)
                        make_query("_wrong._tcp.svc.foo.com", Type.SRV,
                                   qid=21),
                        # SRV on a non-service name we own: NODATA + SOA
                        make_query("_pg._tcp.web.foo.com", Type.SRV,
                                   qid=22),
                        make_query("absent.foo.com", Type.A, qid=23),
                        make_query("web.foo.com", Type.AAAA, qid=24)):
                    resp = await ask_msg(s, server, q)
                    assert s.seen[-1][1] == 0, q.questions[0]
                    assert resp.id == q.id
            finally:
                await server.stop()

        both(run)

    def test_srv_zone_served_content_equals_generic(self, both):
        """The registered SRV qname is precompiled — answers (per member
        per port, service TTL) and A additionals (member TTL) equal the
        generic path's in content; EDNS queries get the OPT appended as
        the last additional."""
        async def run(s):
            _, cache_on = fixture_store(s)
            _, cache_off = fixture_store(s)
            on = await start_server(s, cache_on)
            off = await start_server(s, cache_off, zone_precompile=False)
            try:
                def shape(r):
                    srv = sorted((a.name, a.ttl, a.priority, a.weight,
                                  a.port, a.target) for a in r.answers)
                    add = sorted((a.name, a.ttl, a.address)
                                 for a in r.additionals
                                 if hasattr(a, "address"))
                    return r.rcode, srv, add

                for qid, kw in ((31, {"edns_payload": None}),
                                (32, {"edns_payload": 1400})):
                    q = s.make_query("_pg._tcp.svc.foo.com", s.Type.SRV,
                                     qid=qid, **kw)
                    got = await ask_msg(s, on, q)
                    assert s.seen[-1][1] == 1, kw
                    want = await ask_msg(s, off, q)
                    assert shape(got) == shape(want), kw
                    assert len(got.answers) == 2
                    assert {a.target for a in got.answers} == \
                        {"lb0.svc.foo.com", "lb1.svc.foo.com"}
            finally:
                await on.stop()
                await off.stop()

        both(run)

    def test_srv_member_mutation_repoints_through_alien_table(self, both):
        """SRV entries are tagged with the service NODE name (not their
        qname): a member mutation's parent tag must drop and re-push
        them through the C side's alien-table scan."""
        async def run(s):
            store, cache = fixture_store(s)
            server = await start_server(s, cache)
            try:
                r = await ask_msg(s, server, s.make_query(
                    "_pg._tcp.svc.foo.com", s.Type.SRV, qid=41))
                assert len(r.answers) == 2
                store.put_json("/com/foo/svc/lb9",
                               {"type": "load_balancer",
                                "load_balancer": {"address": "10.0.1.9",
                                                  "ports": [100, 200]}})
                await asyncio.sleep(0)
                r = await ask_msg(s, server, s.make_query(
                    "_pg._tcp.svc.foo.com", s.Type.SRV, qid=42))
                assert s.seen[-1][1] == 1
                # 2 original members (1 port each) + new member x2 ports
                assert len(r.answers) == 4
                ports = {a.port for a in r.answers
                         if a.target == "lb9.svc.foo.com"}
                assert ports == {100, 200}
            finally:
                await server.stop()

        both(run)

    def test_service_a_rotation_zone_served(self, both):
        """Service plain-A answers come precompiled: full member set per
        answer (content equal to the generic path's), served natively,
        rotating so every member leads over repeated queries."""
        async def run(s):
            _, cache_on = fixture_store(s)
            _, cache_off = fixture_store(s)
            on = await start_server(s, cache_on)
            off = await start_server(s, cache_off, zone_precompile=False)
            try:
                def addrsets(r):
                    return sorted((a.address, a.ttl) for a in r.answers)

                want = await ask_msg(s, off, s.make_query(
                    "svc.foo.com", s.Type.A, qid=90))
                leads = set()
                for i in range(6):
                    got = await ask_msg(s, on, s.make_query(
                        "svc.foo.com", s.Type.A, qid=91 + i))
                    assert s.seen[-1][1] == 1
                    assert got.rcode == s.Rcode.NOERROR
                    assert addrsets(got) == addrsets(want)
                    leads.add(got.answers[0].address)
                # both members lead at least once (cyclic rotation)
                assert leads == {"10.0.1.1", "10.0.1.2"}
            finally:
                await on.stop()
                await off.stop()

        both(run)

    def test_service_member_mutation_repoints_rotation(self, both):
        async def run(s):
            store, cache = fixture_store(s)
            server = await start_server(s, cache)
            try:
                r = await ask_msg(s, server, s.make_query(
                    "svc.foo.com", s.Type.A, qid=95))
                assert {a.address for a in r.answers} == \
                    {"10.0.1.1", "10.0.1.2"}
                store.put_json("/com/foo/svc/lb2",
                               {"type": "load_balancer",
                                "load_balancer": {"address": "10.0.1.3"}})
                await asyncio.sleep(0)
                r = await ask_msg(s, server, s.make_query(
                    "svc.foo.com", s.Type.A, qid=96))
                assert {a.address for a in r.answers} == \
                    {"10.0.1.1", "10.0.1.2", "10.0.1.3"}
                assert s.seen[-1][1] == 1
            finally:
                await server.stop()

        both(run)

    def test_service_min_ttl_matches_generic(self, both):
        """min(service-ttl, member-ttl) parity (lib/server.js:403-414)
        must be baked into the precompiled bodies."""
        async def run(s):
            store = s.FakeStore()
            cache = s.MirrorCache(store, DOMAIN)
            store.put_json("/com/foo/tsvc", {
                "type": "service", "ttl": 100,
                "service": {"srvce": "_x", "proto": "_tcp", "port": 1}})
            store.put_json("/com/foo/tsvc/m0",
                           {"type": "load_balancer", "ttl": 40,
                            "load_balancer": {"address": "10.3.0.1"}})
            store.put_json("/com/foo/tsvc/m1",
                           {"type": "load_balancer",
                            "load_balancer": {"address": "10.3.0.2"}})
            store.start_session()
            server = await start_server(s, cache)
            try:
                r = await ask_msg(s, server, s.make_query(
                    "tsvc.foo.com", s.Type.A, qid=97))
                assert s.seen[-1][1] == 1
                ttls = {a.address: a.ttl for a in r.answers}
                assert ttls == {"10.3.0.1": 40, "10.3.0.2": 100}
            finally:
                await server.stop()

        both(run)

    def test_service_with_invalid_member_declines_to_python(self, both):
        """A structurally invalid member makes the generic path SERVFAIL
        mid-set; the zone must decline rather than answer differently."""
        async def run(s):
            store, cache = fixture_store(s)
            store.put_json("/com/foo/svc/bad",
                           {"type": "load_balancer",
                            "load_balancer": "not-a-dict"})
            server = await start_server(s, cache)
            try:
                r = await ask_msg(s, server, s.make_query(
                    "svc.foo.com", s.Type.A, qid=98))
                assert s.seen[-1][1] == 0
                assert r.rcode == s.Rcode.SERVFAIL
            finally:
                await server.stop()

        both(run)

    def test_doubled_suffix_policy_not_pushed(self, both):
        """Names the resolver REFUSES by suffix policy (doubled
        dnsDomain) must never be precompiled even if a store node
        exists at that domain."""
        async def run(s):
            store = s.FakeStore()
            cache = s.MirrorCache(store, DOMAIN)
            # a real znode whose domain is foo.com.foo.com
            store.put_json("/com/foo/com/foo",
                           {"type": "host",
                            "host": {"address": "10.1.2.3"}})
            store.start_session()
            server = await start_server(s, cache)
            try:
                resp = await ask_msg(s, server, s.make_query(
                    "foo.com.foo.com", s.Type.A, qid=31))
                assert resp.rcode == s.Rcode.REFUSED
                assert zone_stats(s, server)["zone_hits"] == 0
            finally:
                await server.stop()

        both(run)


class TestZoneCoherence:
    def test_mutation_repoints_zone_answer(self, both):
        """A store mutation must re-point the precompiled answer (drop
        via tag invalidation + fresh push from the same event) — and the
        NEW answer is still zone-served, not a Python fallback."""
        async def run(s):
            store, cache = fixture_store(s)
            server = await start_server(s, cache)
            Type, make_query = s.Type, s.make_query
            try:
                r = await ask_msg(s, server,
                                  make_query("web.foo.com", Type.A, qid=41))
                assert r.answers[0].address == "192.168.0.1"

                store.put_json("/com/foo/web",
                               {"type": "host",
                                "host": {"address": "192.168.0.99"}})
                await asyncio.sleep(0)   # watch delivery (sync store)

                r = await ask_msg(s, server,
                                  make_query("web.foo.com", Type.A, qid=42))
                assert r.answers[0].address == "192.168.0.99"
                assert s.seen[-1][1] == 1

                # the reverse tree re-pointed too: old PTR gone, new live
                r = await ask_msg(s, server, make_query(
                    "99.0.168.192.in-addr.arpa", Type.PTR, qid=43))
                assert r.rcode == s.Rcode.NOERROR
                assert r.answers[0].target == "web.foo.com"
                r = await ask_msg(s, server, make_query(
                    "1.0.168.192.in-addr.arpa", Type.PTR, qid=44))
                assert r.rcode == s.Rcode.REFUSED
            finally:
                await server.stop()

        both(run)

    def test_mutation_burst_bounded_drain_stays_fresh(self, both):
        """A burst of mutations larger than the zone drain batch (r5
        churn coalescing): answers must be FRESH immediately (raw-lane /
        generic fallback while the name's re-push is still queued in the
        dirty set) and zone-served again once the bounded drain catches
        up — never stale in between."""
        async def run(s):
            store, cache = fixture_store(s)
            n = s.BinderServer._ZONE_DRAIN_BATCH * 2 + 10
            for i in range(n):
                store.put_json(f"/com/foo/h{i}",
                               {"type": "host",
                                "host": {"address": f"10.7.{i // 250}.{i % 250 + 1}"}})
            server = await start_server(s, cache)
            try:
                # mutate every host in one synchronous burst
                for i in range(n):
                    store.put_json(f"/com/foo/h{i}",
                                   {"type": "host",
                                    "host": {"address":
                                             f"10.8.{i // 250}.{i % 250 + 1}"}})
                assert len(server._zone_dirty) >= n
                # immediately (zero loop turns for the drain to run a
                # full catch-up): every answer must already be the NEW
                # address, whatever path serves it
                for i in (0, n // 2, n - 1):
                    r = await ask_msg(s, server, s.make_query(
                        f"h{i}.foo.com", s.Type.A, qid=i))
                    assert r.answers[0].address == \
                        f"10.8.{i // 250}.{i % 250 + 1}"
                # let the bounded drain finish, then everything is
                # zone-served again
                for _ in range(10):
                    if not server._zone_dirty:
                        break
                    await asyncio.sleep(0)
                assert not server._zone_dirty
                assert not server._zone_drain_pending
                for i in (1, n - 2):
                    r = await ask_msg(s, server, s.make_query(
                        f"h{i}.foo.com", s.Type.A, qid=1000 + i))
                    assert r.answers[0].address == \
                        f"10.8.{i // 250}.{i % 250 + 1}"
                    assert s.seen[-1][1] == 1
            finally:
                await server.stop()

        both(run)

    def test_deleted_node_falls_back_to_python_refused(self, both):
        async def run(s):
            store, cache = fixture_store(s)
            server = await start_server(s, cache)
            try:
                store.delete("/com/foo/web")
                await asyncio.sleep(0)
                r = await ask_msg(s, server, s.make_query(
                    "web.foo.com", s.Type.A, qid=51))
                assert r.rcode == s.Rcode.REFUSED
                assert s.seen[-1][1] == 0
            finally:
                await server.stop()

        both(run)

    def test_type_change_host_to_service_drops_zone_entry(self, both):
        async def run(s):
            store, cache = fixture_store(s)
            server = await start_server(s, cache)
            try:
                store.put_json("/com/foo/web", {
                    "type": "service",
                    "service": {"srvce": "_x", "proto": "_tcp",
                                "port": 1}})
                await asyncio.sleep(0)
                r = await ask_msg(s, server, s.make_query(
                    "web.foo.com", s.Type.A, qid=61))
                # service with no children: NODATA-ish per engine policy;
                # what matters here is the zone did NOT serve stale host
                assert s.seen[-1][1] == 0
                assert not r.answers or \
                    r.answers[0].address != "192.168.0.1"
            finally:
                await server.stop()

        both(run)

    def test_zone_precompile_off_serves_nothing_from_zone(self, both):
        async def run(s):
            _, cache = fixture_store(s)
            server = await start_server(s, cache, zone_precompile=False)
            try:
                r = await ask_msg(s, server, s.make_query(
                    "web.foo.com", s.Type.A, qid=71))
                assert r.answers[0].address == "192.168.0.1"
                assert zone_stats(s, server)["zone_hits"] == 0
                assert zone_stats(s, server)["zone_entries"] == 0
            finally:
                await server.stop()

        both(run)

    def test_zone_serves_fold_into_metrics(self, both):
        """Zone serves surface in the Prometheus scrape: the per-qtype
        request counter advances and binder_zone_serves counts them."""
        async def run(s):
            _, cache = fixture_store(s)
            server = await start_server(s, cache)
            try:
                for i in range(3):
                    await ask(s, server, s.make_query(
                        "web.foo.com", s.Type.A, qid=80 + i).encode())
                text = server.collector.expose()
                assert 'binder_zone_serves_total 3' in text.replace(
                    "binder_zone_serves 3", "binder_zone_serves_total 3")
                # residency gauges expose the native tables' state:
                # fixture has web + ttlhost (A), their PTRs, svc A, SRV
                m = re.search(r"binder_zone_entries (\d+)", text)
                assert m and int(m.group(1)) >= 6, text[:400]
                assert re.search(r"binder_zone_bytes [1-9]", text)
                s.seen.append(re.findall(r"^binder_zone_\w+ .*$", text,
                                         re.M))
            finally:
                await server.stop()

        both(run)


class TestZoneChurnSoak:
    def test_randomized_churn_read_your_writes(self, both):
        """Randomized mutation soak over the live UDP stack with the
        native path fully engaged: after every store mutation the next
        query for the touched name must reflect it — whether it is
        served from the zone, the caches, or Python.  Pins the
        drop-then-repush coherence of _on_store_invalidate under
        arbitrary interleavings (the single-shot repoint tests cannot
        reach orderings a random walk does)."""
        import random as _random

        async def run(s):
            rng = _random.Random(0x5A)
            store = s.FakeStore()
            cache = s.MirrorCache(store, DOMAIN)
            hosts = {f"h{i}": f"10.50.0.{i + 1}" for i in range(8)}
            for h, ip in hosts.items():
                store.put_json(f"/com/foo/{h}",
                               {"type": "host", "host": {"address": ip}})
            svc_members = {f"m{i}": f"10.51.0.{i + 1}" for i in range(3)}
            store.put_json("/com/foo/zsvc", {
                "type": "service",
                "service": {"srvce": "_z", "proto": "_tcp", "port": 9}})
            for m, ip in svc_members.items():
                store.put_json(f"/com/foo/zsvc/{m}",
                               {"type": "load_balancer",
                                "load_balancer": {"address": ip}})
            store.start_session()
            server = await start_server(s, cache)
            Type, make_query = s.Type, s.make_query
            try:
                for step in range(120):
                    op = rng.randrange(4)
                    if op == 0:         # re-address a host
                        h = rng.choice(sorted(hosts))
                        hosts[h] = f"10.50.{rng.randrange(1, 200)}." \
                                   f"{rng.randrange(1, 200)}"
                        store.put_json(f"/com/foo/{h}",
                                       {"type": "host",
                                        "host": {"address": hosts[h]}})
                    elif op == 1 and len(hosts) > 2:   # delete a host
                        h = rng.choice(sorted(hosts))
                        del hosts[h]
                        store.delete(f"/com/foo/{h}")
                    elif op == 2:       # (re-)add a host
                        h = f"h{rng.randrange(12)}"
                        hosts[h] = f"10.50.{rng.randrange(1, 200)}." \
                                   f"{rng.randrange(1, 200)}"
                        store.put_json(f"/com/foo/{h}",
                                       {"type": "host",
                                        "host": {"address": hosts[h]}})
                    else:               # churn a service member
                        m = rng.choice(sorted(svc_members))
                        svc_members[m] = f"10.51.{rng.randrange(1, 200)}" \
                                         f".{rng.randrange(1, 200)}"
                        store.put_json(f"/com/foo/zsvc/{m}",
                                       {"type": "load_balancer",
                                        "load_balancer":
                                        {"address": svc_members[m]}})
                    await asyncio.sleep(0)   # watch delivery

                    # read-your-writes on a random live host
                    if hosts:
                        h = rng.choice(sorted(hosts))
                        r = await ask_msg(s, server, make_query(
                            f"{h}.foo.com", Type.A, qid=step + 1))
                        assert r.rcode == s.Rcode.NOERROR, (step, h)
                        assert r.answers[0].address == hosts[h], (step, h)
                    # service plain-A and SRV reflect the member set
                    r = await ask_msg(s, server, make_query(
                        "zsvc.foo.com", Type.A, qid=1000 + step))
                    assert {a.address for a in r.answers} == \
                        set(svc_members.values()), step
                    r = await ask_msg(s, server, make_query(
                        "_z._tcp.zsvc.foo.com", Type.SRV, qid=2000 + step))
                    assert {a.address for a in r.additionals
                            if hasattr(a, "address")} == \
                        set(svc_members.values()), step

                # the soak must have exercised the native zone path
                # heavily, not just Python fallbacks
                assert zone_stats(s, server)["zone_hits"] > 200
            finally:
                await server.stop()

        both(run)


class TestServeWireLanes:
    def test_tcp_lane_served_natively(self, both):
        """TCP queries for precompiled shapes are answered by
        fastpath_serve_wire without entering the Python resolver, with
        content equal to the zone-disabled server's TCP answer."""
        async def run(s):
            _, cache_on = fixture_store(s)
            _, cache_off = fixture_store(s)
            on = await start_server(s, cache_on)
            off = await start_server(s, cache_off, zone_precompile=False)
            try:
                q = s.make_query("web.foo.com", s.Type.A, qid=61).encode()
                got = await ask(s, on, q, tcp=True)
                assert s.seen[-1][1] == 1
                want = await ask(s, off, q, tcp=True)
                assert got == want
                # SRV over TCP too (alien-table lookup through the
                # wire entry point)
                r = await ask_msg(s, on, s.make_query(
                    "_pg._tcp.svc.foo.com", s.Type.SRV, qid=62), tcp=True)
                assert r.rcode == s.Rcode.NOERROR and len(r.answers) == 2
                assert s.seen[-1][1] == 1
            finally:
                await on.stop()
                await off.stop()

        both(run)

    def test_udp_lane_does_not_double_lookup(self, both):
        """Direct-UDP misses already checked the native path inside the
        drain; _handle_raw must not consult it again (lookups would
        double and skew the hit-rate metric)."""
        async def run(s):
            _, cache = fixture_store(s)
            server = await start_server(s, cache)
            try:
                before = zone_stats(s, server)["lookups"]
                await ask(s, server, s.make_query(
                    "absent.foo.com", s.Type.A, qid=71).encode())
                after = zone_stats(s, server)["lookups"]
                assert after == before + 1, (before, after)
            finally:
                await server.stop()

        both(run)

    def test_tcp_gate_closed_stays_python(self, both):
        """With per-query logging on (the fastpath gate), TCP queries
        must surface to Python like everything else."""
        async def run(s):
            _, cache = fixture_store(s)
            server = await start_server(s, cache, query_log=True)
            try:
                r = await ask_msg(s, server, s.make_query(
                    "web.foo.com", s.Type.A, qid=81), tcp=True)
                assert r.answers[0].address == "192.168.0.1"
                assert zone_stats(s, server)["zone_hits"] == 0
                assert zone_stats(s, server)["lookups"] == 0
            finally:
                await server.stop()

        both(run)


class TestTruncationNotReplayedOverTcp:
    def test_tc_cached_udp_response_not_served_to_tcp(self, both):
        """An oversize answer set truncates for a no-EDNS UDP client
        (TC=1, answers emptied) and that TC wire lands in the native
        answer cache — correct for UDP repeats.  A TCP client asking
        the byte-identical question must still get the FULL answer set:
        the wire-serve entry declines truncated wires and Python (whose
        cache keys carry transport semantics) answers."""
        async def run(s):
            store = s.FakeStore()
            cache = s.MirrorCache(store, DOMAIN)
            store.put_json("/com/foo/big", {
                "type": "service",
                "service": {"srvce": "_b", "proto": "_tcp", "port": 1}})
            n_members = 40          # 40 x 16B answers ≈ 640B > 512
            for i in range(n_members):
                store.put_json(f"/com/foo/big/m{i:02d}",
                               {"type": "load_balancer",
                                "load_balancer":
                                {"address": f"10.60.{i // 250}.{i + 1}"}})
            store.start_session()
            server = await start_server(s, cache)
            try:
                q = s.make_query("big.foo.com", s.Type.A, qid=90,
                                 edns_payload=None)
                # UDP: truncated (no EDNS ceiling), TC wire now cached
                # rotatable entries only complete (and push natively)
                # after the full variant set is collected — resolve
                # enough times for the TC wire to reach the C cache
                # one extra repeat: promotion to the C cache happens on
                # the completed entry's first hit (r5)
                for _ in range(9):
                    u = await ask_msg(s, server, q)
                    assert u.tc and not u.answers
                # the TC wire really is native-cached: the repeat UDP
                # query is a C hit and still TC (correct for UDP) —
                # without this, the TCP assertion below passes vacuously
                before = zone_stats(s, server)["hits"]
                u2 = await ask_msg(s, server, q)
                assert u2.tc
                assert zone_stats(s, server)["hits"] == before + 1
                # byte-identical question over TCP: full answer set
                t = await ask_msg(s, server, q, tcp=True)
                assert not t.tc
                assert len(t.answers) == n_members, len(t.answers)
                s.seen.append(sorted(a.address for a in t.answers))
            finally:
                await server.stop()

        both(run)


class TestZoneEpochRebuild:
    def test_session_rebuild_repoints_zone_via_epoch(self, both):
        """A (re)session rebuild bumps the mirror epoch: pre-rebuild
        zone entries must never serve again (lazy epoch drop), and the
        re-fired watch deliveries re-push fresh entries under the new
        epoch — queries stay correct across the whole transition, and
        post-rebuild serves are native again."""
        async def run(s):
            store, cache = fixture_store(s)
            server = await start_server(s, cache)
            try:
                r = await ask_msg(s, server, s.make_query(
                    "web.foo.com", s.Type.A, qid=11))
                assert r.answers[0].address == "192.168.0.1"
                old_epoch = cache.epoch

                # mutate + rebuild back-to-back: the rebuild's re-fired
                # data deliveries must repopulate with CURRENT data
                store.put_json("/com/foo/web",
                               {"type": "host",
                                "host": {"address": "192.168.0.55"}})
                cache.rebuild()
                await asyncio.sleep(0)   # watch re-delivery (sync store)
                assert cache.epoch == old_epoch + 1

                r = await ask_msg(s, server, s.make_query(
                    "web.foo.com", s.Type.A, qid=12))
                assert r.answers[0].address == "192.168.0.55"
                # served natively under the NEW epoch, not via Python
                assert s.seen[-1][1] == 1
                # SRV (alien table) survived the transition too
                r = await ask_msg(s, server, s.make_query(
                    "_pg._tcp.svc.foo.com", s.Type.SRV, qid=13))
                assert r.rcode == s.Rcode.NOERROR and len(r.answers) == 2
            finally:
                await server.stop()

        both(run)


class TestZoneDatabaseAndBalancerLane:
    def test_database_record_zone_served_differentially(self, both):
        """Database records (A from the primary URL's hostname,
        engine.resolve's database branch) precompile when the hostname
        is a canonical IPv4; a hostname that is NOT an address stays in
        Python (whatever it does there, the zone must not differ)."""
        async def run(s):
            def stores():
                store = s.FakeStore()
                cache = s.MirrorCache(store, DOMAIN)
                store.put_json("/com/foo/pg", {
                    "type": "database", "ttl": 45,
                    "database": {"primary":
                                 "tcp://10.4.4.4:5432/moray"}})
                store.put_json("/com/foo/pgname", {
                    "type": "database",
                    "database": {"primary":
                                 "tcp://pg.example.net:5432/moray"}})
                # non-string primary: must decline quietly, not
                # traceback through the mutation path (urlparse raises
                # AttributeError on non-str)
                store.put_json("/com/foo/pgbad", {
                    "type": "database", "database": {"primary": 45}})
                store.start_session()
                return cache

            on = await start_server(s, stores())
            off = await start_server(s, stores(), zone_precompile=False)
            try:
                wire = s.make_query("pg.foo.com", s.Type.A,
                                    qid=51).encode()
                got = await ask(s, on, wire)
                assert s.seen[-1][1] == 1
                want = await ask(s, off, wire)
                assert got == want
                r = s.Message.decode(got)
                assert r.answers[0].address == "10.4.4.4"
                assert r.answers[0].ttl == 45

                # non-IP primary hostname and non-string primary: never
                # precompiled; responses still agree with the generic
                # path
                for qid, name in ((52, "pgname.foo.com"),
                                  (53, "pgbad.foo.com")):
                    wire = s.make_query(name, s.Type.A, qid=qid).encode()
                    got = await ask(s, on, wire)
                    assert s.seen[-1][1] == 0, name
                    want = await ask(s, off, wire)
                    assert got == want, name
            finally:
                await on.stop()
                await off.stop()

        both(run)

    def test_balancer_lane_zone_served(self, both):
        """Queries arriving over the balancer socket protocol (a
        balancer-fronted backend's only lane) are zone-served through
        the wire entry point without touching the Python resolver."""
        async def run(s):
            _, cache = fixture_store(s)
            server = await start_server(s, cache)
            try:
                out = []
                wire = s.make_query("web.foo.com", s.Type.A,
                                    qid=61).encode()
                before = zone_stats(s, server)["zone_hits"]
                server.engine._handle_raw(
                    wire, ("10.0.0.9", 5353), "balancer", out.append,
                    client_transport="udp")
                assert out, "no response emitted"
                assert zone_stats(s, server)["zone_hits"] == before + 1
                s.seen.append((out[0], 1))
                r = s.Message.decode(out[0])
                assert r.id == 61
                assert r.answers[0].address == "192.168.0.1"
            finally:
                await server.stop()

        both(run)


class TestZoneAfterEvents:
    def test_unchanged_name_leaves_the_zone_after_a_rebuild_and_a_cycle(
            self, both):
        """What the smoke's zone phase found at 100,000 names (leg c),
        pinned here at the fixture's size on both packages: after a
        session rebuild, and again after a degradation cycle (session
        lost, stale-serving, session back, fresh), an UNCHANGED name is
        answered right, with its own TTL once fresh and the clamp while
        stale, but never from the C zone again: each event bumps the
        mirror epoch, the old-epoch zone entries drop lazily, and only a
        mutation re-pushes a name.  The reference does the same, ask for
        ask (it has no refill either).  A name mutated after the events
        is zone-served at once."""
        async def run(s):
            store, cache = fixture_store(s)
            server = await start_server(
                s, cache, degradation={"maxStalenessSeconds": 60,
                                       "staleTtlClampSeconds": 5})

            async def name_ask(name, qid):
                r = await ask_msg(s, server, s.make_query(name, s.Type.A,
                                                          qid=qid))
                return r, s.seen[-1][1] == 1

            try:
                r, zoned = await name_ask("web.foo.com", 1)
                assert zoned and r.answers[0].ttl == 30

                store.expire_session()
                await asyncio.sleep(0)
                for qid in (2, 3, 4):
                    r, zoned = await name_ask("web.foo.com", qid)
                    assert r.answers[0].address == "192.168.0.1"
                    assert r.answers[0].ttl == 30
                    assert not zoned, "zone served after the rebuild"

                store.lose_session()
                r, zoned = await name_ask("ttlhost.foo.com", 5)
                assert server._policy.mode() == "stale-serving"
                assert r.answers[0].address == "10.9.9.9"
                assert r.answers[0].ttl == 5 and not zoned
                store.start_session()
                await asyncio.sleep(0)
                assert server._policy.mode() == "fresh"
                for qid, (name, addr, ttl) in enumerate(
                        (("web.foo.com", "192.168.0.1", 30),
                         ("ttlhost.foo.com", "10.9.9.9", 77)), 6):
                    r, zoned = await name_ask(name, qid)
                    assert r.rcode == s.Rcode.NOERROR
                    assert r.answers[0].address == addr
                    assert r.answers[0].ttl == ttl
                    assert not zoned, f"zone served {name} after recovery"

                store.put_json("/com/foo/web",
                               {"type": "host",
                                "host": {"address": "192.168.0.7"}})
                await asyncio.sleep(0)
                r, zoned = await name_ask("web.foo.com", 9)
                assert r.answers[0].address == "192.168.0.7" and zoned
            finally:
                await server.stop()

        both(run)
