"""The raw resolve lane (``BinderServer._raw_lane``) on the port.

The cases of the reference's ``tests/test_raw_lane.py``, each under the
same name, run against ``binder_torch``.  The lane re-implements the
single-question A/IN resolve by direct wire assembly; these cases hold
it to the generic path of the same package:

- every query shape is driven through BOTH paths over the same store
  fixture and the response wires must be byte-identical (the request
  wires here are lowercase, so the lane's case-preserving question echo
  matches the generic encoder's output exactly);
- answer-cache entries created by one path must be served by the other
  (key-layout parity both directions);
- shapes the lane must decline (other qtypes, EDNS options, compressed
  qnames, service/database records, recursion handoffs, garbage) fall
  back and still produce the generic path's answer.

One case more, marked ``reference``, holds the port's lane wires for
every shape against the reference's generic path: the bytes the
reference's Python lane computes on the same fixture.  The port's
``make check`` runs the rest under ASan, without the reference.
"""
import random

import pytest

from binder_torch.dns import Message, Rcode, Type, make_query
from binder_torch.dns.query import QueryCtx
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.server import BinderServer, _fastpath_key_parts
from binder_torch.store import FakeStore, MirrorCache

DOMAIN = "foo.com"


def make_fixture(store_cls=FakeStore, cache_cls=MirrorCache):
    store = store_cls()
    cache = cache_cls(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "192.168.0.1"}})
    store.put_json("/com/foo/ttl1",
                   {"type": "host", "ttl": 120,
                    "host": {"address": "10.0.0.1"}})
    store.put_json("/com/foo/ttl2",
                   {"type": "host", "ttl": 120,
                    "host": {"address": "10.0.0.2", "ttl": 77}})
    store.put_json("/com/foo/badaddr",
                   {"type": "host", "host": {"address": "not-an-ip"}})
    store.put_json("/com/foo/short",
                   {"type": "host", "host": {"address": "10.1"}})
    store.put_json("/com/foo/noaddr", {"type": "host", "host": {}})
    store.put_json("/com/foo/badrec", {"type": "host"})
    store.put_json("/com/foo/db", {
        "type": "database",
        "database": {"primary": "tcp://pg.example.com:5432/x"},
    })
    store.put_json("/com/foo/svc", {
        "type": "service",
        "service": {"srvce": "_pg", "proto": "_tcp", "port": 5432},
    })
    for i in range(3):
        store.put_json(f"/com/foo/svc/lb{i}",
                       {"type": "load_balancer",
                        "load_balancer": {"address": f"10.0.1.{i + 1}"}})
    store.start_session()
    return store, cache


def new_server(cache, lane: bool, server_cls=BinderServer,
               metrics_cls=MetricsCollector, **kw):
    srv = server_cls(zk_cache=cache, dns_domain=DOMAIN,
                     datacenter_name="coal",
                     collector=metrics_cls(), query_log=False, **kw)
    # deterministic shuffle so both servers' service answers rotate
    # identically (the differential compares exact bytes)
    srv.resolver.rng = random.Random(42)
    if not lane:
        srv.engine.raw_lane = None
    return srv


def ask_raw(server, wire: bytes, protocol: str = "udp",
            client_transport=None):
    """Push one request wire through the engine; return the response."""
    out = []
    server.engine._handle_raw(wire, ("192.0.2.9", 1234), protocol,
                              out.append, client_transport=client_transport)
    assert len(out) == 1, f"expected one response, got {len(out)}"
    return out[0]


QUERY_SHAPES = [
    # (name, qtype, rd, edns_payload)
    ("web.foo.com", Type.A, False, 1232),        # host hit, EDNS
    ("web.foo.com", Type.A, True, 1232),         # RD set
    ("web.foo.com", Type.A, False, None),        # no EDNS
    ("web.foo.com", Type.A, False, 4097),        # payload clamped to 4096
    ("web.foo.com", Type.A, False, 100),         # payload below 512 floor
    ("ttl1.foo.com", Type.A, False, 1232),       # record-level TTL
    ("ttl2.foo.com", Type.A, False, 1232),       # sub-record TTL wins
    ("nope.foo.com", Type.A, False, 1232),       # miss -> REFUSED
    ("web.example.org", Type.A, False, 1232),    # outside suffix -> REFUSED
    ("foo.com", Type.A, False, 1232),            # bare domain -> REFUSED
    ("web.foo.com.foo.com", Type.A, False, 1232),      # doubled suffix
    ("web.foo.com.coal.foo.com", Type.A, False, 1232),  # dc-doubled suffix
    ("badaddr.foo.com", Type.A, False, 1232),    # invalid address
    ("short.foo.com", Type.A, False, 1232),      # non-canonical address
    ("noaddr.foo.com", Type.A, False, 1232),     # record without address
    ("badrec.foo.com", Type.A, False, 1232),     # invalid record shape
    ("db.foo.com", Type.A, False, 1232),         # database type (declined)
    ("svc.foo.com", Type.A, False, 1232),        # service A (declined)
    ("_pg._tcp.svc.foo.com", Type.SRV, False, 1232),   # SRV (declined)
    ("1.0.168.192.in-addr.arpa", Type.PTR, False, 1232),  # PTR hit
    ("1.0.168.192.in-addr.arpa", Type.PTR, False, None),  # PTR, no EDNS
    ("1.0.168.192.in-addr.arpa", Type.PTR, True, 1232),   # PTR, RD set
    ("2.0.0.10.in-addr.arpa", Type.PTR, False, 1232),  # PTR sub-TTL wins
    ("9.9.9.9.in-addr.arpa", Type.PTR, False, 1232),   # PTR miss REFUSED
    ("web.foo.com", Type.PTR, False, 1232),      # not a reverse name
    ("1.2.3.4.ip6.arpa", Type.PTR, False, 1232),  # v6 reverse REFUSED
    ("5.1.0.168.192.in-addr.arpa", Type.PTR, False, 1232),  # 5 octets
    ("192.in-addr.arpa", Type.PTR, False, 1232),  # partial reverse
    ("web.foo.com", Type.AAAA, False, 1232),     # unsupported qtype
]


class TestDifferential:
    def test_wire_identical_across_paths(self):
        """Every shape must produce byte-identical responses from the
        lane-enabled and generic-only servers (ids patched equal)."""
        for name, qtype, rd, payload in QUERY_SHAPES:
            _, cache_a = make_fixture()
            _, cache_b = make_fixture()
            # fresh servers per shape: no cross-shape cache pollution
            srv_lane = new_server(cache_a, lane=True)
            srv_gen = new_server(cache_b, lane=False)
            wire = make_query(name, qtype, qid=77, rd=rd,
                              edns_payload=payload).encode()
            got_lane = ask_raw(srv_lane, wire)
            got_gen = ask_raw(srv_gen, wire)
            assert got_lane == got_gen, (
                f"{name}/{Type.name(qtype)} rd={rd} edns={payload}: "
                f"lane={got_lane.hex()} generic={got_gen.hex()}")

    def test_store_down_servfail_identical(self):
        for lane in (True, False):
            # no session ever established: the mirror never becomes
            # ready, so resolution must SERVFAIL on both paths
            store = FakeStore()
            cache = MirrorCache(store, DOMAIN)
            srv = new_server(cache, lane=lane)
            wire = make_query("web.foo.com", Type.A, qid=5).encode()
            resp = Message.decode(ask_raw(srv, wire))
            assert resp.rcode == Rcode.SERVFAIL

    def test_cache_key_parity_lane_fills_generic_hits(self):
        """A lane-resolved entry must be a generic-path cache hit — for
        every EDNS payload edge (none, below floor, typical, above
        clamp), so a drifting floor/clamp copy splits the cache and
        fails here."""
        for payload in (None, 100, 511, 512, 1232, 4096, 4097):
            _, cache = make_fixture()
            srv = new_server(cache, lane=True)
            wire = make_query("web.foo.com", Type.A, qid=9,
                              edns_payload=payload).encode()
            first = ask_raw(srv, wire)
            # disable the lane; the generic path must hit the same entry
            srv.engine.raw_lane = None
            hits_before = srv.answer_cache.hits
            second = ask_raw(srv, wire)
            assert srv.answer_cache.hits == hits_before + 1, payload
            assert first == second, payload

    def test_cache_key_parity_generic_fills_lane_hits(self):
        _, cache = make_fixture()
        srv = new_server(cache, lane=True)
        srv.engine.raw_lane = None
        wire = make_query("web.foo.com", Type.A, qid=9,
                          edns_payload=1232).encode()
        first = ask_raw(srv, wire)
        srv.engine.raw_lane = srv._raw_lane
        hits_before = srv.answer_cache.hits
        second = ask_raw(srv, wire)
        assert srv.answer_cache.hits == hits_before + 1
        assert first == second

    def test_fastpath_key_parity(self):
        """The lane's inline C-cache key must equal _fastpath_key's."""
        _, cache = make_fixture()
        srv = new_server(cache, lane=True)
        for name, qtype, rd, payload in QUERY_SHAPES:
            if qtype != Type.A:
                continue
            wire = make_query(name, qtype, qid=3, rd=rd,
                              edns_payload=payload).encode()
            req = Message.decode(wire)
            q = QueryCtx(req, ("192.0.2.9", 1), "udp", lambda b: None,
                         raw=wire)
            expect = srv._fastpath_key(q)
            # the lane builds through the same shared builder; prove the
            # component path equals the Message path
            off = 12
            while wire[off]:
                off += 1 + wire[off]
            off += 1
            lane_key = _fastpath_key_parts(
                req.rd, req.edns is not None, req.max_udp_payload(),
                1, 1, wire[12:off].lower())
            assert lane_key == expect, name

    @pytest.mark.reference
    def test_lane_wires_equal_the_reference_generic_path(self):
        """Every shape through the port's lane and the reference's
        generic path, each on a fresh server over the same fixture:
        byte-identical responses."""
        from binder_tpu.metrics.collector import MetricsCollector as RefM
        from binder_tpu.server import BinderServer as RefServer
        from binder_tpu.store import FakeStore as RefStore
        from binder_tpu.store import MirrorCache as RefCache
        for name, qtype, rd, payload in QUERY_SHAPES:
            _, cache_a = make_fixture()
            _, cache_b = make_fixture(RefStore, RefCache)
            srv_lane = new_server(cache_a, lane=True)
            srv_ref = new_server(cache_b, lane=False, server_cls=RefServer,
                                 metrics_cls=RefM)
            wire = make_query(name, qtype, qid=77, rd=rd,
                              edns_payload=payload).encode()
            got, want = ask_raw(srv_lane, wire), ask_raw(srv_ref, wire)
            assert got == want, (
                f"{name}/{Type.name(qtype)} rd={rd} edns={payload}: "
                f"port lane={got.hex()} reference={want.hex()}")


class TestLaneBehavior:
    def test_case_preserving_question_echo(self):
        """dns0x20: the lane echoes the question with the request's
        original case (an improvement over the generic lowercase echo)."""
        _, cache = make_fixture()
        srv = new_server(cache, lane=True)
        q = make_query("WeB.FoO.cOm", Type.A, qid=2).encode()
        # make_query normalizes, so craft mixed case directly in the wire
        q = q.replace(b"web", b"WeB").replace(b"foo", b"FoO")
        resp = ask_raw(srv, q)
        assert b"WeB" in resp and b"FoO" in resp
        msg = Message.decode(resp)
        assert msg.rcode == Rcode.NOERROR
        assert str(msg.answers[0].address) == "192.168.0.1"

    def test_each_requester_gets_its_own_case_back(self):
        """A mixed-case fill must not leak its case into other clients'
        responses (cache stores the question lowercased; hits splice the
        requester's own bytes back in)."""
        _, cache = make_fixture()
        srv = new_server(cache, lane=True)
        mixed = make_query("web.foo.com", Type.A, qid=2).encode() \
            .replace(b"web", b"WeB").replace(b"foo", b"FoO")
        lower = make_query("web.foo.com", Type.A, qid=3).encode()
        first = ask_raw(srv, mixed)           # fills the cache
        assert b"WeB" in first
        second = ask_raw(srv, lower)          # cache hit
        assert b"WeB" not in second and b"web" in second
        third = ask_raw(srv, mixed)           # hit, case restored
        assert b"WeB" in third
        # all three carry the same answer
        for r in (first, second, third):
            m = Message.decode(r)
            assert str(m.answers[0].address) == "192.168.0.1"

    def test_lane_declines_to_generic_on_edns_options(self):
        """An OPT with options (a DNS cookie) must take the generic
        path and still be answered."""
        _, cache = make_fixture()
        srv = new_server(cache, lane=True)
        wire = make_query("web.foo.com", Type.A, qid=4,
                          edns_payload=1232).encode()
        # splice a COOKIE option into the OPT RDATA
        cookie = b"\x00\x0a\x00\x08" + b"\x01" * 8
        assert wire.endswith(b"\x00\x00")   # RDLEN 0
        wire = wire[:-2] + len(cookie).to_bytes(2, "big") + cookie
        resp = Message.decode(ask_raw(srv, wire))
        assert resp.rcode == Rcode.NOERROR
        assert str(resp.answers[0].address) == "192.168.0.1"

    def test_lane_declines_compressed_qname(self):
        _, cache = make_fixture()
        srv = new_server(cache, lane=True)
        # header + qname containing a (self-referential, invalid)
        # compression pointer: both paths must refuse gracefully —
        # generic drops it as malformed (FORMERR)
        wire = (b"\x00\x07\x00\x00\x00\x01\x00\x00\x00\x00\x00\x00"
                + b"\xc0\x0c\x00\x01\x00\x01")
        out = []
        srv.engine._handle_raw(wire, ("192.0.2.9", 1), "udp", out.append)
        if out:   # FORMERR response is acceptable; silence is too
            assert Message.decode(out[0]).rcode == Rcode.FORMERR

    def test_mutation_invalidates_lane_cache(self):
        """Generation bump: a store mutation must stop the lane serving
        the stale cached answer."""
        store, cache = make_fixture()
        srv = new_server(cache, lane=True)
        wire = make_query("web.foo.com", Type.A, qid=11).encode()
        first = Message.decode(ask_raw(srv, wire))
        assert str(first.answers[0].address) == "192.168.0.1"
        store.put_json("/com/foo/web",
                       {"type": "host", "host": {"address": "192.168.0.2"}})
        second = Message.decode(ask_raw(srv, wire))
        assert str(second.answers[0].address) == "192.168.0.2"

    def test_lane_serves_rotating_service_hits(self):
        """Once the generic path completes a rotatable service-A entry,
        lane hits must rotate through the variants like respond_raw."""
        _, cache = make_fixture()
        srv = new_server(cache, lane=True)
        wire = make_query("svc.foo.com", Type.A, qid=1).encode()
        seen = set()
        # 8 variants must be collected by the generic path first, then
        # hits rotate; drive enough queries to see rotation
        for _ in range(24):
            msg = Message.decode(ask_raw(srv, wire))
            assert msg.rcode == Rcode.NOERROR
            seen.add(tuple(str(a.address) for a in msg.answers))
        assert len(seen) > 1, "no rotation observed"

    def test_metrics_recorded_for_lane_queries(self):
        _, cache = make_fixture()
        srv = new_server(cache, lane=True)
        wire = make_query("web.foo.com", Type.A, qid=6).encode()
        ask_raw(srv, wire)
        ask_raw(srv, wire)   # second one is a lane cache hit
        text = srv.collector.expose()
        assert 'binder_requests_completed{type="A"} 2' in text
        assert "binder_answer_cache_hits 1" in text

    def test_balancer_protocol_lane(self):
        """Lane handles balancer-framed queries; TCP client transport
        keys separately from UDP (truncation semantics) in the PYTHON
        answer cache.  The native wire-serve entry would intercept the
        repeat before it reaches the lane (correct — fitting responses
        are transport-identical; tests/test_zone.py covers that lane),
        so it is detached here to exercise the Python keying."""
        _, cache = make_fixture()
        srv = new_server(cache, lane=True)
        srv.engine.fastpath = None
        wire = make_query("web.foo.com", Type.A, qid=8).encode()
        u = ask_raw(srv, wire, protocol="balancer", client_transport="udp")
        t = ask_raw(srv, wire, protocol="balancer", client_transport="tcp")
        assert Message.decode(u).answers and Message.decode(t).answers
        # distinct cache keys: one entry per transport semantics
        assert len(srv.answer_cache._entries) == 2
