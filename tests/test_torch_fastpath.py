"""The native fast-path answer cache on the port's build.

The cases of the reference's ``tests/test_fastpath.py``, each under the
same name, run against ``binder_torch`` and the ``_binderfastio`` that
``binder_torch.fastio_build`` compiles from ``native/fastio/``:

- C-unit (``TestFastpathUnit``): ``fastpath_new/put/drain/stats``
  driven directly over a real UDP socket pair: key gating, ID and case
  patching, rotation, generation invalidation, expiry;
- integration (``TestFastpathIntegration``): a port ``BinderServer``
  with ``query_log=False`` (the gate condition): repeat queries served
  natively with the right answers, store mutations invalidating, and
  natively counted queries folded into the scrape.

The reference's suite skips in this tree (it has no build of its own),
so these are what holds the C lane case by case in tier-1; the port's
``make check`` runs them under ASan.  One case more, marked
``reference``, holds the natively served wires against the reference's
Python lane on the same store.
"""
import asyncio
import random
import socket
import time

import pytest

from binder_torch import _binderfastio as fastio
from binder_torch.dns import Message, Rcode, Type, make_query
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache
from tests.test_torch_zone import udp_ask_raw

LAT_BUCKETS = (0.001, 0.01, 0.1, 1.0)
SIZE_BUCKETS = (64.0, 512.0, 4096.0)

QNAME = b"\x03web\x05bench\x03com\x00"  # web.bench.com


def make_cache(size=100, expiry_ms=60000):
    return fastio.fastpath_new(size, expiry_ms, LAT_BUCKETS, SIZE_BUCKETS)


def udp_pair():
    srv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    srv.bind(("127.0.0.1", 0))
    srv.setblocking(False)
    cli = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    cli.bind(("127.0.0.1", 0))
    cli.settimeout(2)
    return srv, cli, srv.getsockname()[1]


def ckey(qname=QNAME, rd=0, edns=0, payload=512, qtype=1, qclass=1):
    return (bytes([(1 if rd else 0) | (2 if edns else 0)])
            + payload.to_bytes(2, "big") + qtype.to_bytes(2, "big")
            + qclass.to_bytes(2, "big") + qname.lower())


def response_wire(qname=QNAME, tag=b"TAG0"):
    """Header + question + opaque trailing bytes standing in for answers."""
    return (bytes.fromhex("000084000001000100000000") + qname.lower()
            + b"\x00\x01\x00\x01" + tag)


def query_pkt(qid=0x1111, qname=QNAME, rd=0, qtype=1, opcode=0, qd=1,
              tail=b""):
    flags = (opcode << 11) | (0x0100 if rd else 0)
    return (qid.to_bytes(2, "big") + flags.to_bytes(2, "big")
            + qd.to_bytes(2, "big") + b"\x00\x00\x00\x00"
            + len(tail and b"x").to_bytes(2, "big")  # arcount 1 iff tail
            + qname + qtype.to_bytes(2, "big") + b"\x00\x01" + tail)


def edns_tail(payload=1232, options=b""):
    return (b"\x00" + (41).to_bytes(2, "big") + payload.to_bytes(2, "big")
            + b"\x00\x00\x00\x00" + len(options).to_bytes(2, "big")
            + options)


class TestFastpathUnit:
    def drain(self, cache, srv, gen=1):
        return fastio.fastpath_drain(cache, srv.fileno(), gen)

    def test_miss_surfaces_packet(self):
        srv, cli, port = udp_pair()
        cache = make_cache()
        pkt = query_pkt()
        cli.sendto(pkt, ("127.0.0.1", port))
        misses, served = self.drain(cache, srv)
        assert served == 0
        assert len(misses) == 1
        data, addr = misses[0]
        assert data == pkt
        assert addr[0] == "127.0.0.1"

    def test_hit_patches_id_and_case(self):
        srv, cli, port = udp_pair()
        cache = make_cache()
        assert fastio.fastpath_put(cache, ckey(), 1, 1,
                                   [response_wire(tag=b"ANSW")])
        mixed = b"\x03WeB\x05BeNCH\x03CoM\x00"
        cli.sendto(query_pkt(qid=0xBEEF, qname=mixed), ("127.0.0.1", port))
        misses, served = self.drain(cache, srv)
        assert (len(misses), served) == (0, 1)
        data, _ = cli.recvfrom(4096)
        assert data[:2] == b"\xbe\xef"
        assert mixed in data          # 0x20 case echo
        assert data.endswith(b"ANSW")

    def test_rd_and_edns_key_separation(self):
        srv, cli, port = udp_pair()
        cache = make_cache()
        fastio.fastpath_put(cache, ckey(rd=0), 1, 1,
                            [response_wire(tag=b"NORD")])
        # same name with RD set → different key → miss
        cli.sendto(query_pkt(rd=1), ("127.0.0.1", port))
        misses, served = self.drain(cache, srv)
        assert (len(misses), served) == (1, 0)
        # EDNS variant needs its own entry keyed by payload ceiling
        fastio.fastpath_put(cache, ckey(edns=1, payload=1232), 1, 1,
                            [response_wire(tag=b"EDNS")])
        cli.sendto(query_pkt(tail=edns_tail(1232)), ("127.0.0.1", port))
        misses, served = self.drain(cache, srv)
        assert (len(misses), served) == (0, 1)
        data, _ = cli.recvfrom(4096)
        assert data.endswith(b"EDNS")
        # EDNS option bytes (cookies) must NOT mint new keys
        cli.sendto(query_pkt(tail=edns_tail(1232, options=b"\x00\x0a\x00"
                                            b"\x02ab")),
                   ("127.0.0.1", port))
        misses, served = self.drain(cache, srv)
        assert (len(misses), served) == (0, 1)
        cli.recvfrom(4096)

    def test_payload_ceiling_below_512_is_classic(self):
        # wire.py max_udp_payload: EDNS sizes under 512 behave as 512
        srv, cli, port = udp_pair()
        cache = make_cache()
        fastio.fastpath_put(cache, ckey(edns=1, payload=512), 1, 1,
                            [response_wire(tag=b"X512")])
        cli.sendto(query_pkt(tail=edns_tail(100)), ("127.0.0.1", port))
        misses, served = self.drain(cache, srv)
        assert (len(misses), served) == (0, 1)

    def test_generation_invalidates(self):
        srv, cli, port = udp_pair()
        cache = make_cache()
        fastio.fastpath_put(cache, ckey(), 1, 7, [response_wire()])
        cli.sendto(query_pkt(), ("127.0.0.1", port))
        misses, served = self.drain(cache, srv, gen=8)
        assert (len(misses), served) == (1, 0)
        # entry was dropped, not just skipped
        assert fastio.fastpath_stats(cache)["entries"] == 0

    def test_expiry(self):
        srv, cli, port = udp_pair()
        cache = make_cache(expiry_ms=1)
        fastio.fastpath_put(cache, ckey(), 1, 1, [response_wire()])
        time.sleep(0.02)
        cli.sendto(query_pkt(), ("127.0.0.1", port))
        misses, served = self.drain(cache, srv)
        assert (len(misses), served) == (1, 0)

    def test_rotation_cycles_variants(self):
        srv, cli, port = udp_pair()
        cache = make_cache()
        fastio.fastpath_put(cache, ckey(), 1, 1,
                            [response_wire(tag=b"VAR0"),
                             response_wire(tag=b"VAR1"),
                             response_wire(tag=b"VAR2")])
        seen = []
        for i in range(6):
            cli.sendto(query_pkt(qid=0x2000 + i), ("127.0.0.1", port))
            misses, served = self.drain(cache, srv)
            assert served == 1
            data, _ = cli.recvfrom(4096)
            seen.append(data[-4:])
        assert seen == [b"VAR0", b"VAR1", b"VAR2"] * 2

    def test_ineligible_shapes_fall_through(self):
        srv, cli, port = udp_pair()
        cache = make_cache()
        fastio.fastpath_put(cache, ckey(), 1, 1, [response_wire()])
        bad = [
            query_pkt(opcode=1),                      # not QUERY
            query_pkt(qd=2),                          # multi-question
            query_pkt(qname=b"\xc0\x0c"),             # compressed qname
            query_pkt(qname=b"\x04w.b!\x03com\x00"),  # charset
            query_pkt() + b"junk",                    # trailing bytes
            b"\x12\x34\x00",                          # truncated header
        ]
        for pkt in bad:
            cli.sendto(pkt, ("127.0.0.1", port))
            misses, served = self.drain(cache, srv)
            assert served == 0, pkt
            assert len(misses) == 1

    def test_put_rejects_oversize_and_replaces(self):
        cache = make_cache()
        assert not fastio.fastpath_put(cache, ckey(), 1, 1,
                                       [b"\x00" * 5000])
        assert fastio.fastpath_put(cache, ckey(), 1, 1,
                                   [response_wire(tag=b"OLD0")])
        assert fastio.fastpath_put(cache, ckey(), 1, 1,
                                   [response_wire(tag=b"NEW0")])
        assert fastio.fastpath_stats(cache)["entries"] == 1

    def test_put_with_remaining_ttl_overrides_cache_expiry(self):
        srv, cli, port = udp_pair()
        cache = make_cache(expiry_ms=60000)
        # an entry completed late in its Python-cache life carries only
        # its remaining lifetime — not a fresh full window
        fastio.fastpath_put(cache, ckey(), 1, 1, [response_wire()], 1)
        time.sleep(0.02)
        cli.sendto(query_pkt(), ("127.0.0.1", port))
        misses, served = self.drain(cache, srv)
        assert (len(misses), served) == (1, 0)

    def test_qtype_stats_overflow_uses_catchall(self):
        srv, cli, port = udp_pair()
        cache = make_cache()
        # 20 distinct qtypes: the first 15 get their own stats slot, the
        # rest must fold into the 0xFFFF catch-all, never a real qtype
        for qt in range(1, 21):
            fastio.fastpath_put(cache, ckey(qtype=qt), qt, 1,
                                [response_wire()])
        for i, qt in enumerate(range(1, 21)):
            cli.sendto(query_pkt(qid=0x3000 + i, qtype=qt),
                       ("127.0.0.1", port))
            misses, served = self.drain(cache, srv)
            assert served == 1, qt
            cli.recvfrom(4096)
        per = fastio.fastpath_stats(cache)["per_qtype"]
        assert all(per[qt]["count"] == 1 for qt in range(1, 16))
        assert per[0xFFFF]["count"] == 5
        assert not any(qt in per for qt in range(16, 21))

    def test_stats_shape(self):
        srv, cli, port = udp_pair()
        cache = make_cache()
        fastio.fastpath_put(cache, ckey(), 1, 1, [response_wire()])
        cli.sendto(query_pkt(), ("127.0.0.1", port))
        self.drain(cache, srv)
        cli.recvfrom(4096)
        s = fastio.fastpath_stats(cache)
        assert s["hits"] == 1 and s["lookups"] == 1
        q = s["per_qtype"][1]
        assert q["count"] == 1
        assert len(q["lat_cells"]) == len(LAT_BUCKETS) + 1
        assert len(q["size_cells"]) == len(SIZE_BUCKETS) + 1
        assert sum(q["lat_cells"]) == 1 and sum(q["size_cells"]) == 1
        assert q["size_sum"] == len(response_wire())


DOMAIN = "foo.com"


def fixture_store(store_cls=FakeStore, cache_cls=MirrorCache):
    store = store_cls()
    cache = cache_cls(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "192.168.0.1"}})
    store.put_json("/com/foo/svc", {
        "type": "service",
        "service": {"srvce": "_pg", "proto": "_tcp", "port": 5432},
    })
    for i in range(4):
        store.put_json(f"/com/foo/svc/lb{i}",
                       {"type": "load_balancer",
                        "load_balancer": {"address": f"10.0.1.{i + 1}"}})
    store.start_session()
    return store, cache


async def start_server(cache, **kw):
    kw.setdefault("query_log", False)
    # this module tests the answer-cache fill/hit flow, which the zone
    # table would short-circuit (a precompiled host answer means the
    # first query never surfaces to Python); test_torch_zone.py covers
    # the zone path itself
    kw.setdefault("zone_precompile", False)
    server = BinderServer(zk_cache=cache, dns_domain=DOMAIN,
                          datacenter_name="coal", host="127.0.0.1", port=0,
                          collector=MetricsCollector(), **kw)
    await server.start()
    return server


async def udp_ask(port, name, qtype, qid=4242):
    data = await udp_ask_raw(
        port, make_query(name, qtype, qid=qid).encode())
    return Message.decode(data)


def fp_hits(server):
    return fastio.fastpath_stats(server._fastpath)["hits"]


class TestFastpathIntegration:
    def test_second_query_served_natively(self):
        async def run():
            _, cache = fixture_store()
            server = await start_server(cache)
            try:
                first = await udp_ask(server.udp_port, "web.foo.com",
                                      Type.A)
                assert fp_hits(server) == 0     # miss populated the cache
                # promote-on-first-hit: the first repeat serves from the
                # Python answer cache AND promotes; the next is native
                await udp_ask(server.udp_port, "web.foo.com", Type.A,
                              qid=776)
                assert fp_hits(server) == 0
                second = await udp_ask(server.udp_port, "web.foo.com",
                                       Type.A, qid=777)
                assert fp_hits(server) == 1
                assert second.id == 777
                assert second.rcode == Rcode.NOERROR
                assert [a.address for a in second.answers] == \
                    [a.address for a in first.answers]
                assert second.answers[0].address == "192.168.0.1"
            finally:
                await server.stop()
        asyncio.run(run())

    def test_rotation_after_variant_collection(self):
        async def run():
            _, cache = fixture_store()
            server = await start_server(cache)
            try:
                # rotatable entry completes after variants_cap resolves
                cap = server.answer_cache.variants_cap
                for i in range(cap):
                    await udp_ask(server.udp_port, "svc.foo.com", Type.A,
                                  qid=i + 1)
                assert fp_hits(server) == 0
                # first hit promotes (promote-on-first-hit)
                await udp_ask(server.udp_port, "svc.foo.com", Type.A,
                              qid=99)
                orderings = []
                for i in range(cap):
                    m = await udp_ask(server.udp_port, "svc.foo.com",
                                      Type.A, qid=100 + i)
                    assert len(m.answers) == 4
                    orderings.append(tuple(a.address for a in m.answers))
                assert fp_hits(server) == cap
                # round-robin rotation: the full variant cycle presents
                # different orderings (8 independent shuffles of 4 lbs are
                # all identical with p = (1/24)^7)
                assert len(set(orderings)) > 1
            finally:
                await server.stop()
        asyncio.run(run())

    def test_store_mutation_invalidates(self):
        async def run():
            store, cache = fixture_store()
            server = await start_server(cache)
            try:
                await udp_ask(server.udp_port, "web.foo.com", Type.A)
                await udp_ask(server.udp_port, "web.foo.com", Type.A)
                await udp_ask(server.udp_port, "web.foo.com", Type.A)
                assert fp_hits(server) == 1
                store.put_json(
                    "/com/foo/web",
                    {"type": "host", "host": {"address": "10.9.9.9"}})
                await asyncio.sleep(0.05)   # watch delivery
                m = await udp_ask(server.udp_port, "web.foo.com", Type.A)
                assert m.answers[0].address == "10.9.9.9"
            finally:
                await server.stop()
        asyncio.run(run())

    def test_query_log_gates_fast_path(self):
        async def run():
            _, cache = fixture_store()
            server = await start_server(cache, query_log=True)
            try:
                for i in range(3):
                    await udp_ask(server.udp_port, "web.foo.com", Type.A,
                                  qid=i + 1)
                assert fp_hits(server) == 0
            finally:
                await server.stop()
        asyncio.run(run())

    def test_native_counts_fold_into_scrape(self):
        async def run():
            _, cache = fixture_store()
            server = await start_server(cache)
            try:
                for i in range(5):
                    await udp_ask(server.udp_port, "web.foo.com", Type.A,
                                  qid=i + 1)
                # promote-on-first-hit: resolve, Python hit (promotes),
                # then 3 native hits
                assert fp_hits(server) == 3
                text = server.collector.expose()
                assert ('binder_requests_completed{type="A"} 5' in text)
                assert ('binder_request_latency_seconds_count{type="A"} 5'
                        in text)
                assert ('binder_response_size_bytes_count{type="A"} 5'
                        in text)
                assert 'binder_answer_cache_hits 4' in text
                # folding is delta-based: a second scrape must not
                # double-count
                text = server.collector.expose()
                assert ('binder_requests_completed{type="A"} 5' in text)
            finally:
                await server.stop()
        asyncio.run(run())

    def test_mixed_case_query_case_echo(self):
        async def run():
            _, cache = fixture_store()
            server = await start_server(cache)
            try:
                lower = b"\x03web\x03foo\x03com\x00"
                prime = (b"\x00\x01\x00\x00\x00\x01\x00\x00\x00\x00"
                         b"\x00\x00" + lower + b"\x00\x01\x00\x01")
                await udp_ask_raw(server.udp_port, prime)
                # second ask promotes (promote-on-first-hit)
                await udp_ask_raw(server.udp_port, b"\x00\x02" + prime[2:])
                mixed = b"\x03wEb\x03FoO\x03cOm\x00"
                pkt = (b"\x77\x77\x00\x00\x00\x01\x00\x00\x00\x00\x00\x00"
                       + mixed + b"\x00\x01\x00\x01")
                data = await udp_ask_raw(server.udp_port, pkt)
                assert fp_hits(server) == 1
                assert mixed in data
                m = Message.decode(data)
                assert m.answers[0].address == "192.168.0.1"
            finally:
                await server.stop()
        asyncio.run(run())

    def test_read_your_writes_under_churn(self):
        """Mutate-then-query loop through the full UDP stack with the
        fast path active: the fake store applies mutations to the
        mirror synchronously, so every query after a mutation MUST see
        the new value — any stale answer means a cache (Python or C)
        survived a generation bump."""
        async def run():
            rng = random.Random(1234)
            store, cache = fixture_store()
            server = await start_server(cache)
            try:
                addr = None
                for i in range(60):
                    addr = f"10.7.{rng.randrange(256)}.{rng.randrange(1, 255)}"
                    store.put_json(
                        "/com/foo/web",
                        {"type": "host", "host": {"address": addr}})
                    # a few queries per mutation: the first re-resolves,
                    # the rest exercise both cache layers
                    for j in range(3):
                        m = await udp_ask(server.udp_port, "web.foo.com",
                                          Type.A, qid=(i * 4 + j) % 65536)
                        assert m.answers[0].address == addr, \
                            (i, j, m.answers[0].address, addr)
                assert fp_hits(server) > 0   # the C path did serve
            finally:
                await server.stop()
        asyncio.run(run())

    def test_refused_responses_cached_and_served(self):
        async def run():
            _, cache = fixture_store()
            server = await start_server(cache)
            try:
                for i in range(3):
                    m = await udp_ask(server.udp_port, "nope.foo.com",
                                      Type.A, qid=i + 1)
                    assert m.rcode == Rcode.REFUSED
                # promote-on-first-hit: the third repeat is the native one
                assert fp_hits(server) == 1
            finally:
                await server.stop()
        asyncio.run(run())

    @pytest.mark.reference
    def test_native_answers_equal_the_reference_python_lane(self,
                                                           monkeypatch):
        """The wires the port's C lane serves for a name, asked a third
        time, equal what the reference's Python lane answers on the same
        store: a host, a REFUSED miss and a PTR byte for byte, the
        rotating service A by header and record set."""
        from binder_tpu import server as ref_server
        from binder_tpu.dns import server as ref_dns_server
        from binder_tpu.metrics.collector import MetricsCollector as RefM
        from binder_tpu.store import FakeStore as RefStore
        from binder_tpu.store import MirrorCache as RefCache
        from tests.test_torch_fastio import pin_python_lane, rr_sets
        pin_python_lane(monkeypatch, (ref_server, ref_dns_server))
        asks = [("web.foo.com", Type.A), ("nope.foo.com", Type.A),
                ("1.0.168.192.in-addr.arpa", Type.PTR),
                ("svc.foo.com", Type.A)]

        async def port_side():
            _, cache = fixture_store()
            server = await start_server(cache)
            try:
                out = []
                for k, (name, qtype) in enumerate(asks):
                    for qid in (1, 2, 100 + k):
                        data = await udp_ask_raw(
                            server.udp_port,
                            make_query(name, qtype, qid=qid).encode())
                    out.append(data)
                # the host, the miss and the PTR natively; the service
                # A completes only after ``variants_cap`` resolves
                assert fp_hits(server) == 3
                return out
            finally:
                await server.stop()

        async def ref_side():
            _, cache = fixture_store(RefStore, RefCache)
            server = ref_server.BinderServer(
                zk_cache=cache, dns_domain=DOMAIN, datacenter_name="coal",
                host="127.0.0.1", port=0, collector=RefM(),
                query_log=False, zone_precompile=False)
            await server.start()
            try:
                return [await udp_ask_raw(
                    server.udp_port,
                    make_query(name, qtype, qid=100 + k).encode())
                    for k, (name, qtype) in enumerate(asks)]
            finally:
                await server.stop()

        got, want = asyncio.run(port_side()), asyncio.run(ref_side())
        assert got[:3] == want[:3]
        assert rr_sets(got[3]) == rr_sets(want[3])
