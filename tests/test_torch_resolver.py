"""Resolver parity: ``binder_torch.resolver`` against ``binder_tpu.resolver``.

Both engines run over the same zone with the same seeded
``random.Random``, so round-robin order matches and every reply is
compared byte for byte.  The rcode policy the reference pins
(REFUSED, not NXDOMAIN, for unknown names; NODATA plus SOA for SRV of a
host; the three-level TTL precedence) is also asserted on the port's
decoded replies.  The port's precompiler must render the same rotation
variants as the reference's, and each variant must equal the port
engine's own render of that rotation, with and without EDNS.
"""
import logging
import random

import pytest

from binder_torch.dns import wire as port_wire
from binder_torch.dns.query import QueryCtx as PortQuery
from binder_torch.resolver import Resolver as PortResolver
from binder_torch.resolver.answer_cache import AnswerCache as PortCacheA
from binder_torch.resolver.precompile import Precompiler as PortPre
from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortMirror
from binder_tpu.dns import wire as ref_wire
from binder_tpu.dns.query import QueryCtx as RefQuery
from binder_tpu.resolver import Resolver as RefResolver
from binder_tpu.resolver.answer_cache import AnswerCache as RefCacheA
from binder_tpu.resolver.precompile import Precompiler as RefPre
from binder_tpu.store import FakeStore as RefStore
from binder_tpu.store import MirrorCache as RefMirror

DOMAIN = "foo.com"
SEED = 20251017
T = port_wire.Type
R = port_wire.Rcode


def zone():
    z = {
        "/com/foo/web": {"type": "host", "host": {"address": "192.168.0.1"}},
        "/com/foo/rttl": {"type": "host", "ttl": 90,
                          "host": {"address": "192.168.0.2"}},
        "/com/foo/sttl": {"type": "host", "ttl": 90,
                          "host": {"address": "192.168.0.3", "ttl": 7}},
        "/com/foo/svc": {"type": "service", "ttl": 120,
                         "service": {"srvce": "_http", "proto": "_tcp",
                                     "port": 8080}},
        "/com/foo/db": {"type": "database",
                        "database": {"primary": "tcp://10.0.9.9:5432"}},
        "/com/foo/bad": {"type": "host"},
    }
    for i in range(5):
        z[f"/com/foo/svc/lb{i}"] = {
            "type": "load_balancer",
            "load_balancer": {"address": f"10.0.1.{i + 1}",
                              "ttl": 10 + i}}
    z["/com/foo/svc/plain"] = {"type": "host",
                               "host": {"address": "10.0.1.99"}}
    z["/com/foo/pair"] = {"type": "service",
                          "service": {"srvce": "_pg", "proto": "_tcp",
                                      "port": 5432}}
    for i in range(2):
        z[f"/com/foo/pair/m{i}"] = {"type": "moray_host",
                                    "moray_host": {"address":
                                                   f"10.0.2.{i + 1}"}}
    return z


class Side:
    def __init__(self, store_cls, mirror_cls, resolver_cls, query_cls,
                 wire):
        self.store = store_cls()
        self.cache = mirror_cls(self.store, DOMAIN)
        for path, obj in zone().items():
            self.store.put_json(path, obj)
        self.store.start_session()
        self.resolver = resolver_cls(self.cache, dns_domain=DOMAIN,
                                     datacenter_name="coal",
                                     rng=random.Random(SEED))
        self.query_cls = query_cls
        self.wire = wire

    def ask(self, name, qtype, qid=99, rd=False, edns=1232):
        sent = []
        q = self.query_cls(self.wire.make_query(name, qtype, qid=qid, rd=rd,
                                                edns_payload=edns),
                           ("127.0.0.1", 5353), "udp", sent.append)
        assert self.resolver.handle(q) is None
        assert len(sent) == 1
        return sent[0]


def sides():
    return (Side(PortStore, PortMirror, PortResolver, PortQuery, port_wire),
            Side(RefStore, RefMirror, RefResolver, RefQuery, ref_wire))


QUERIES = [
    ("web.foo.com", T.A), ("WEB.Foo.Com", T.A), ("rttl.foo.com", T.A),
    ("sttl.foo.com", T.A), ("svc.foo.com", T.A),
    ("_http._tcp.svc.foo.com", T.SRV), ("_pg._tcp.pair.foo.com", T.SRV),
    ("pair.foo.com", T.A), ("_http._tcp.web.foo.com", T.SRV),
    ("_x._udp.svc.foo.com", T.SRV), ("db.foo.com", T.A),
    ("bad.foo.com", T.A), ("nope.foo.com", T.A), ("foo.com", T.A),
    ("other.example.com", T.A), ("web.foo.com", T.AAAA),
    ("web.foo.com", T.TXT), ("1.0.168.192.in-addr.arpa", T.PTR),
    ("3.1.0.10.in-addr.arpa", T.PTR), ("9.9.9.9.in-addr.arpa", T.PTR),
    ("0.168.192.in-addr.arpa", T.PTR), ("x.ip6.arpa", T.PTR),
    ("lb2.svc.foo.com", T.A),
]


@pytest.mark.parametrize("edns", [None, 1232])
def test_replies_byte_identical_with_seeded_rng(edns):
    port, ref = sides()
    for _ in range(3):      # repeats walk the shared rng sequence
        for qid, (name, qtype) in enumerate(QUERIES):
            got = port.ask(name, qtype, qid=qid, edns=edns)
            want = ref.ask(name, qtype, qid=qid, edns=edns)
            assert got == want, (name, qtype)


def test_rcode_policy_on_port():
    port, _ = sides()

    def ask(name, qtype):
        return port_wire.Message.decode(port.ask(name, qtype))

    r = ask("nope.foo.com", T.A)
    assert r.rcode == R.REFUSED and not r.answers       # not NXDOMAIN
    r = ask("_http._tcp.web.foo.com", T.SRV)            # SRV of a host
    assert r.rcode == R.NOERROR and not r.answers
    assert [a.rtype for a in r.authorities] == [T.SOA]
    assert [a.ttl for a in ask("web.foo.com", T.A).answers] == [30]
    assert [a.ttl for a in ask("rttl.foo.com", T.A).answers] == [90]
    assert [a.ttl for a in ask("sttl.foo.com", T.A).answers] == [7]
    assert ask("web.foo.com", T.AAAA).rcode == R.NOTIMP


class RotateBy:
    """An rng whose shuffle is rotation ``i``: the engine then renders
    exactly the precompiler's variant ``i``."""

    def __init__(self, i):
        self.i = i

    def shuffle(self, groups):
        groups[:] = groups[self.i:] + groups[:self.i]


def precompiler(side, pre_cls, cache_cls):
    return pre_cls(resolver=side.resolver, answer_cache=cache_cls(),
                   zk_cache=side.cache, summarize=repr,
                   log=logging.getLogger("binder.test"))


@pytest.mark.parametrize("name,qtype", [
    ("svc.foo.com", T.A), ("_http._tcp.svc.foo.com", T.SRV),
    ("_pg._tcp.pair.foo.com", T.SRV), ("web.foo.com", T.A),
])
def test_precompiled_variants_match_engine(name, qtype):
    port, ref = sides()
    got = precompiler(port, PortPre, PortCacheA).render_variants(
        name, qtype, port.resolver.plan(name, qtype))
    want = precompiler(ref, RefPre, RefCacheA).render_variants(
        name, qtype, ref.resolver.plan(name, qtype))
    assert got is not None
    assert [v[:2] for v in got] == [v[:2] for v in want]
    for i, (w0, w1, _, _) in enumerate(got):
        port.resolver.rng = RotateBy(i)
        assert port.ask(name, qtype, qid=0, edns=None) == w0
        assert port.ask(name, qtype, qid=0, edns=1232) == w1
        # the serve-time patch gives back the live id and RD bit
        live = port.ask(name, qtype, qid=0x4242, rd=True, edns=None)
        assert port_wire.patch_answer_wire(w0, qid=0x4242, rd=True) == live
