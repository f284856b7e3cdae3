"""Recursion parity: ``binder_torch.recursion`` against
``binder_tpu.recursion``.

- BER: every encoder gives the same bytes over a seeded sweep, and
  each package decodes the other's; LDAP filters and URLs parse,
  encode and evaluate the same.
- LDAP: each package's ``LdapClient`` against each package's
  ``LdapTestServer`` (bind, bad credentials, search before bind, the
  three scopes, filters) gets the same results, and the client->server
  and server->client bytes are the same for all four pairings.
- UFDS discovery: ``UfdsResolverSource`` and ``Recursion`` build the
  same resolver map from the same directory entries, reached through
  the mirror's ``ufds`` service record.
- Forwarding: a local server of each package forwards to one scripted
  upstream with the global ``random`` seeded the same, so the upstream
  receives the same query bytes (ID and dns0x20 case mask come from
  ``random``) and the client gets byte-identical replies, on the
  spliced path (query log off) and the rebuilt path (query log on).
  Nothing is masked: the client's query ID is the same on both sides.
- NXNSAttack budget and breakers: a federated server of each package
  with ``upstreamBudget: 1`` clamps the PTR fan-out the same number of
  times, and a silent upstream opens its breaker after the same
  failures; breaker state is compared without its clock readings
  (remaining open time, jittered backoff, latency percentile).
- Verified ``ldaps`` with a test CA runs where ``cryptography`` is
  importable and skips with the reason otherwise.
"""
import asyncio
import random
import ssl

import pytest

from binder_torch import server as port_server
from binder_torch.dns import wire as port_wire
from binder_torch.federation import Federation as PortFederation
from binder_torch.metrics.collector import MetricsCollector as PortMetrics
from binder_torch.recursion import DnsClient as PortClient
from binder_torch.recursion import Recursion as PortRecursion
from binder_torch.recursion import StaticResolverSource as PortStatic
from binder_torch.recursion import ber as port_ber
from binder_torch.recursion import ldap_server as port_ldap
from binder_torch.recursion import ufds as port_ufds
from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortCache
from binder_tpu import server as ref_server
from binder_tpu.dns import wire as ref_wire
from binder_tpu.federation import Federation as RefFederation
from binder_tpu.metrics.collector import MetricsCollector as RefMetrics
from binder_tpu.recursion import DnsClient as RefClient
from binder_tpu.recursion import Recursion as RefRecursion
from binder_tpu.recursion import StaticResolverSource as RefStatic
from binder_tpu.recursion import ber as ref_ber
from binder_tpu.recursion import ldap_server as ref_ldap
from binder_tpu.recursion import ufds as ref_ufds
from binder_tpu.store import FakeStore as RefStore
from binder_tpu.store import MirrorCache as RefCache

from tests.test_torch_zk import Recorder
from tests.test_ufds import RESOLVER_ENTRIES, tls_pki  # noqa: F401

DOMAIN = "foo.com"


class Side:
    def __init__(self, **kw):
        self.__dict__.update(kw)


SIDES = {
    "port": Side(wire=port_wire, server=port_server, metrics=PortMetrics,
                 recursion=PortRecursion, static=PortStatic,
                 client=PortClient, federation=PortFederation,
                 ber=port_ber, ufds=port_ufds, ldap=port_ldap,
                 store=PortStore, cache=PortCache),
    "ref": Side(wire=ref_wire, server=ref_server, metrics=RefMetrics,
                recursion=RefRecursion, static=RefStatic,
                client=RefClient, federation=RefFederation,
                ber=ref_ber, ufds=ref_ufds, ldap=ref_ldap,
                store=RefStore, cache=RefCache),
}


# -- BER and filters ---------------------------------------------------


def random_value(rng, depth=0):
    kind = rng.choice(["int", "str", "bool", "seq"] if depth < 3
                      else ["int", "str", "bool"])
    if kind == "int":
        return ("int", rng.choice([0, -1, 127, 128, -128, -129, 255, 256,
                                   rng.randint(-2**40, 2**40)]))
    if kind == "str":
        return ("str", rng.randbytes(rng.choice([0, 5, 127, 128, 300,
                                                 70000])))
    if kind == "bool":
        return ("bool", rng.random() < 0.5)
    return ("seq", [random_value(rng, depth + 1)
                    for _ in range(rng.randint(0, 4))])


def encode(ber, value):
    kind, v = value
    if kind == "int":
        return ber.encode_int(v)
    if kind == "str":
        return ber.encode_str(v)
    if kind == "bool":
        return ber.encode_bool(v)
    return ber.encode_seq([encode(ber, x) for x in v])


def test_ber_byte_identical():
    rng = random.Random(636)
    for _ in range(300):
        value = random_value(rng)
        got = encode(port_ber, value)
        assert got == encode(ref_ber, value), value
        for dec in (port_ber, ref_ber):
            tag, content, end = dec.decode_tlv(got)
            assert end == len(got) == dec.frame_length(got)
            assert (tag, content) == ref_ber.decode_tlv(got)[:2]
            if value[0] == "int":
                assert dec.decode_int(content) == value[1]
            if value[0] == "seq":
                assert dec.decode_all(content) == \
                    ref_ber.decode_all(content)
    for n in (0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 2**24 + 3):
        assert port_ber.encode_len(n) == ref_ber.encode_len(n)
    for tag in (0x60, 0x61, 0x63, 0x64, 0x65, 0x78, 0x87):
        assert port_ber.tlv(tag, b"xyz") == ref_ber.tlv(tag, b"xyz")
    assert port_ber.frame_length(b"\x30\x82\x01") == \
        ref_ber.frame_length(b"\x30\x82\x01")
    with pytest.raises(port_ber.BerError):
        port_ber.decode_tlv(b"\x04\x05abc")


FILTERS = ["(objectclass=resolver)", "objectclass=*",
           "(&(objectclass=resolver)(datacenter=east-1))",
           "(|(ip=10.99.99.38)(!(datacenter=east-1)))",
           "(&(objectclass=*)(|(region=home)(region=other)))",
           "(cn=a*b)", "(=x)", "(a=b", "(a=b))", "(&(a=b)", "noequals"]


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the error kind is compared
        return ("error", type(e).__name__, str(e))


def test_filters_and_urls_identical():
    entries = [{k.lower(): v for k, v in attrs.items()}
               for attrs in RESOLVER_ENTRIES.values()]
    for text in FILTERS:
        got = outcome(port_ufds.parse_filter, text)
        assert got == outcome(ref_ufds.parse_filter, text), text
        if got[0] == "ok":
            assert port_ufds.encode_filter(got[1]) == \
                ref_ufds.encode_filter(got[1])
            for attrs in entries:
                assert port_ufds.eval_filter(got[1], attrs) == \
                    ref_ufds.eval_filter(got[1], attrs)
    for url in ("ldaps://ufds.foo.com", "ldap://127.0.0.1:389",
                "ufds.foo.com:636", "ldaps://[fd00::5]:636",
                "ldaps://[fd00::5", "ldap://h:notaport"):
        assert outcome(port_ufds.parse_ldap_url, url) == \
            outcome(ref_ufds.parse_ldap_url, url), url
    assert port_ufds.normalize_dn("UUID=r1, O=SmartDC") == \
        ref_ufds.normalize_dn("UUID=r1, O=SmartDC")


# -- LDAP client and server ---------------------------------------------


async def ldap_script(client_side, server_side):
    ufds = SIDES[client_side].ufds
    out = []
    async with SIDES[server_side].ldap.LdapTestServer(
            entries=RESOLVER_ENTRIES) as srv:
        proxy = Recorder(srv.port)
        await proxy.start()
        c = ufds.LdapClient("127.0.0.1", proxy.port)
        await c.connect()
        with pytest.raises(ufds.LdapError) as err:
            await c.search("o=smartdc", "(objectclass=*)")
        out.append(err.value.result_code)
        with pytest.raises(ufds.LdapError) as err:
            await c.bind("cn=root", "wrong")
        out.append(err.value.result_code)
        await c.bind("cn=root", "secret")
        for base, filt, scope in (
                ("region=home, o=smartdc", "(objectclass=resolver)", 2),
                ("o=smartdc", "(objectclass=*)", 2),
                ("uuid=r1, datacenter=east-1, region=home, o=smartdc",
                 "(objectclass=*)", 0),
                ("o=smartdc", "(objectclass=*)", 1),
                ("region=other, o=smartdc", "(objectclass=resolver)", 2),
                ("o=smartdc", "(&(objectclass=resolver)"
                              "(!(datacenter=east-1)))", 2)):
            out.append(await c.search(base, filt, scope=scope,
                                      attributes=("datacenter", "ip")))
        await c.close()
        await asyncio.sleep(0.05)
        await proxy.stop()
        (streams,) = proxy.conns
    return out, tuple(bytes(s) for s in streams)


def test_ldap_client_against_both_servers():
    async def run():
        return {(c, s): await ldap_script(c, s)
                for c in SIDES for s in SIDES}

    got = asyncio.run(run())
    want = got[("ref", "ref")]
    for pair, result in got.items():
        assert result == want, pair
    unbound, bad, sub, everything, base, one, other, negated = want[0]
    assert bad == 49                              # invalidCredentials
    assert unbound != 0
    assert len(sub) == 3 and len(everything) == 5 and len(base) == 1
    assert {a["datacenter"][0] for _, a in other} == {"far-1"}
    assert {a["datacenter"][0] for _, a in negated} == {"west-1", "far-1"}


def ufds_fixture(side, addr="127.0.0.1"):
    s = SIDES[side]
    store = s.store()
    cache = s.cache(store, DOMAIN)
    store.put_json("/com/foo/ufds", {"type": "service",
                                     "service": {"port": 636}})
    store.put_json("/com/foo/ufds/inst0",
                   {"type": "load_balancer",
                    "load_balancer": {"address": addr}})
    store.start_session()
    return cache


def test_ufds_discovery_builds_the_same_map():
    async def go(side):
        s = SIDES[side]
        async with s.ldap.LdapTestServer(entries=RESOLVER_ENTRIES) as srv:
            cfg = {"url": f"ldap://ufds.foo.com:{srv.port}",
                   "bindDN": "cn=root", "bindPassword": "secret"}
            src = s.ufds.UfdsResolverSource(dict(cfg))
            await src.init(ufds_fixture(side))
            listed = await src.list_resolvers("home")
            await src.close()
            rec = s.recursion(zk_cache=ufds_fixture(side),
                              dns_domain=DOMAIN, datacenter_name="east-1",
                              region_name="home", ufds=dict(cfg),
                              nic_provider=lambda: [])
            await rec.wait_ready()
            dcs = dict(rec.dcs)
            await rec.close()
        return listed, dcs

    got = {side: asyncio.run(go(side)) for side in SIDES}
    assert got["port"] == got["ref"]
    assert got["port"][1] == {"east-1": ["10.99.99.38", "10.99.99.39"],
                              "west-1": ["10.77.77.10"]}


# -- forwarding through a scripted upstream ------------------------------


class Upstream(asyncio.DatagramProtocol):
    """Answers A for ``web.<dc>``, PTR for ``ptr_ip``, with the
    question echoed verbatim (the client checks its dns0x20 mask);
    keeps every query it got.  ``silent`` answers nothing."""

    def __init__(self, dc, addr, ptr_ip=None, silent=False):
        self.dc, self.addr, self.ptr_ip = dc, addr, ptr_ip
        self.silent = silent
        self.got = []

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, peer):
        self.got.append(data)
        if self.silent:
            return
        w = ref_wire
        q = w.Message.decode(data)
        name = q.questions[0].name
        answers, rcode = [], w.Rcode.NOERROR
        if q.questions[0].qtype == w.Type.A and \
                name == f"web.{self.dc}.{DOMAIN}":
            answers = [w.ARecord(name=name, ttl=44, address=self.addr)]
        elif q.questions[0].qtype == w.Type.PTR and self.ptr_ip and \
                name == w.reverse_name_for_ip(self.ptr_ip):
            answers = [w.PTRRecord(name=name, ttl=44,
                                   target=f"web.{self.dc}.{DOMAIN}")]
        else:
            rcode = w.Rcode.REFUSED
        resp = bytearray(w.Message(id=q.id, qr=True, rd=q.rd, rcode=rcode,
                                   questions=list(q.questions),
                                   answers=answers).encode())
        off = 12
        while data[off] != 0:
            off += 1 + data[off]
        resp[12:off + 5] = data[12:off + 5]
        self.transport.sendto(bytes(resp), peer)


async def start_upstream(*args, **kw):
    proto = Upstream(*args, **kw)
    transport, _ = await asyncio.get_running_loop().create_datagram_endpoint(
        lambda: proto, local_addr=("127.0.0.1", 0))
    return proto, transport.get_extra_info("sockname")[1], transport


async def udp_ask(port, wire_bytes):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class P(asyncio.DatagramProtocol):
        def connection_made(self, t):
            t.sendto(wire_bytes)

        def datagram_received(self, d, a):
            if not fut.done():
                fut.set_result(d)

    t, _ = await loop.create_datagram_endpoint(
        P, remote_addr=("127.0.0.1", port))
    try:
        return await asyncio.wait_for(fut, 5)
    finally:
        t.close()


FORWARDED = [("web.east.foo.com", "A", 1232), ("web.east.foo.com", "A", None),
             ("WeB.EaSt.foo.com", "A", 1232), ("gone.west.foo.com", "A", 1232),
             ("1.0.77.10.in-addr.arpa", "PTR", 1232),
             ("web.nowhere.foo.com", "A", 1232)]


async def forward_run(side, query_log):
    s = SIDES[side]
    east, east_port, t1 = await start_upstream("east", "10.77.0.1",
                                               ptr_ip="10.77.0.1")
    west, west_port, t2 = await start_upstream("west", "10.88.0.1")
    store = s.store()
    cache = s.cache(store, DOMAIN)
    store.start_session()
    rec = s.recursion(zk_cache=cache, dns_domain=DOMAIN,
                      datacenter_name="local",
                      source=s.static({"east": [f"127.0.0.1:{east_port}"],
                                       "west": [f"127.0.0.1:{west_port}"]}),
                      nic_provider=lambda: [])
    await rec.wait_ready()
    srv = s.server.BinderServer(zk_cache=cache, dns_domain=DOMAIN,
                                datacenter_name="local", recursion=rec,
                                host="127.0.0.1", port=0,
                                collector=s.metrics(), query_log=query_log)
    await srv.start()
    replies = []
    try:
        for k, (name, qtype, payload) in enumerate(FORWARDED):
            random.seed(5353 + k)
            q = s.wire.make_query(name, getattr(s.wire.Type, qtype),
                                  qid=4000 + k, rd=True,
                                  edns_payload=payload).encode()
            replies.append(await udp_ask(srv.udp_port, q))
    finally:
        await srv.stop()
        await rec.close()
        t1.close()
        t2.close()
    return replies, east.got, west.got


@pytest.mark.parametrize("query_log", [False, True],
                         ids=["spliced", "rebuilt"])
def test_forwarded_replies_byte_identical(query_log):
    got = {side: asyncio.run(forward_run(side, query_log)) for side in SIDES}
    assert got["port"] == got["ref"]
    replies, east_got, west_got = got["port"]
    msgs = [ref_wire.Message.decode(r) for r in replies]
    assert [m.rcode for m in msgs] == [0, 0, 0, 5, 0, 5]
    assert msgs[0].answers[0].address == "10.77.0.1"
    assert msgs[0].answers[0].ttl == 44 and msgs[0].ra
    assert msgs[4].answers[0].target == "web.east.foo.com"
    # the mixed-case client question is echoed back as asked
    assert replies[2][12:12 + 18] == \
        ref_wire.make_query("WeB.EaSt.foo.com", 1, qid=0).encode()[12:30]
    assert len(east_got) >= 4 and len(west_got) >= 2


async def budget_run(side):
    s = SIDES[side]
    east, east_port, t1 = await start_upstream("east", "10.77.0.1")
    west, west_port, t2 = await start_upstream("west", "10.88.0.1",
                                               ptr_ip="10.88.0.1")
    dark, dark_port, t3 = await start_upstream("dark", "", silent=True)
    store = s.store()
    cache = s.cache(store, DOMAIN)
    for dc, port in (("east", east_port), ("west", west_port),
                     ("dark", dark_port)):
        store.put_json(f"/dcs/{dc}", {"zones": [dc],
                                      "peers": [f"127.0.0.1:{port}"]})
    store.start_session()
    collector = s.metrics()
    fed = s.federation(store=store, dns_domain=DOMAIN,
                       datacenter_name="local",
                       config={"upstreamBudget": 1,
                               "staleTtlClampSeconds": 5},
                       collector=collector)
    fed.start()
    rec = s.recursion(zk_cache=cache, dns_domain=DOMAIN,
                      datacenter_name="local",
                      source=fed.resolver_source(), nic_provider=lambda: [],
                      collector=collector,
                      client=s.client(concurrency=2, timeout=0.2),
                      ptr_client=s.client(concurrency=3, timeout=0.2))
    fed.attach(rec)
    await rec.wait_ready()
    srv = s.server.BinderServer(zk_cache=cache, dns_domain=DOMAIN,
                                datacenter_name="local", recursion=rec,
                                host="127.0.0.1", port=0,
                                collector=collector, query_log=False)
    srv.federation = fed
    await srv.start()
    rcodes = []
    try:
        asks = ([("1.0.88.10.in-addr.arpa", s.wire.Type.PTR)] * 2
                + [("web.dark.foo.com", s.wire.Type.A)] * 4
                + [("web.east.foo.com", s.wire.Type.A)])
        for k, (name, qtype) in enumerate(asks):
            random.seed(777 + k)
            reply = await udp_ask(srv.udp_port, s.wire.make_query(
                name, qtype, qid=k + 1, rd=True).encode())
            rcodes.append(reply[3] & 0x0F)
        clamps = collector.get(
            "binder_federation_budget_clamped_total").total()
        breakers = {
            peer.replace(str(dark_port), "DARK").replace(
                str(east_port), "EAST").replace(str(west_port), "WEST"):
            {k: v for k, v in b.items()
             if k not in ("open_remaining_seconds", "backoff_seconds",
                          "p95_latency_ms")}
            for peer, b in rec.breakers.introspect().items()}
        budget = rec.upstream_budget
        dark_dcs = fed.dark_dcs()
        forwards = fed.forwards
    finally:
        await srv.stop()
        await rec.close()
        for t in (t1, t2, t3):
            t.close()
    return rcodes, clamps, budget, breakers, dark_dcs, forwards, \
        len(dark.got)


def test_budget_and_breaker_accounting_identical():
    got = {side: asyncio.run(budget_run(side)) for side in SIDES}
    assert got["port"] == got["ref"]
    rcodes, clamps, budget, breakers, dark_dcs, _, dark_asks = got["port"]
    assert budget == 1 and clamps >= 2          # PTR fan-out of 3 -> 1
    assert breakers["127.0.0.1:DARK"]["state"] == "open"
    assert breakers["127.0.0.1:DARK"]["failures"] == 3
    assert dark_asks == 3                       # open breaker sends none
    assert dark_dcs == ["dark"]
    assert rcodes[2:6] == [5, 5, 5, 5] and rcodes[6] == 0


# -- verified ldaps ----------------------------------------------------


def test_verified_ldaps(tls_pki):  # noqa: F811
    async def go(server_side):
        s = SIDES[server_side]
        async with s.ldap.LdapTestServer(
                entries=RESOLVER_ENTRIES,
                ssl_context=tls_pki.server_ctx) as srv:
            base = {"url": f"ldaps://ufds.foo.com:{srv.port}",
                    "bindDN": "cn=root", "bindPassword": "secret"}
            verified = port_ufds.UfdsResolverSource(
                dict(base, ca=tls_pki.ca_pem))
            await verified.init(ufds_fixture("port"))
            listed = await verified.list_resolvers("home")
            await verified.close()
            rogue = port_ufds.UfdsResolverSource(
                dict(base, ca=tls_pki.rogue_ca_pem))
            with pytest.raises(ssl.SSLError):
                await rogue.init(ufds_fixture("port"))
            wrong_name = port_ufds.UfdsResolverSource(
                dict(base, ca=tls_pki.ca_pem,
                     tlsServerName="evil.example.com"))
            with pytest.raises(ssl.SSLCertVerificationError):
                await wrong_name.init(ufds_fixture("port"))
            # no ``ca``: the reference's posture, any certificate goes
            trusting = port_ufds.UfdsResolverSource(dict(base))
            await trusting.init(ufds_fixture("port"))
            trusted = await trusting.list_resolvers("home")
            await trusting.close()
        return listed, trusted

    for server_side in SIDES:
        listed, trusted = asyncio.run(go(server_side))
        assert sorted(map(sorted, (r.items() for r in listed))) == \
            sorted(map(sorted, (r.items() for r in trusted)))
        assert len(listed) == 3
    with pytest.raises(port_ufds.LdapError):
        port_ufds.UfdsResolverSource({"url": "ldaps://ufds.foo.com",
                                      "tlsServerName": "ufds.foo.com"})
