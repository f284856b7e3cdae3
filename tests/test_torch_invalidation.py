"""Per-name invalidation parity: tags and epochs of ``binder_torch``
against ``binder_tpu``.

The cases of the reference's ``tests/test_invalidation.py``, each run
as one scenario against each package: the answer cache's tag index,
the mirror's tag emission, selective invalidation and the epoch drop
through a live server, and the two churn soaks.  A scenario returns
what the reference test asserts on plus the cache counters and the
decoded answers; the two packages' observations must be equal and meet
the reference test's expectations.  Live servers run on the Python
lane (the reference has no C lane in this tree, and
``answer_cache.hits`` counts Python's hits alone).

``TestNativeTagInvalidation`` needs the extension, which only the port
builds here: it runs on the port's ``_binderfastio`` and is held to
the reference test's values.  Every other case carries the
``reference`` marker, and ``binder_tpu`` is imported only inside them,
so that the port's ASan lane loads this module without it.
"""
import asyncio
import random

import pytest

from binder_torch import server as port_server
from binder_torch.dns import server as port_dns_server
from binder_torch.dns import wire as port_wire
from binder_torch.metrics.collector import MetricsCollector as PortMetrics
from binder_torch.resolver.answer_cache import AnswerCache as PortAnswers
from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortCache
from tests.test_torch_fastio import pin_python_lane

DOMAIN = "foo.com"


class Side:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def sides():
    """Each package's names; the reference is imported here, so that
    the module loads without it (the port's ASan lane deselects the
    ``reference`` cases and must not load ``binder_tpu``)."""
    from binder_tpu import server as ref_server
    from binder_tpu.dns import wire as ref_wire
    from binder_tpu.metrics.collector import MetricsCollector as RefMetrics
    from binder_tpu.resolver.answer_cache import AnswerCache as RefAnswers
    from binder_tpu.store import FakeStore as RefStore
    from binder_tpu.store import MirrorCache as RefCache
    return {
        "port": Side(server=port_server, wire=port_wire,
                     metrics=PortMetrics, answers=PortAnswers,
                     store=PortStore, cache=PortCache),
        "ref": Side(server=ref_server, wire=ref_wire, metrics=RefMetrics,
                    answers=RefAnswers, store=RefStore, cache=RefCache),
    }


@pytest.fixture
def python_lane(monkeypatch):
    from binder_tpu import server as ref_server
    from binder_tpu.dns import server as ref_dns_server
    pin_python_lane(monkeypatch, (port_server, port_dns_server),
                    (ref_server, ref_dns_server))


def both(scenario, run=lambda x: x):
    """``scenario(side)`` on both packages; asserts equal observations
    and returns the port's."""
    got = {name: run(scenario(s)) for name, s in sides().items()}
    assert got["port"] == got["ref"]
    return got["port"]


def both_async(scenario):
    return both(scenario, asyncio.run)


def build(s, cache_size=10000):
    """``tests/test_answer_cache.py``'s ``build`` on package ``s``."""
    store = s.store()
    cache = s.cache(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "192.168.0.1"}})
    store.put_json("/com/foo/svc", {
        "type": "service",
        "service": {"srvce": "_pg", "proto": "_tcp", "port": 5432}})
    for i in range(4):
        store.put_json(f"/com/foo/svc/lb{i}",
                       {"type": "load_balancer",
                        "load_balancer": {"address": f"10.0.1.{i + 1}"}})
    store.start_session()
    server = s.server.BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        host="127.0.0.1", port=0, collector=s.metrics(),
        cache_size=cache_size)
    return store, cache, server


async def udp_ask(s, port, name, qtype, qid=1):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class P(asyncio.DatagramProtocol):
        def connection_made(self, t):
            t.sendto(s.wire.make_query(name, qtype, qid=qid).encode())

        def datagram_received(self, d, a):
            if not fut.done():
                fut.set_result(d)

    tr, _ = await loop.create_datagram_endpoint(
        P, remote_addr=("127.0.0.1", port))
    try:
        return s.wire.Message.decode(await asyncio.wait_for(fut, 5))
    finally:
        tr.close()


def shape(r):
    """A reply as comparable values: rcode and the sorted records."""
    def rows(section):
        return sorted(repr(sorted(vars(x).items())) for x in section)
    return (r.rcode, rows(r.answers), rows(r.additionals))


# -- TestAnswerCacheTags ----------------------------------------------


@pytest.mark.reference
def test_invalidate_tag_drops_only_matching():
    def scenario(s):
        c = s.answers()
        c.put("k1", 0, "v1", tag="web.foo.com")
        c.put("k2", 0, "v2", tag="api.foo.com")
        c.put("k3", 0, "v3", tag="web.foo.com")
        n = c.invalidate_tag("web.foo.com")
        return (n, c.get("k1", 0), c.get("k2", 0), c.get("k3", 0),
                c.invalidate_tag("web.foo.com"))

    assert both(scenario) == (2, None, "v2", None, 0)


@pytest.mark.reference
def test_eviction_keeps_tag_index_consistent():
    def scenario(s):
        c = s.answers(size=2)
        c.put("k1", 0, "v1", tag="t")
        c.put("k2", 0, "v2", tag="t")
        c.put("k3", 0, "v3", tag="t")     # evicts k1
        return (c.invalidate_tag("t"), len(c._entries), len(c._by_tag))

    assert both(scenario) == (2, 0, 0)


@pytest.mark.reference
def test_epoch_mismatch_still_drops():
    def scenario(s):
        c = s.answers()
        c.put("k", 7, "v", tag="t")
        return c.get("k", 8), len(c._entries), len(c._by_tag)

    assert both(scenario) == (None, 0, 0)


# -- TestMirrorTagEmission --------------------------------------------


def collect(s, mutations):
    store = s.store()
    cache = s.cache(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "10.1.2.3"}})
    store.start_session()
    seen = []
    cache.on_invalidate(lambda tags: seen.append(sorted(tags)))
    mutations(store)
    return seen


@pytest.mark.reference
def test_data_change_emits_name_parent_and_both_rev_names():
    seen = both(lambda s: collect(s, lambda st: st.put_json(
        "/com/foo/web", {"type": "host", "host": {"address": "10.9.9.9"}})))
    assert {"web.foo.com", "foo.com", "3.2.1.10.in-addr.arpa",
            "9.9.9.10.in-addr.arpa"} <= set().union(*seen)


@pytest.mark.reference
def test_child_creation_emits_parent_and_child():
    seen = both(lambda s: collect(s, lambda st: st.put_json(
        "/com/foo/api", {"type": "host", "host": {"address": "10.4.4.4"}})))
    assert {"api.foo.com", "foo.com"} <= set().union(*seen)


@pytest.mark.reference
def test_delete_emits_name_parent_and_rev():
    seen = both(lambda s: collect(s, lambda st: st.delete("/com/foo/web")))
    assert {"web.foo.com", "foo.com",
            "3.2.1.10.in-addr.arpa"} <= set().union(*seen)


# -- TestSelectiveInvalidation ----------------------------------------


@pytest.mark.reference
def test_unrelated_mutation_keeps_cache_hot(python_lane):
    async def scenario(s):
        store, cache, server = build(s)
        await server.start()
        try:
            A = s.wire.Type.A
            await udp_ask(s, server.udp_port, "web.foo.com", A, 1)
            await udp_ask(s, server.udp_port, "web.foo.com", A, 2)
            hits_before = server.answer_cache.hits
            for i in range(50):
                store.put_json("/com/foo/churny",
                               {"type": "host",
                                "host": {"address": f"10.8.0.{i + 1}"}})
            r = await udp_ask(s, server.udp_port, "web.foo.com", A, 3)
            return (shape(r), r.answers[0].address,
                    server.answer_cache.hits - hits_before,
                    server.answer_cache.misses)
        finally:
            await server.stop()

    _, addr, hits, _ = both_async(scenario)
    assert addr == "192.168.0.1"
    assert hits == 1      # still a cache hit after 50 mutations


@pytest.mark.reference
def test_mutated_name_served_fresh_others_stay_cached(python_lane):
    async def scenario(s):
        store, cache, server = build(s)
        await server.start()
        T = s.wire.Type
        try:
            await udp_ask(s, server.udp_port, "web.foo.com", T.A, 1)
            r_srv = await udp_ask(s, server.udp_port,
                                  "_pg._tcp.svc.foo.com", T.SRV, 2)
            store.put_json("/com/foo/web",
                           {"type": "host",
                            "host": {"address": "172.16.0.9"}})
            r_web = await udp_ask(s, server.udp_port, "web.foo.com",
                                  T.A, 3)
            r_old = await udp_ask(s, server.udp_port,
                                  "1.0.168.192.in-addr.arpa", T.PTR, 4)
            r_new = await udp_ask(s, server.udp_port,
                                  "9.0.16.172.in-addr.arpa", T.PTR, 5)
            return ([shape(r) for r in (r_srv, r_web, r_old, r_new)],
                    len(r_srv.answers), r_web.answers[0].address,
                    r_old.rcode, r_new.answers[0].target)
        finally:
            await server.stop()

    _, n_srv, web, old_rcode, target = both_async(scenario)
    assert web == "172.16.0.9"
    assert old_rcode == 5                # REFUSED
    assert target == "web.foo.com"
    assert n_srv == 4


@pytest.mark.reference
def test_service_child_add_refreshes_parent_answers(python_lane):
    async def scenario(s):
        store, cache, server = build(s)
        await server.start()
        A = s.wire.Type.A
        try:
            for i in range(12):
                await udp_ask(s, server.udp_port, "svc.foo.com", A, 10 + i)
            store.put_json("/com/foo/svc/lb99",
                           {"type": "load_balancer",
                            "load_balancer": {"address": "10.0.1.99"}})
            seen, sets = set(), set()
            for i in range(12):
                r = await udp_ask(s, server.udp_port, "svc.foo.com", A,
                                  40 + i)
                seen.update(a.address for a in r.answers)
                sets.add(tuple(sorted(a.address for a in r.answers)))
            return sorted(seen), sorted(sets)
        finally:
            await server.stop()

    seen, sets = both_async(scenario)
    assert "10.0.1.99" in seen
    assert sets == [tuple(sorted(
        [f"10.0.1.{i + 1}" for i in range(4)] + ["10.0.1.99"]))]


@pytest.mark.reference
def test_session_rebuild_epoch_drops_everything(python_lane):
    async def scenario(s):
        store, cache, server = build(s)
        await server.start()
        A = s.wire.Type.A
        try:
            await udp_ask(s, server.udp_port, "web.foo.com", A, 1)
            await udp_ask(s, server.udp_port, "web.foo.com", A, 2)
            epoch_before = cache.epoch
            cache.rebuild()          # session event
            bumped = cache.epoch - epoch_before
            hits_before = server.answer_cache.hits
            r = await udp_ask(s, server.udp_port, "web.foo.com", A, 3)
            return (bumped, shape(r), r.answers[0].address,
                    server.answer_cache.hits - hits_before)
        finally:
            await server.stop()

    bumped, _, addr, hits = both_async(scenario)
    assert bumped == 1
    assert addr == "192.168.0.1"
    assert hits == 0           # re-resolved, not served stale


# -- TestNativeTagInvalidation (the port's extension) -----------------


def test_fastpath_invalidate_by_tag():
    from binder_torch import _binderfastio as fastio
    cap = fastio.fastpath_new(64, 60000, [0.001, 0.01], [100.0])
    # key layout: [flags][payload BE16][qtype BE16][qclass BE16][qname]
    qname = b"\x03web\x03foo\x03com\x00"
    key = bytes([1, 0x04, 0xd0, 0, 1, 0, 1]) + qname
    wire = b"\x00\x00\x84\x00\x00\x01\x00\x01\x00\x00\x00\x00" \
        + qname + b"\x00\x01\x00\x01" + b"\xc0\x0c\x00\x01\x00\x01" \
        + b"\x00\x00\x00\x1e\x00\x04\x0a\x01\x02\x03"
    assert fastio.fastpath_put(cap, key, 1, 0, [wire], -1, qname)
    assert fastio.fastpath_stats(cap)["entries"] == 1
    # wrong tag: nothing dropped
    assert fastio.fastpath_invalidate(
        cap, b"\x03api\x03foo\x03com\x00") == 0
    assert fastio.fastpath_stats(cap)["entries"] == 1
    # right tag
    assert fastio.fastpath_invalidate(cap, qname) == 1
    stats = fastio.fastpath_stats(cap)
    assert stats["entries"] == 0
    # the monotonic drop counter feeds binder_answer_cache_invalidations
    assert stats["invalidations"] == 1


# -- TestDifferentialChurn --------------------------------------------


@pytest.mark.reference
def test_service_and_ptr_churn_never_serves_stale(python_lane):
    """Service-shaped churn: load_balancer children come and go under a
    service node while SRV, rotated A and PTR queries interleave; every
    answer reflects the current children and addresses."""
    async def scenario(s):
        store, cache, server = build(s)
        await server.start()
        T, R = s.wire.Type, s.wire.Rcode
        rng = random.Random(11)
        members = {f"lb{i}": f"10.0.1.{i + 1}" for i in range(4)}
        next_id, next_addr = [100], [0]
        steps = []

        def fresh_addr():
            next_addr[0] += 1
            return f"10.6.{next_addr[0] >> 8}.{next_addr[0] & 255}"
        try:
            for step in range(200):
                op = rng.random()
                gone_ptr = None
                if op < 0.2 and len(members) < 12:
                    name = f"m{next_id[0]}"
                    next_id[0] += 1
                    addr = fresh_addr()
                    store.put_json(f"/com/foo/svc/{name}",
                                   {"type": "load_balancer",
                                    "load_balancer": {"address": addr}})
                    members[name] = addr
                elif op < 0.35 and len(members) > 1:
                    victim = rng.choice(sorted(members))
                    removed = members.pop(victim)
                    store.delete(f"/com/foo/svc/{victim}")
                    rev = ".".join(reversed(removed.split("."))) \
                        + ".in-addr.arpa"
                    gone_ptr = (await udp_ask(
                        s, server.udp_port, rev, T.PTR,
                        (step * 7 + 5) % 65536)).rcode
                    assert gone_ptr == R.REFUSED, step
                elif op < 0.5 and members:
                    victim = rng.choice(sorted(members))
                    members[victim] = fresh_addr()
                    store.put_json(f"/com/foo/svc/{victim}",
                                   {"type": "load_balancer",
                                    "load_balancer":
                                    {"address": members[victim]}})
                want = sorted(members.values())
                r = await udp_ask(s, server.udp_port, "svc.foo.com", T.A,
                                  step * 3 % 65536)
                got = sorted(a.address for a in r.answers)
                assert got == want, (step, got, want)
                r = await udp_ask(s, server.udp_port,
                                  "_pg._tcp.svc.foo.com", T.SRV,
                                  (step * 3 + 1) % 65536)
                assert len(r.answers) == len(members), step
                srv = sorted(a.target for a in r.answers)
                ptr = None
                if members:
                    addr = rng.choice(sorted(members.values()))
                    rev = ".".join(reversed(addr.split("."))) \
                        + ".in-addr.arpa"
                    ptr = await udp_ask(s, server.udp_port, rev, T.PTR,
                                        (step * 3 + 2) % 65536)
                    assert ptr.rcode == R.NOERROR, (step, addr)
                    ptr = ptr.answers[0].target
                steps.append((got, srv, ptr, gone_ptr))
            return steps
        finally:
            await server.stop()

    steps = both_async(scenario)
    assert len(steps) == 200


@pytest.mark.reference
def test_random_churn_never_serves_stale(python_lane):
    """Randomized soak: every answer reflects the store state at query
    time (the fake store delivers watches synchronously)."""
    async def scenario(s):
        store, cache, server = build(s)
        await server.start()
        rng = random.Random(7)
        state = {}
        seen = []
        try:
            for step in range(300):
                name = f"h{rng.randrange(8)}"
                if rng.random() < 0.4:
                    addr = (f"10.5.{rng.randrange(256)}."
                            f"{rng.randrange(1, 255)}")
                    store.put_json(f"/com/foo/{name}",
                                   {"type": "host",
                                    "host": {"address": addr}})
                    state[name] = addr
                elif rng.random() < 0.15 and name in state:
                    store.delete(f"/com/foo/{name}")
                    del state[name]
                r = await udp_ask(s, server.udp_port, f"{name}.foo.com",
                                  s.wire.Type.A, step % 65536)
                got = [a.address for a in r.answers]
                if name in state:
                    assert got == [state[name]], f"step {step}: stale"
                else:
                    assert r.rcode == s.wire.Rcode.REFUSED, step
                seen.append((r.rcode, got))
            return seen
        finally:
            await server.stop()

    seen = both_async(scenario)
    assert len(seen) == 300
