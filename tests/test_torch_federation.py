"""Federation parity: ``binder_torch.federation`` against
``binder_tpu.federation``.

- Registry: one ``/dcs`` store script (joins, a peer change, a
  malformed record, the local DC's own record, a leave) drives a
  ``DcRegistry`` of each package over a FakeStore, and the port's
  registry over the port's ZooKeeper client and test server as well.
  After every step the records, the routing table, zone ownership and
  the join/leave counts are the same everywhere.
- Dark DC: a federated server of each package warms its foreign cache
  through a scripted upstream, then the upstream goes away.  The same
  asks give byte-identical replies (same query IDs, nothing masked):
  the cached name stale-served NOERROR with its TTL clamped, a name
  never seen REFUSED, the local name untouched; past the staleness cap
  the cached name is withheld as SERVFAIL, or REFUSED when so
  configured.  The federation's own accounting matches too.
"""
import asyncio
import json

import pytest

from binder_torch.federation import DcRegistry as PortRegistry
from binder_torch.store import FakeStore as PortStore
from binder_torch.store.zk_client import ZKClient
from binder_torch.store.zk_testserver import ZKTestServer
from binder_tpu.federation import DcRegistry as RefRegistry
from binder_tpu.store import FakeStore as RefStore

from tests.test_torch_recursion import (SIDES, python_lane,  # noqa: F401
                                        start_upstream, udp_ask)

DOMAIN = "foo.com"

#: (op, path, record) applied in order; ``raw`` records are bytes
DCS_SCRIPT = [
    ("put", "/dcs/east", {"zones": ["east"], "peers": ["10.0.0.1:53"]}),
    ("put", "/dcs/local", {"zones": ["local"], "peers": ["10.0.0.9:53"]}),
    ("put", "/dcs/west", {"zones": ["west", "w2"],
                          "peers": ["10.0.0.2:53", "10.0.0.3:5353"]}),
    ("put", "/dcs/east", {"zones": ["east"], "peers": ["10.0.0.7:53"]}),
    ("raw", "/dcs/broken", b"not json"),
    ("put", "/dcs/north", {"zones": ["north"], "peers": []}),
    ("raw", "/dcs/west", b"{\"zones\": 7}"),
    ("delete", "/dcs/east", None),
    ("put", "/dcs/west", {"zones": ["west"], "peers": ["10.0.0.4:53"]}),
]


def registry_view(reg):
    return {"records": dict(sorted(reg.records.items())),
            "zone_map": reg.foreign_zone_map(),
            "owners": {z: reg.zone_owner(z)
                       for z in ("east", "west", "w2", "local", "north",
                                 "broken", "nope")},
            "joins": reg.joins, "leaves": reg.leaves}


def fake_run(store_cls, registry_cls):
    store = store_cls()
    store.start_session()
    reg = registry_cls(store, self_name="local")
    reg.start()
    views = []
    for op, path, rec in DCS_SCRIPT:
        if op == "put":
            store.put_json(path, rec)
        elif op == "raw":
            if store.exists(path):
                store.set_data(path, rec)
            else:
                store.mkdirp(path, rec)
        else:
            store.delete(path)
        views.append(registry_view(reg))
    return views


async def zk_run(expected):
    server = ZKTestServer()
    await server.start()
    client = ZKClient(address="127.0.0.1", port=server.port,
                      session_timeout_ms=5000)
    writer = ZKClient(address="127.0.0.1", port=server.port)
    client.start()
    writer.start()
    while not (client.is_connected() and writer.is_connected()):
        await asyncio.sleep(0.01)
    reg = PortRegistry(client, self_name="local")
    reg.start()
    views = []
    for k, (op, path, rec) in enumerate(DCS_SCRIPT):
        if op == "delete":
            await writer.delete(path)
        else:
            data = rec if op == "raw" else json.dumps(rec).encode()
            if await writer.exists(path):
                await writer.set_data(path, data)
            else:
                await writer.mkdirp(path, data)
        # a watch round trip per step: settle on the expected view
        want = expected[k]
        for _ in range(500):
            if registry_view(reg) == want:
                break
            await asyncio.sleep(0.01)
        views.append(registry_view(reg))
    client.close()
    writer.close()
    await server.stop()
    return views


def test_registry_follows_the_same_script():
    want = fake_run(RefStore, RefRegistry)
    assert fake_run(PortStore, PortRegistry) == want
    assert asyncio.run(zk_run(want)) == want
    last = want[-1]
    assert last["zone_map"] == {"north": [], "west": ["10.0.0.4:53"]}
    assert set(last["records"]) == {"local", "north", "west"}
    assert last["owners"]["local"] is None
    assert last["leaves"] >= 1


async def dark_run(side, fed_cfg):
    s = SIDES[side]
    east, east_port, transport = await start_upstream("east", "10.77.0.2")
    store = s.store()
    cache = s.cache(store, DOMAIN)
    store.put_json("/com/foo/local", {"type": "service",
                                      "service": {"port": 53}})
    store.put_json("/com/foo/local/web",
                   {"type": "host", "host": {"address": "10.1.0.1",
                                             "ttl": 30}})
    store.put_json("/dcs/east", {"zones": ["east"],
                                 "peers": [f"127.0.0.1:{east_port}"]})
    store.start_session()
    collector = s.metrics()
    fed = s.federation(store=store, dns_domain=DOMAIN,
                       datacenter_name="local", config=fed_cfg,
                       collector=collector)
    fed.start()
    rec = s.recursion(zk_cache=cache, dns_domain=DOMAIN,
                      datacenter_name="local",
                      source=fed.resolver_source(), nic_provider=lambda: [],
                      collector=collector,
                      client=s.client(concurrency=2, timeout=0.3))
    fed.attach(rec)
    await rec.wait_ready()
    srv = s.server.BinderServer(zk_cache=cache, dns_domain=DOMAIN,
                                datacenter_name="local", recursion=rec,
                                host="127.0.0.1", port=0,
                                collector=collector, query_log=False)
    srv.federation = fed
    await srv.start()

    async def ask(name, qid):
        return await udp_ask(srv.udp_port, s.wire.make_query(
            name, s.wire.Type.A, qid=qid, rd=True).encode())

    try:
        replies = [await ask("web.east.foo.com", 1),
                   await ask("nope.east.foo.com", 2)]
        transport.close()                    # the whole DC goes dark
        await asyncio.sleep(0.05)
        replies += [await ask("web.east.foo.com", 3),
                    await ask("other.east.foo.com", 4),
                    await ask("web.local.foo.com", 5),
                    await ask("web.east.foo.com", 6)]
        intro = fed.introspect()
        state = (fed.dark_dcs(), fed.forwards, intro["foreign_cache"],
                 intro["policy"], sorted(intro["health"]),
                 collector.get(
                     "binder_federation_foreign_stale_served_total")
                 .total())
    finally:
        await srv.stop()
        await rec.close()
    return replies, state


@pytest.mark.usefixtures("python_lane")
@pytest.mark.parametrize("fed_cfg,dark_rcode", [
    ({"staleTtlClampSeconds": 5}, 0),
    ({"maxStalenessSeconds": 0.0}, 2),
    ({"maxStalenessSeconds": 0.0, "exhaustedAction": "refused"}, 5),
], ids=["stale-served", "withheld-servfail", "withheld-refused"])
def test_dark_dc_answers_identically(fed_cfg, dark_rcode):
    got = {side: asyncio.run(dark_run(side, dict(fed_cfg)))
           for side in SIDES}
    assert got["port"] == got["ref"]
    replies, (dark, *_) = got["port"]
    msgs = [SIDES["ref"].wire.Message.decode(r) for r in replies]
    assert [m.rcode for m in msgs] == [0, 5, dark_rcode, 5, 0, dark_rcode]
    assert msgs[0].answers[0].ttl == 44
    assert msgs[4].answers[0].ttl == 30          # local stays untouched
    if dark_rcode == 0:
        assert [a.ttl for a in msgs[2].answers] == [5]
        assert msgs[2].answers[0].address == "10.77.0.2"
    assert dark == ["east"]
