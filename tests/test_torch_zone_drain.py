"""The zone lane's refill queues after a burst of mutations.

A mirror walk (a server's first ZooKeeper session, or a rebuild) lands
every name as a mutation, so the zone lane's dirty set and the
verifier's tag queue each hold two entries per name before they drain.
A drained set or dict keeps the table it grew to, and ``set.pop()`` and
``next(iter(dict))`` walk that table: each later mutation then paid a
scan of the whole walk's slots, so one write's cost grew with the zone
(0.6 ms at 1,000 names, 1.6 ms at 30,000 on a CPU; ``chip_smoke.py
--churn-cost``). The port starts each from an empty container once it
drains (the reference keeps the grown one).
"""
import asyncio
import sys

import pytest

from binder_torch.dns import Message, Type, make_query
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache

DOMAIN = "foo.com"
BURST = 3000


def host(i):
    return {"type": "host", "host": {"address": f"10.1.{i >> 8}.{i & 255}"}}


async def burst_then_drain(server, store):
    """Write ``BURST`` names in one loop pass, then wait until the zone
    lane and the verifier have drained them."""
    for i in range(BURST):
        store.put_json(f"/com/foo/b{i:05d}", host(i))
    assert len(server._zone_dirty) >= BURST
    for _ in range(2000):
        if not server._zone_dirty and not server._verify._queue:
            return
        await asyncio.sleep(0.005)
    raise AssertionError("the burst did not drain")


async def ask(port, name):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class Proto(asyncio.DatagramProtocol):
        def connection_made(self, transport):
            transport.sendto(make_query(name, Type.A, qid=7).encode())

        def datagram_received(self, data, addr):
            if not fut.done():
                fut.set_result(data)

    transport, _ = await loop.create_datagram_endpoint(
        Proto, remote_addr=("127.0.0.1", port))
    try:
        return Message.decode(await asyncio.wait_for(fut, 2.0))
    finally:
        transport.close()


def sizes():
    """The two containers' sizes once a burst has drained, after one
    more write has still reached the zone lane and the glass."""
    async def run():
        store = FakeStore()
        cache = MirrorCache(store, DOMAIN)
        store.put_json("/com/foo/web", host(0))
        store.start_session()
        server = BinderServer(zk_cache=cache, dns_domain=DOMAIN,
                              datacenter_name="dc0", host="127.0.0.1",
                              port=0, collector=MetricsCollector(),
                              query_log=False, verify={})
        await server.start()
        try:
            assert server._zone_enabled
            await burst_then_drain(server, store)
            store.put_json("/com/foo/b00001",
                           {"type": "host",
                            "host": {"address": "10.9.9.9"}})
            for _ in range(400):
                if not server._zone_dirty:
                    break
                await asyncio.sleep(0.005)
            msg = await ask(server.udp_port, f"b00001.{DOMAIN}")
            assert [a.address for a in msg.answers] == ["10.9.9.9"]
            return {"zone dirty set": (server._zone_dirty, set()),
                    "verify queue": (server._verify._queue, {})}
        finally:
            await server.stop()

    return asyncio.run(run())


@pytest.mark.parametrize("which", ["zone dirty set", "verify queue"])
def test_a_drained_queue_starts_small_again(which):
    got, empty = sizes()[which]
    assert not got
    assert sys.getsizeof(got) == sys.getsizeof(empty)
