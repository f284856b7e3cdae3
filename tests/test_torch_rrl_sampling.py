"""How the port's UDP reader lets the response rate limiter see the C lane.

While the native fast-path gate is open, ``fastpath_drain`` answers
cache and zone hits in C, where ``ResponseRateLimiter.decide()`` never
runs. The reader therefore samples: one batch in Python, each packet
charged ``FASTPATH_SAMPLE_EVERY`` tokens, earns the C drain
``FASTPATH_SAMPLE_EVERY - 1`` packets per packet sampled. The count is
in packets, so a flood that lands in a single readiness event (a
worker descheduled while the burst arrives) is judged like the same
flood spread over many events; a sampler that counted events served
such a burst in C whole. Under a backlog the sampled drain still reads
with batched ``recvmmsg``.
"""
import asyncio
import socket

from binder_torch import _binderfastio as fastio
from binder_torch.dns import Message, Rcode, Type, make_query
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.policy.rrl import ResponseRateLimiter
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache

DOMAIN = "foo.com"
EVERY = ResponseRateLimiter.FASTPATH_SAMPLE_EVERY


def fixture_cache():
    store = FakeStore()
    cache = MirrorCache(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "192.168.0.1"}})
    store.start_session()
    return cache


async def start_server(rrl):
    server = BinderServer(zk_cache=fixture_cache(), dns_domain=DOMAIN,
                          datacenter_name="coal", host="127.0.0.1", port=0,
                          collector=MetricsCollector(), query_log=False,
                          rrl=rrl)
    await server.start()
    assert server.engine.fastpath is not None
    assert server.engine.fastpath_gate(), "the C lane must be open"
    return server


async def udp_ask(port, qid):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class Proto(asyncio.DatagramProtocol):
        def connection_made(self, transport):
            transport.sendto(make_query("web.foo.com", Type.A,
                                        qid=qid).encode())

        def datagram_received(self, data, addr):
            if not fut.done():
                fut.set_result(data)

    transport, _ = await loop.create_datagram_endpoint(
        Proto, remote_addr=("127.0.0.1", port))
    try:
        return Message.decode(await asyncio.wait_for(fut, 2.0))
    finally:
        transport.close()


def test_burst_in_one_readiness_event_is_limited():
    """A spoofed /24 sends 60 queries while the reader cannot run, so
    one readiness event drains them all. The allowlisted client's 12
    single-packet events before it leave an event-counting sampler
    between samples (it served the whole burst in C and dropped
    nothing); the packet-counting one owes the C lane 3 packets,
    judges the rest at 8 tokens each and limits the burst (40 tokens,
    20/s)."""
    async def run():
        server = await start_server({"responsesPerSecond": 20,
                                     "burst": 40,
                                     "allowlist": ["127.0.0.0/24"]})
        try:
            for qid in range(1, 13):
                msg = await udp_ask(server.udp_port, qid)
                assert msg.rcode == Rcode.NOERROR
            rrl = server._rrl
            assert rrl.dropped == 0 and rrl.slipped == 0
            flood = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                flood.bind(("127.66.7.7", 0))
                wire = make_query("web.foo.com", Type.A, qid=99).encode()
                for _ in range(60):
                    flood.sendto(wire, ("127.0.0.1", server.udp_port))
                await asyncio.sleep(0.1)
            finally:
                flood.close()
            limited = rrl.dropped + rrl.slipped
            assert limited > 0, "the burst was served in C unjudged"
            assert rrl.hot() and not server.engine.fastpath_gate()
            return limited
        finally:
            await server.stop()

    assert asyncio.run(run()) > 0


def test_single_packet_events_sample_one_in_every():
    """At light load, each packet its own readiness event, the limiter
    judges one packet in ``FASTPATH_SAMPLE_EVERY`` (plus any the C lane
    declines) and the C lane answers the rest."""
    async def run():
        server = await start_server({"responsesPerSecond": 1000000,
                                     "burst": 1000000})
        try:
            n = 8 * EVERY
            for qid in range(1, n + 1):
                msg = await udp_ask(server.udp_port, qid)
                assert msg.rcode == Rcode.NOERROR
                assert [a.address for a in msg.answers] == ["192.168.0.1"]
            judged = server._rrl.responses
            assert n // EVERY <= judged <= n // EVERY + 2, judged
        finally:
            await server.stop()

    asyncio.run(run())


def test_sampled_drain_keeps_recvmmsg_batched():
    """The port's counterpart of the reference's
    ``TestSamplerRidesTheBatch``: under a backlogged socket with the
    limiter armed but never hot, the sampled drain reads in batches,
    never one ``recvfrom`` per packet."""
    rounds, per_round = 4 * EVERY, 64

    async def run():
        server = await start_server({"responsesPerSecond": 1000000,
                                     "burst": 1000000, "slipRatio": 2})
        try:
            wire = make_query("web.foo.com", Type.A, qid=77).encode()
            addr = ("127.0.0.1", server.udp_port)
            csock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                csock.setblocking(False)
                fastio.io_stats(True)
                for _ in range(rounds):
                    for _ in range(per_round):
                        try:
                            csock.sendto(wire, addr)
                        except OSError:
                            pass
                    await asyncio.sleep(0.002)
                await asyncio.sleep(0.02)
            finally:
                csock.close()
            return fastio.io_stats(True), server._rrl.responses
        finally:
            await server.stop()

    io, judged = asyncio.run(run())
    cells = io["recv_cells"]
    assert io["recv_msgs"] >= rounds * per_round // 2, io
    assert io["recv_msgs"] / io["recv_calls"] >= 8, io
    assert sum(cells[3:]) > 0, cells
    assert cells[0] <= io["recv_calls"] // 2, cells
    # the sampled share stays near one in EVERY
    assert judged <= 2 * io["recv_msgs"] // EVERY + per_round, \
        (judged, io["recv_msgs"])
