"""Whole-system integration on the port: ZooKeeper to the balancer cache.

The three scenarios of ``tests/test_full_stack.py`` on port modules:
the port's in-process ZooKeeper server (jute protocol), port backends
whose mirrors watch it through the port's ZooKeeper client, the
``mbalancer`` binary the port builds (``binder_torch.fastio_build``)
fronting them over the balancer-socket protocol, and a UDP client.
The balancer runs with its answer cache on and the relay lane pinned
(``-D``), as the reference's scenarios do, so that replies, and with
them the cache, pass through it: a ZooKeeper write flows through watch
delivery, the mirror, the per-name invalidate frame and the balancer's
cache, and the next query serves the new data; a write drops only the
written name's entries; another DC's answers are never cached.
"""
import asyncio
import json
import os

from binder_torch import fastio_build
from binder_torch.dns import Message, Rcode, Type, make_query
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.server import BinderServer
from binder_torch.store import MirrorCache
from binder_torch.store.zk_client import ZKClient
from binder_torch.store.zk_testserver import ZKTestServer
from tests.test_torch_balancer import read_stats

DOMAIN = "foo.com"


async def start_balancer(sockdir):
    """The port-built ``mbalancer`` with its 60 s answer cache on and
    the relay lane pinned (``-D``); the process and its UDP port."""
    binary, _ = fastio_build.build("mbalancer")
    proc = await asyncio.create_subprocess_exec(
        binary, "-d", sockdir, "-p", "0", "-b", "127.0.0.1", "-s", "150",
        "-c", "60000", "-D", stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.DEVNULL)
    line = await asyncio.wait_for(proc.stdout.readline(), 30)
    assert line.startswith(b"PORT "), line
    return proc, int(line.split()[1])


async def udp_ask(port, name, qtype, qid=1, rd=False, timeout=5.0):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class Proto(asyncio.DatagramProtocol):
        def connection_made(self, transport):
            transport.sendto(make_query(name, qtype, qid=qid,
                                        rd=rd).encode())

        def datagram_received(self, data, addr):
            if not fut.done():
                fut.set_result(data)

    transport, _ = await loop.create_datagram_endpoint(
        Proto, remote_addr=("127.0.0.1", port))
    try:
        return Message.decode(await asyncio.wait_for(fut, timeout))
    finally:
        transport.close()


async def wait_for(predicate, timeout=5.0, interval=0.02):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if predicate():
            return True
        await asyncio.sleep(interval)
    return False


async def put_json(zk, path, obj):
    data = json.dumps(obj).encode()
    if await zk.exists(path):
        await zk.set_data(path, data)
    else:
        await zk.mkdirp(path, data)


def host(addr):
    return {"type": "host", "host": {"address": addr}}


def address(cache, name):
    node = cache.lookup(name)
    return node.data["host"]["address"] if node and node.data else None


async def zk_backend(zk_port, sockdir, instance):
    client = ZKClient(address="127.0.0.1", port=zk_port,
                      session_timeout_ms=2000)
    cache = MirrorCache(client, DOMAIN)
    client.start()
    server = BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        host="127.0.0.1", port=0,
        balancer_socket=os.path.join(sockdir, str(instance)),
        collector=MetricsCollector())
    await server.start()
    return client, cache, server


async def connected_writer(zk_port):
    writer = ZKClient(address="127.0.0.1", port=zk_port)
    writer.start()
    assert await wait_for(writer.is_connected)
    return writer


def test_zk_to_balancer_full_chain(tmp_path):
    sockdir = str(tmp_path)

    async def run():
        zkserver = ZKTestServer()
        await zkserver.start()
        writer = await connected_writer(zkserver.port)
        await put_json(writer, "/com/foo/web", host("10.5.0.1"))
        backends = [await zk_backend(zkserver.port, sockdir, i)
                    for i in range(2)]
        assert await wait_for(lambda: all(
            c.lookup("web.foo.com") is not None for _, c, _s in backends))

        proc, port = await start_balancer(sockdir)
        try:
            await asyncio.sleep(0.4)
            # resolve and repeat: the repeats are the balancer cache's,
            # filled from a backend whose data came over the ZK wire
            for qid in (1, 2, 3):
                m = await udp_ask(port, "web.foo.com", Type.A, qid=qid)
                assert m.rcode == Rcode.NOERROR
                assert m.answers[0].address == "10.5.0.1"
            stats = read_stats(sockdir)
            assert stats["cache_hits"] >= 1
            assert all(be["gen_known"] for be in stats["backends"]
                       if be["healthy"])

            # write -> watch -> mirror -> invalidate frame -> balancer
            # cache drop -> fresh answer
            await writer.set_data("/com/foo/web", json.dumps(
                host("10.5.0.99")).encode())
            assert await wait_for(lambda: all(
                address(c, "web.foo.com") == "10.5.0.99"
                for _, c, _s in backends))
            await asyncio.sleep(0.1)   # control-frame delivery
            m = await udp_ask(port, "web.foo.com", Type.A, qid=50)
            assert m.answers[0].address == "10.5.0.99"
            # and the fresh answer is cacheable again
            m = await udp_ask(port, "web.foo.com", Type.A, qid=51)
            assert m.answers[0].address == "10.5.0.99"

            # a node added over ZK resolves through the balancer
            await put_json(writer, "/com/foo/late", host("10.5.7.7"))
            assert await wait_for(lambda: all(
                address(c, "late.foo.com") is not None
                for _, c, _s in backends))
            m = await udp_ask(port, "late.foo.com", Type.A, qid=60)
            assert m.answers[0].address == "10.5.7.7"

            # session expiry on one backend: it rebuilds and serves on;
            # the balancer answers throughout
            zkserver.expire_session()
            await asyncio.sleep(0.3)
            for qid in range(70, 76):
                m = await udp_ask(port, "web.foo.com", Type.A, qid=qid)
                assert m.answers[0].address == "10.5.0.99"
        finally:
            proc.kill()
            await proc.wait()
            for client, _c, server in backends:
                await server.stop()
                client.close()
            writer.close()
            await zkserver.stop()

    asyncio.run(run())


def test_balancer_invalidation_is_per_name(tmp_path):
    """A write drops only the written name's balancer entries (opcode-1
    per-name invalidate frames): the other name keeps serving from the
    balancer cache, and the stats socket counts the selective drop."""
    sockdir = str(tmp_path)

    async def run():
        zkserver = ZKTestServer()
        await zkserver.start()
        writer = await connected_writer(zkserver.port)
        await put_json(writer, "/com/foo/web", host("10.5.0.1"))
        await put_json(writer, "/com/foo/api", host("10.5.0.2"))
        client, cache, server = await zk_backend(zkserver.port, sockdir, 0)
        assert await wait_for(
            lambda: address(cache, "api.foo.com") is not None)

        proc, port = await start_balancer(sockdir)
        try:
            await asyncio.sleep(0.4)
            # fill the balancer cache for both names
            for qid, name in ((1, "web.foo.com"), (2, "api.foo.com"),
                              (3, "web.foo.com"), (4, "api.foo.com")):
                m = await udp_ask(port, name, Type.A, qid=qid)
                assert m.rcode == Rcode.NOERROR
            hits0 = read_stats(sockdir)["cache_hits"]
            assert hits0 >= 2

            await writer.set_data("/com/foo/web", json.dumps(
                host("10.5.0.88")).encode())
            assert await wait_for(
                lambda: address(cache, "web.foo.com") == "10.5.0.88")
            assert await wait_for(
                lambda: read_stats(sockdir)["cache_invalidations"] >= 1)
            # api survived the churn: its next ask is a balancer hit
            m = await udp_ask(port, "api.foo.com", Type.A, qid=10)
            assert m.answers[0].address == "10.5.0.2"
            assert read_stats(sockdir)["cache_hits"] > hits0
            # web re-resolves fresh
            m = await udp_ask(port, "web.foo.com", Type.A, qid=11)
            assert m.answers[0].address == "10.5.0.88"
        finally:
            proc.kill()
            await proc.wait()
            await server.stop()
            client.close()
            writer.close()
            await zkserver.stop()

    asyncio.run(run())


def test_recursion_through_balancer_not_cached(tmp_path):
    """Cross-DC recursion behind the balancer: answers forwarded from a
    remote binder carry the do-not-store marker, so the balancer never
    caches another DC's data and a remote write shows on the next
    query."""
    from binder_torch.recursion import Recursion, StaticResolverSource
    from binder_torch.store import FakeStore

    sockdir = str(tmp_path)

    async def run():
        # the remote DC's binder: direct UDP, its own store
        rstore = FakeStore()
        rcache = MirrorCache(rstore, DOMAIN)
        rstore.put_json("/com/foo/east", {"type": "service",
                                          "service": {"port": 53}})
        rstore.put_json("/com/foo/east/web", host("10.66.0.1"))
        rstore.start_session()
        remote = BinderServer(zk_cache=rcache, dns_domain=DOMAIN,
                              datacenter_name="east", host="127.0.0.1",
                              port=0, collector=MetricsCollector())
        await remote.start()

        # the local backend recurses to it, behind the balancer
        lstore = FakeStore()
        lcache = MirrorCache(lstore, DOMAIN)
        lstore.put_json("/com/foo/web", host("10.1.0.1"))
        lstore.start_session()
        recursion = Recursion(
            zk_cache=lcache, dns_domain=DOMAIN, datacenter_name="local",
            source=StaticResolverSource(
                {"east": [f"127.0.0.1:{remote.udp_port}"]}),
            nic_provider=lambda: [])
        await recursion.wait_ready()
        local = BinderServer(zk_cache=lcache, dns_domain=DOMAIN,
                             datacenter_name="local", recursion=recursion,
                             host="127.0.0.1", port=0,
                             balancer_socket=os.path.join(sockdir, "0"),
                             collector=MetricsCollector())
        await local.start()

        proc, port = await start_balancer(sockdir)
        try:
            await asyncio.sleep(0.4)
            # a local name is cached as usual
            for qid in (1, 2):
                m = await udp_ask(port, "web.foo.com", Type.A, qid=qid)
                assert m.answers[0].address == "10.1.0.1"
            hits_after_local = read_stats(sockdir)["cache_hits"]
            assert hits_after_local == 1

            # a remote-DC name with RD: forwarded every time, never cached
            for qid in (10, 11, 12):
                m = await udp_ask(port, "web.east.foo.com", Type.A,
                                  qid=qid, rd=True)
                assert m.rcode == Rcode.NOERROR
                assert m.answers[0].address == "10.66.0.1"
            assert read_stats(sockdir)["cache_hits"] == hits_after_local

            # the remote write shows at once: nothing local cached it
            rstore.put_json("/com/foo/east/web", host("10.66.0.99"))
            m = await udp_ask(port, "web.east.foo.com", Type.A, qid=20,
                              rd=True)
            assert m.answers[0].address == "10.66.0.99"
        finally:
            proc.kill()
            await proc.wait()
            await local.stop()
            await recursion.close()
            await remote.stop()

    asyncio.run(run())
