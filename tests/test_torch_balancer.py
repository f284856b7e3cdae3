"""The port's backends behind ``mbalancer``, the balancer the port builds.

Cases drawn from ``tests/test_balancer.py`` with port ``BinderServer``
backends (on the port's C lane) and the ``mbalancer`` binary that
``binder_torch.fastio_build`` compiles from ``native/balancer/`` into
``binder_torch/_build/``: answers over UDP and TCP through the
balancer; direct return (the backend answers UDP clients on the socket
the balancer passed it, byte-identical to asking the backend itself,
with its C lane serving the hits); failover when the serving backend
leaves; a late backend found by the directory scan.  The balancer
phase of ``chip_smoke.py`` runs here at a small zone.
"""
import asyncio
import json
import os
import socket
import struct
import subprocess
import sys

from binder_torch import _binderfastio, fastio_build
from binder_torch.dns import Message, Rcode, Type, make_query
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache

DOMAIN = "foo.com"


def make_fixture(tag):
    store = FakeStore()
    cache = MirrorCache(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": f"10.42.0.{tag}"}})
    # svc: 40 addresses, more than 512 bytes without EDNS -> TC=1 on UDP
    store.put_json("/com/foo/svc", {
        "type": "service",
        "service": {"srvce": "_pg", "proto": "_tcp", "port": 5432}})
    for i in range(40):
        store.put_json(f"/com/foo/svc/lb{i}",
                       {"type": "load_balancer",
                        "load_balancer": {"address": f"10.77.0.{i + 1}"}})
    store.start_session()
    return cache


async def start_backend(sockdir, instance, tag):
    server = BinderServer(zk_cache=make_fixture(tag), dns_domain=DOMAIN,
                          datacenter_name="dc0", host="127.0.0.1", port=0,
                          balancer_socket=os.path.join(sockdir,
                                                       str(instance)),
                          collector=MetricsCollector(),
                          # the C lane stands down for per-query logs
                          # without a JSON log sink
                          query_log=False)
    await server.start()
    assert server._fastpath is not None
    return server


async def start_balancer(sockdir):
    binary, _ = fastio_build.build("mbalancer")
    proc = await asyncio.create_subprocess_exec(
        binary, "-d", sockdir, "-p", "0", "-b", "127.0.0.1", "-s", "150",
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.DEVNULL)
    line = await asyncio.wait_for(proc.stdout.readline(), 30)
    assert line.startswith(b"PORT "), line
    return proc, int(line.split()[1])


async def raw_udp_ask(port, wire, timeout=5.0):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class Proto(asyncio.DatagramProtocol):
        def connection_made(self, transport):
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


async def raw_tcp_ask(port, wire, timeout=5.0):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(struct.pack(">H", len(wire)) + wire)
        await writer.drain()
        (ln,) = struct.unpack(">H", await asyncio.wait_for(
            reader.readexactly(2), timeout))
        return await reader.readexactly(ln)
    finally:
        writer.close()
        await writer.wait_closed()


def read_stats(sockdir):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.settimeout(2)
    c.connect(os.path.join(sockdir, ".balancer.stats"))
    buf = b""
    while True:
        chunk = c.recv(4096)
        if not chunk:
            break
        buf += chunk
    c.close()
    return json.loads(buf)


async def wait_backends(sockdir, n, direct=False, timeout=10.0):
    """The balancer's stats once ``n`` backends are healthy (and, with
    ``direct``, have all adopted the passed client socket)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        try:
            stats = read_stats(sockdir)
            up = [b for b in stats["backends"] if b["healthy"]
                  and (b.get("direct") or not direct)]
            if len(up) == n:
                return stats
        except (OSError, ValueError):
            pass
        assert loop.time() < deadline, "backends not adopted"
        await asyncio.sleep(0.1)


def test_udp_and_tcp_through_the_balancer(tmp_path):
    sockdir = str(tmp_path)

    async def run():
        b1 = await start_backend(sockdir, 5301, 1)
        b2 = await start_backend(sockdir, 5302, 2)
        proc, port = await start_balancer(sockdir)
        try:
            await wait_backends(sockdir, 2)
            q = make_query("web.foo.com", Type.A, qid=7).encode()
            udp = Message.decode(await raw_udp_ask(port, q))
            tcp = Message.decode(await raw_tcp_ask(port, q))
            stats = read_stats(sockdir)
        finally:
            proc.kill()
            await proc.wait()
            await b1.stop()
            await b2.stop()
        return udp, tcp, stats

    udp, tcp, stats = asyncio.run(run())
    for m in (udp, tcp):
        assert m.rcode == Rcode.NOERROR and m.id == 7
        assert m.answers[0].address in ("10.42.0.1", "10.42.0.2")
    assert stats["udp_queries"] == 1 and stats["tcp_queries"] == 1
    assert len(stats["backends"]) == 2


def test_direct_return_byte_identical_to_the_backend(tmp_path):
    sockdir = str(tmp_path)

    async def run():
        backend = await start_backend(sockdir, 5301, 7)
        proc, fport = await start_balancer(sockdir)
        try:
            await wait_backends(sockdir, 1, direct=True)
            got = []
            for k, (name, edns) in enumerate((("web.foo.com", 1232),
                                              ("svc.foo.com", None))):
                q = make_query(name, Type.A, qid=41 + k,
                               edns_payload=edns).encode()
                got.append((await raw_udp_ask(fport, q),
                            await raw_udp_ask(backend.udp_port, q)))
            # repeats: the balancer's own cache (or the backend's C
            # lane) answers; every reply stays the backend's bytes
            q = make_query("web.foo.com", Type.A, qid=43).encode()
            for _ in range(5):
                got.append((await raw_udp_ask(fport, q),
                            await raw_udp_ask(backend.udp_port, q)))
            q = make_query("web.foo.com", Type.A, qid=44).encode()
            tcp = (await raw_tcp_ask(fport, q),
                   await raw_tcp_ask(backend.tcp_port, q))
            stats = read_stats(sockdir)
            native = _binderfastio.fastpath_stats(backend._fastpath)
        finally:
            proc.kill()
            await proc.wait()
            await backend.stop()
        return got, tcp, stats, native

    got, tcp, stats, native = asyncio.run(run())
    for via_balancer, direct in got + [tcp]:
        assert via_balancer == direct
    web, svc = (Message.decode(g[0]) for g in got[:2])
    assert not web.tc and web.answers[0].address == "10.42.0.7"
    assert svc.tc and not svc.answers
    # the answer came back over the passed socket, not the relay
    assert stats["fd_passes"] >= 1 and stats["direct_forwards"] >= 1
    assert stats["backends"][0]["direct"] is True
    assert native["zone_hits"] + native["hits"] > 0


def test_failover_when_the_backend_leaves(tmp_path):
    sockdir = str(tmp_path)

    async def run():
        b1 = await start_backend(sockdir, 5301, 1)
        b2 = await start_backend(sockdir, 5302, 2)
        proc, port = await start_balancer(sockdir)
        try:
            await wait_backends(sockdir, 2)
            q = make_query("web.foo.com", Type.A, qid=1).encode()
            first = Message.decode(await raw_udp_ask(port, q))
            served_by = first.answers[0].address
            # the serving backend leaves: SIGTERM semantics, unlink the
            # socket and stop serving
            leaving = b1 if served_by.endswith(".1") else b2
            await leaving.stop()
            os.unlink(leaving.balancer_socket)
            await wait_backends(sockdir, 1)
            q = make_query("web.foo.com", Type.A, qid=2).encode()
            second = Message.decode(await raw_udp_ask(port, q))
        finally:
            proc.kill()
            await proc.wait()
            for b in (b1, b2):
                await b.stop()
        return served_by, second

    served_by, second = asyncio.run(run())
    assert second.rcode == Rcode.NOERROR
    assert second.answers[0].address != served_by


def test_late_backend_is_discovered(tmp_path):
    sockdir = str(tmp_path)

    async def run():
        proc, port = await start_balancer(sockdir)
        backend = None
        try:
            before = await wait_backends(sockdir, 0)
            backend = await start_backend(sockdir, 5301, 3)
            await wait_backends(sockdir, 1, direct=True)
            q = make_query("web.foo.com", Type.A, qid=5).encode()
            reply = Message.decode(await raw_udp_ask(port, q))
        finally:
            proc.kill()
            await proc.wait()
            if backend is not None:
                await backend.stop()
        return before, reply

    before, reply = asyncio.run(run())
    assert before["backends"] == []
    assert reply.rcode == Rcode.NOERROR
    assert reply.answers[0].address == "10.42.0.3"


BALANCER_SMALL = """
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
native = {{}}
lat = chip_smoke.balancer_phase(hosts=2000, n_udp=2000, native=native)
print(json.dumps({{"answered": len(lat), "native": native,
                  "left": chip_smoke.descendants(os.getpid())}}))
"""


def test_chip_smoke_balancer_phase_on_the_cpu():
    # the smoke's balancer phase at a small zone: 4 backends behind
    # mbalancer, 16 client addresses, direct return, SIGTERM to all
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", BALANCER_SMALL.format(root=root)],
        cwd=root, capture_output=True, timeout=300)
    lines = out.stdout.decode().splitlines()
    assert out.returncode == 0, (lines[-5:], out.stderr.decode()[-3000:])
    report = json.loads(next(x for x in lines
                             if x.startswith('{"balancer"')))["balancer"]
    assert report["errors"] == 0 and report["left_after_sigterm"] == []
    assert report["udp_answered"] == 2000
    assert min(report["forwarded"]) > 0 and len(report["forwarded"]) == 4
    assert report["mbalancer"]["fd_passes"] >= 4
    assert report["sigterm_rc"] == [0, 0, 0, 0, -15]
    got = json.loads(lines[-1])
    assert got["answered"] == 2000 and got["left"] == []
    assert all(c["c_cache_hits"] + c["c_zone_hits"] > 0
               for c in got["native"]["balancer"])
