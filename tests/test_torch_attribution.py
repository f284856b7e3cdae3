"""Query-attribution parity: trace IDs, phase stamps and
``binder_query_stage_seconds`` of ``binder_torch`` against ``binder_tpu``.

The cases of the reference's ``tests/test_attribution.py``: each runs as
one scenario through a live server of each package on the Python serve
lane (the reference has no C lane in this tree; a query the C lane
serves never reaches the probes or the stage histogram).  A scenario
returns the probe events' shapes (stage names, trace-ID uniqueness and
correlation), the replies' wire (ID zeroed) and the stage and request
counters; the two packages' observations must be equal and meet the
reference test's expectations.  Stage durations are clock readings and
are compared only for sign.

``TestBalancerStageCounters`` needs ``mbalancer``, which only the port
builds here (``fastio_build.build("mbalancer")``): it runs on the port
alone and is held to the reference test's asserted values.
"""
import asyncio
import json
import os
import socket
import struct
import tempfile
import threading

import pytest

from binder_torch import server as port_server
from binder_torch.dns import query as port_query
from binder_torch.dns import server as port_dns_server
from binder_torch.dns import wire as port_wire
from binder_torch.metrics.collector import MetricsCollector as PortMetrics
from binder_torch.recursion import Recursion as PortRecursion
from binder_torch.recursion import StaticResolverSource as PortStatic
from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortCache
from binder_torch.utils.probes import ProbeProvider as PortProbes
from binder_tpu import server as ref_server
from binder_tpu.dns import query as ref_query
from binder_tpu.dns import server as ref_dns_server
from binder_tpu.dns import wire as ref_wire
from binder_tpu.metrics.collector import MetricsCollector as RefMetrics
from binder_tpu.recursion import Recursion as RefRecursion
from binder_tpu.recursion import StaticResolverSource as RefStatic
from binder_tpu.store import FakeStore as RefStore
from binder_tpu.store import MirrorCache as RefCache
from binder_tpu.utils.probes import ProbeProvider as RefProbes
from tests.test_torch_fastio import pin_python_lane
from tools.lint import validate_exposition

DOMAIN = "foo.com"


class Side:
    def __init__(self, **kw):
        self.__dict__.update(kw)


SIDES = {
    "port": Side(server=port_server, query=port_query, wire=port_wire,
                 metrics=PortMetrics, store=PortStore, cache=PortCache,
                 probes=PortProbes, recursion=PortRecursion,
                 static=PortStatic),
    "ref": Side(server=ref_server, query=ref_query, wire=ref_wire,
                metrics=RefMetrics, store=RefStore, cache=RefCache,
                probes=RefProbes, recursion=RefRecursion,
                static=RefStatic),
}


@pytest.fixture
def python_lane(monkeypatch):
    pin_python_lane(monkeypatch, (port_server, port_dns_server),
                    (ref_server, ref_dns_server))


def both(scenario):
    """``scenario(side)`` on both packages; asserts equal observations
    and returns the port's."""
    got = {name: asyncio.run(scenario(s)) for name, s in SIDES.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def make_fixture(s):
    store = s.store()
    cache = s.cache(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "10.0.0.1"}})
    store.start_session()
    return cache


async def start_server(s, **kw):
    """A server with a subscribed probe sink; returns (server, events)
    where events collects (probe name, args)."""
    provider = s.probes("binder", backend="off")
    events = []
    provider.subscribe(lambda name, args: events.append((name, args)))
    server = s.server.BinderServer(
        zk_cache=kw.pop("zk_cache", None) or make_fixture(s),
        dns_domain=DOMAIN, datacenter_name="dc0", host="127.0.0.1",
        port=0, collector=s.metrics(), probes=provider, **kw)
    await server.start()
    return server, events


async def udp_ask(s, port, name, qtype, qid=1, rd=False, timeout=5.0):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class Proto(asyncio.DatagramProtocol):
        def connection_made(self, transport):
            transport.sendto(s.wire.make_query(name, qtype, qid=qid,
                                               rd=rd).encode())

        def datagram_received(self, data, addr):
            if not fut.done():
                fut.set_result(data)

    transport, _ = await loop.create_datagram_endpoint(
        Proto, remote_addr=("127.0.0.1", port))
    try:
        return await asyncio.wait_for(fut, timeout)
    finally:
        transport.close()


async def tcp_ask(s, port, name, qtype, qid=2):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    wire = s.wire.make_query(name, qtype, qid=qid).encode()
    writer.write(struct.pack(">H", len(wire)) + wire)
    await writer.drain()
    (ln,) = struct.unpack(">H", await asyncio.wait_for(
        reader.readexactly(2), 5))
    data = await reader.readexactly(ln)
    writer.close()
    await writer.wait_closed()
    return data


def done_events(events):
    return [args for name, args in events if name == "op-req-done"]


def stage_shapes(dones):
    """Each done event's stage names, and whether every phase is >= 0
    (the monotonic-clock cursor can never give a negative delta)."""
    return [(sorted(d["stages"]), all(v >= 0 for v in d["stages"].values()))
            for d in dones]


# -- TestTraceIds -------------------------------------------------------


@pytest.mark.parametrize("side", sorted(SIDES))
def test_thread_concurrent_allocation_unique(side):
    """8 threads allocating 2,000 IDs each never collide; every ID is
    "<pid hex>-<seq hex>"."""
    next_trace_id = SIDES[side].query.next_trace_id
    per_thread = 2000
    out = [None] * 8

    def alloc(i):
        out[i] = [next_trace_id() for _ in range(per_thread)]

    threads = [threading.Thread(target=alloc, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    all_ids = [tid for ids in out for tid in ids]
    assert len(set(all_ids)) == len(all_ids)
    pid_hex = format(os.getpid(), "x")
    assert all(tid.startswith(pid_hex + "-") for tid in all_ids)


@pytest.mark.usefixtures("python_lane")
def test_concurrent_queries_unique_trace_ids():
    """Overlapping in-flight queries each get their own trace ID, and
    start/done probe events correlate by it."""
    n = 50

    async def scenario(s):
        server, events = await start_server(s, query_log=False)
        try:
            replies = await asyncio.gather(*[
                udp_ask(s, server.udp_port, "web.foo.com", s.wire.Type.A,
                        qid=i + 1) for i in range(n)])
        finally:
            await server.stop()
        starts = [a for nm, a in events if nm == "op-req-start"]
        dones = done_events(events)
        start_traces = {a["trace"] for a in starts}
        return (len(starts), len(dones), len(start_traces),
                start_traces == {a["trace"] for a in dones},
                sorted(r[2:] for r in replies))

    starts, dones, unique, correlated, _ = both(scenario)
    assert starts == dones == unique == n
    assert correlated


# -- TestPhaseStamps ----------------------------------------------------


@pytest.mark.usefixtures("python_lane")
def test_miss_then_hit_stamps():
    async def scenario(s):
        server, events = await start_server(s, query_log=False)
        try:
            for qid in (1, 2):
                await udp_ask(s, server.udp_port, "web.foo.com",
                              s.wire.Type.A, qid=qid)
        finally:
            await server.stop()
        return stage_shapes(done_events(events))

    (first, first_ok), (second, second_ok) = both(scenario)
    assert first_ok and second_ok
    # the first query: the whole resolve path through the store
    assert {"store-lookup", "log-after"} <= set(first)
    # the repeat: a whole-hit stamp from the answer cache
    assert {"cache-hit", "log-after"} <= set(second)
    assert "store-lookup" not in second


@pytest.mark.usefixtures("python_lane")
def test_tcp_stamps():
    async def scenario(s):
        server, events = await start_server(s, query_log=False)
        try:
            reply = await tcp_ask(s, server.tcp_port, "web.foo.com",
                                  s.wire.Type.A)
        finally:
            await server.stop()
        return reply[2:], stage_shapes(done_events(events))

    reply, shapes = both(scenario)
    assert ref_wire.Message.decode(b"\x00\x00" + reply).answers
    ((stages, ok),) = shapes
    assert ok and {"store-lookup", "log-after"} <= set(stages)


@pytest.mark.usefixtures("python_lane")
def test_recursion_fast_path_stamps():
    """The cross-DC forward decomposes into dispatch / upstream RTT /
    event-loop wait / splice: the first query cold-starts the pooled
    upstream port on the slow path ("upstream"), the repeat takes the
    zero-coroutine fast path."""
    async def scenario(s):
        remote_store = s.store()
        remote_cache = s.cache(remote_store, DOMAIN)
        remote_store.put_json("/com/foo/east",
                              {"type": "service", "service": {"port": 53}})
        remote_store.put_json(
            "/com/foo/east/web",
            {"type": "host", "host": {"address": "10.77.0.1", "ttl": 44}})
        remote_store.start_session()
        remote = s.server.BinderServer(
            zk_cache=remote_cache, dns_domain=DOMAIN,
            datacenter_name="east", host="127.0.0.1", port=0,
            collector=s.metrics())
        await remote.start()
        local_store = s.store()
        local_cache = s.cache(local_store, DOMAIN)
        local_store.start_session()
        recursion = s.recursion(
            zk_cache=local_cache, dns_domain=DOMAIN,
            datacenter_name="local",
            source=s.static({"east": [f"127.0.0.1:{remote.udp_port}"]}),
            nic_provider=lambda: [])
        await recursion.wait_ready()
        server, events = await start_server(
            s, zk_cache=local_cache, recursion=recursion, query_log=False)
        try:
            answered = []
            for qid in (1, 2):
                r = await udp_ask(s, server.udp_port, "web.east.foo.com",
                                  s.wire.Type.A, rd=True, qid=qid)
                answered.append(bool(s.wire.Message.decode(r).answers))
        finally:
            await server.stop()
            await remote.stop()
        return answered, stage_shapes(done_events(events))

    answered, shapes = both(scenario)
    assert answered == [True, True]
    (first, first_ok), (second, second_ok) = shapes
    assert first_ok and second_ok
    assert {"store-lookup", "dispatch", "upstream", "log-after"} \
        <= set(first)
    assert {"store-lookup", "dispatch", "await", "upstream-rtt",
            "loop-wait", "log-after"} <= set(second)
    assert "splice" in second or "rebuild" in second


# -- TestStageMetrics ---------------------------------------------------


@pytest.mark.usefixtures("python_lane")
def test_stage_counts_match_requests_completed():
    """Every after-hook observation lands in both
    ``binder_requests_completed`` and the log-after stage cell."""
    n = 7

    async def scenario(s):
        server, _ = await start_server(s, query_log=False)
        try:
            for i in range(n):
                # distinct unknown names: no answer-cache reuse
                await udp_ask(s, server.udp_port, f"m{i}.foo.com",
                              s.wire.Type.A, qid=i + 1)
        finally:
            await server.stop()
        counter = server.collector.get(s.server.METRIC_REQUEST_COUNTER)
        hist = server.collector.get(s.server.METRIC_STAGE_HISTOGRAM)
        completed = sum(counter._values.values())
        cells = {key: sum(hist._counts[key]) for key in hist._counts}
        return completed, hist.count({"stage": "log-after"}), \
            sorted(cells.items())

    completed, log_after, cells = both(scenario)
    assert completed == n
    assert log_after == n
    # no stage can have observed more queries than completed
    assert all(count <= completed for _, count in cells)


def test_stage_counts_match_requests_completed_on_the_c_lane():
    """With the C lane resident, queries it never sees neither complete
    in Python nor stamp: the two totals still agree."""
    async def scenario(s):
        server, _ = await start_server(s, query_log=False)
        try:
            for i in range(7):
                await udp_ask(s, server.udp_port, f"m{i}.foo.com",
                              s.wire.Type.A, qid=i + 1)
            for qid in range(3):
                await udp_ask(s, server.udp_port, "web.foo.com",
                              s.wire.Type.A, qid=100 + qid)
        finally:
            await server.stop()
        server.collector.expose()
        counter = server.collector.get(s.server.METRIC_REQUEST_COUNTER)
        hist = server.collector.get(s.server.METRIC_STAGE_HISTOGRAM)
        return (sum(counter._values.values()),
                hist.count({"stage": "log-after"}))

    s = SIDES["port"]
    assert s.server._fastio is not None
    completed, log_after = asyncio.run(scenario(s))
    assert completed >= 7
    assert log_after <= completed


@pytest.mark.usefixtures("python_lane")
def test_exposition_validates():
    """The whole scrape, the per-stage histogram included, passes the
    Prometheus text-format validator, and both packages expose the same
    families."""
    async def scenario(s):
        server, _ = await start_server(s, query_log=False)
        try:
            await udp_ask(s, server.udp_port, "web.foo.com", s.wire.Type.A)
            await udp_ask(s, server.udp_port, "web.foo.com", s.wire.Type.A,
                          qid=2)
            await tcp_ask(s, server.tcp_port, "web.foo.com",
                          s.wire.Type.SRV)
        finally:
            await server.stop()
        text = server.collector.expose()
        families = sorted({line.split()[2] for line in text.splitlines()
                           if line.startswith("# TYPE ")})
        return (s.server.METRIC_STAGE_HISTOGRAM + "_bucket" in text,
                validate_exposition(text), families)

    has_stage, errors, _ = both(scenario)
    assert has_stage
    assert not errors, "\n".join(errors)


# -- TestBalancerStageCounters (port-built mbalancer) ---------------------


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


def test_balancer_stats_socket_stage_cycles_consistent():
    """The stats dump carries the four stage cells, the calibrated TSC
    rate, and counts consistent with the balancer's own query counters
    and with a port backend's ``binder_requests_completed``."""
    from binder_torch import fastio_build
    balancer, _ = fastio_build.build("mbalancer")
    s = SIDES["port"]
    n = 20

    async def run(sockdir):
        backend = s.server.BinderServer(
            zk_cache=make_fixture(s), dns_domain=DOMAIN,
            datacenter_name="dc0", host="127.0.0.1", port=0,
            balancer_socket=os.path.join(sockdir, "0"),
            collector=s.metrics(), query_log=False)
        await backend.start()
        # -D pins the relay lane: the probe/relay stage counters are
        # what this asserts, and direct return bypasses them
        proc = await asyncio.create_subprocess_exec(
            balancer, "-d", sockdir, "-p", "0", "-b", "127.0.0.1",
            "-s", "150", "-c", "60000", "-D",
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL)
        try:
            line = await asyncio.wait_for(proc.stdout.readline(), 30)
            assert line.startswith(b"PORT "), line
            port = int(line.split()[1])
            await asyncio.sleep(0.5)   # backend scan + connect
            for i in range(n):
                # distinct names: every query a balancer-cache miss
                await udp_ask(s, port, f"c{i}.foo.com", s.wire.Type.A,
                              qid=i + 1)
            stats = read_stats(sockdir)
        finally:
            proc.terminate()
            await proc.wait()
            await backend.stop()
        # scrape after the queries: expose() folds natively served counts
        backend.collector.expose()
        counter = backend.collector.get(s.server.METRIC_REQUEST_COUNTER)
        return stats, sum(counter._values.values())

    with tempfile.TemporaryDirectory() as sockdir:
        stats, backend_completed = asyncio.run(run(sockdir))

    assert stats["udp_queries"] == n
    assert backend_completed == n
    cells = stats["stage_cycles"]
    assert set(cells) == {"frame-parse", "cache-probe", "backend-write",
                          "reply-relay"}
    for name, cell in cells.items():
        assert cell["cycles"] >= 0 and cell["ops"] >= 0, name
    assert cells["cache-probe"]["ops"] >= n
    assert cells["backend-write"]["ops"] >= n
    assert cells["reply-relay"]["ops"] >= n
    assert stats["cycles_per_us"] > 0
    served = stats.get("cache_hits", 0) + stats.get("cache_misses", 0) \
        + stats.get("uncacheable", 0)
    assert served == n
