"""TCP stream-lane parity: ``binder_torch.dns.stream`` against
``binder_tpu.dns.stream``.

The cases of the reference's ``tests/test_tcp_stream.py`` (``TestParity``,
``TestRfc7766``, ``TestWriteBufferCap``, ``TestAccountingAndCoalescing``,
``TestObservability``, ``TestChaosStreamFaults``), each run as one
scenario through a live server of each package on the Python serve lane
(the reference has no C lane in this tree).  Each scenario returns what
the reference test asserts on plus the replies' wire (ID zeroed), the
rcodes and the stream-lane counters; the two packages' observations
must be equal and meet the reference test's expectations.

The scenarios whose counters the C lane could change (it serves
complete frames in one bulk call, ``DnsServer._serve_frames_bulk``) run
once more on the port with its C lane resident, held to the reference
test's asserted values: a connection served in C is counted as one
served in Python.
"""
import asyncio
import socket
import struct
import time

import pytest

from binder_torch import server as port_server
from binder_torch.chaos import ChaosDriver as PortDriver
from binder_torch.chaos import FaultPlan as PortPlan
from binder_torch.dns import server as port_dns_server
from binder_torch.dns import wire as port_wire
from binder_torch.introspect import Introspector as PortIntrospector
from binder_torch.metrics.collector import MetricsCollector as PortMetrics
from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortCache
from binder_tpu import server as ref_server
from binder_tpu.chaos import ChaosDriver as RefDriver
from binder_tpu.chaos import FaultPlan as RefPlan
from binder_tpu.dns import server as ref_dns_server
from binder_tpu.dns import wire as ref_wire
from binder_tpu.introspect import Introspector as RefIntrospector
from binder_tpu.metrics.collector import MetricsCollector as RefMetrics
from binder_tpu.store import FakeStore as RefStore
from binder_tpu.store import MirrorCache as RefCache
from tests.test_torch_fastio import pin_python_lane
from tools.lint import validate_status_snapshot, validate_tcp_metrics

DOMAIN = "foo.com"


class Side:
    def __init__(self, **kw):
        self.__dict__.update(kw)


SIDES = {
    "port": Side(server=port_server, dns=port_dns_server, wire=port_wire,
                 metrics=PortMetrics, store=PortStore, cache=PortCache,
                 plan=PortPlan, driver=PortDriver,
                 introspector=PortIntrospector),
    "ref": Side(server=ref_server, dns=ref_dns_server, wire=ref_wire,
                metrics=RefMetrics, store=RefStore, cache=RefCache,
                plan=RefPlan, driver=RefDriver,
                introspector=RefIntrospector),
}


@pytest.fixture
def python_lane(monkeypatch):
    pin_python_lane(monkeypatch, (port_server, port_dns_server),
                    (ref_server, ref_dns_server))


def fixture_store(s):
    store = s.store()
    cache = s.cache(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "192.168.0.1"}})
    store.put_json("/com/foo/svc", {
        "type": "service",
        "service": {"srvce": "_pg", "proto": "_tcp", "port": 5432},
    })
    for i in range(40):
        store.put_json(f"/com/foo/svc/lb{i}",
                       {"type": "load_balancer",
                        "load_balancer": {"address": f"10.0.1.{i + 1}"}})
    store.start_session()
    return store, cache


async def start_server(s, cache, **kw):
    server = s.server.BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="coal",
        host="127.0.0.1", port=0, collector=s.metrics(), **kw)
    await server.start()
    return server


def query(s, name, qtype, qid, **kw) -> bytes:
    return s.wire.make_query(name, getattr(s.wire.Type, qtype), qid=qid,
                             **kw).encode()


async def udp_ask_raw(port, wire, timeout=2.0):
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


async def tcp_oneshot_raw(port, wire):
    """The accept-fast-path client: connect, one query, read, close."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(struct.pack(">H", len(wire)) + wire)
    await writer.drain()
    (ln,) = struct.unpack(">H", await reader.readexactly(2))
    data = await reader.readexactly(ln)
    writer.close()
    await writer.wait_closed()
    return data


async def read_frames(reader, n, timeout=5.0):
    out = []
    for _ in range(n):
        hdr = await asyncio.wait_for(reader.readexactly(2), timeout)
        (ln,) = struct.unpack(">H", hdr)
        out.append(await asyncio.wait_for(reader.readexactly(ln),
                                          timeout))
    return out


def norm_id(wire: bytes) -> bytes:
    return b"\x00\x00" + wire[2:]


async def wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        await asyncio.sleep(0.02)
    return pred()


def both(scenario):
    """``scenario(side)`` on both packages (Python lane); asserts equal
    observations and returns the port's."""
    got = {name: asyncio.run(scenario(s)) for name, s in SIDES.items()}
    assert got["port"] == got["ref"]
    return got["port"]


# -- TestParity ---------------------------------------------------------


PARITY_SHAPES = [("web.foo.com", "A", 1232), ("web.foo.com", "A", None),
                 ("nope.foo.com", "A", 1232),
                 ("1.0.168.192.in-addr.arpa", "PTR", 1232)]


async def parity_run(s):
    store, cache = fixture_store(s)
    server = await start_server(s, cache)
    out = []
    try:
        for name, qtype, payload in PARITY_SHAPES:
            wire = query(s, name, qtype, 11, edns_payload=payload)
            udp = await udp_ask_raw(server.udp_port, wire)
            one = await tcp_oneshot_raw(server.tcp_port, wire)
            # promoted path: the same query in the SECOND burst of a
            # pipelined connection
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", server.tcp_port)
            writer.write(struct.pack(">H", len(wire)) + wire)
            await writer.drain()
            await read_frames(reader, 1)
            writer.write(struct.pack(">H", len(wire)) + wire)
            await writer.drain()
            (piped,) = await read_frames(reader, 1)
            writer.close()
            await writer.wait_closed()
            out.append((name, norm_id(udp), norm_id(one), norm_id(piped)))
        promotions = server.engine.tcp_stats.promotions
    finally:
        await server.stop()
    return out, promotions


@pytest.mark.usefixtures("python_lane")
def test_fast_path_and_promoted_match_udp_wire():
    out, promotions = both(parity_run)
    assert promotions >= len(PARITY_SHAPES)
    for name, udp, one, piped in out:
        assert one == udp, name
        assert piped == udp, name


def test_fast_path_and_promoted_match_udp_wire_on_the_c_lane():
    out, promotions = asyncio.run(parity_run(SIDES["port"]))
    assert promotions >= len(PARITY_SHAPES)
    for name, udp, one, piped in out:
        assert one == udp, name
        assert piped == udp, name


async def tc_decline_run(s):
    store, cache = fixture_store(s)
    server = await start_server(s, cache)
    try:
        wire = query(s, "svc.foo.com", "A", 3, edns_payload=None)
        # twice over UDP: the second serve comes from the answer cache
        await udp_ask_raw(server.udp_port, wire)
        udp = await udp_ask_raw(server.udp_port, wire)
        tcp = await tcp_oneshot_raw(server.tcp_port, wire)
    finally:
        await server.stop()
    u, t = s.wire.Message.decode(udp), s.wire.Message.decode(tcp)
    return (norm_id(udp), sorted(a.address for a in t.answers),
            u.tc, len(u.answers), t.tc)


@pytest.mark.usefixtures("python_lane")
def test_tc_decline_for_cached_udp_wire():
    _, addrs, udp_tc, udp_answers, tcp_tc = both(tc_decline_run)
    assert udp_tc and udp_answers == 0
    assert not tcp_tc and len(addrs) == 40


# -- TestRfc7766 --------------------------------------------------------


async def out_of_order_run(s):
    eng = s.dns.DnsServer()

    def on_query(q):
        if q.name().startswith("slow"):
            async def later():
                await asyncio.sleep(0.15)
                q.response.answers.append(s.wire.ARecord(
                    name=q.name(), ttl=5, address="10.9.9.9"))
                q.respond()
            return later()
        q.response.answers.append(s.wire.ARecord(
            name=q.name(), ttl=5, address="10.1.1.1"))
        q.respond()
        return None

    eng.on_query = on_query
    port = await eng.listen_tcp("127.0.0.1", 0, announce=False)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    block = b""
    for qid, name in ((1, "slow.example.com"), (2, "fast1.example.com"),
                      (3, "fast2.example.com")):
        w = query(s, name, "A", qid)
        block += struct.pack(">H", len(w)) + w
    writer.write(block)
    await writer.drain()
    frames = await read_frames(reader, 3)
    writer.close()
    await writer.wait_closed()
    await eng.close()
    msgs = [s.wire.Message.decode(f) for f in frames]
    return ([m.id for m in msgs], msgs[-1].answers[0].address,
            [f[2:] for f in frames])


def test_out_of_order_responses_with_right_ids():
    ids, slow_addr, _ = both(out_of_order_run)
    # the fast responses first, the slow one last, every ID intact
    assert ids == [2, 3, 1]
    assert slow_addr == "10.9.9.9"


async def half_close_run(s):
    eng = s.dns.DnsServer()

    def on_query(q):
        async def later():
            await asyncio.sleep(0.1)
            q.response.answers.append(s.wire.ARecord(
                name=q.name(), ttl=5, address="10.2.2.2"))
            q.respond()
        return later()

    eng.on_query = on_query
    port = await eng.listen_tcp("127.0.0.1", 0, announce=False)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    w = query(s, "x.example.com", "A", 9)
    writer.write(struct.pack(">H", len(w)) + w)
    await writer.drain()
    writer.write_eof()
    (frame,) = await read_frames(reader, 1)
    eof = await asyncio.wait_for(reader.read(16), 5)
    writer.close()
    await writer.wait_closed()
    empty = await wait_until(lambda: not eng._tcp_conns)
    stats = eng.tcp_stats.snapshot()
    await eng.close()
    r = s.wire.Message.decode(frame)
    return r.id, r.answers[0].address, eof, stats, empty


def test_half_close_still_gets_owed_response():
    qid, addr, eof, stats, empty = both(half_close_run)
    assert qid == 9 and addr == "10.2.2.2"
    assert eof == b""
    assert stats["half_closes"] >= 1
    assert empty


async def mid_frame_rst_run(s):
    store, cache = fixture_store(s)
    server = await start_server(s, cache)
    try:
        loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        await loop.sock_connect(sock, ("127.0.0.1", server.tcp_port))
        # header promising 256 bytes, 3 sent: mid-frame
        await loop.sock_sendall(sock, b"\x01\x00abc")
        await asyncio.sleep(0.1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        sock.close()   # RST
        engine = server.engine
        empty = await wait_until(lambda: not engine._tcp_conns)
        r = await tcp_oneshot_raw(server.tcp_port,
                                  query(s, "web.foo.com", "A", 4))
        await wait_until(lambda: engine.tcp_stats.oneshot_closes >= 1)
        stats = engine.tcp_stats.snapshot()
    finally:
        await server.stop()
    return empty, norm_id(r), s.wire.Message.decode(r).rcode, stats


@pytest.mark.usefixtures("python_lane")
def test_mid_frame_rst_never_wedges_table():
    empty, _, rcode, stats = both(mid_frame_rst_run)
    assert empty
    assert rcode == ref_wire.Rcode.NOERROR
    assert stats["rst_drops"] >= 1


def test_mid_frame_rst_never_wedges_table_on_the_c_lane():
    empty, _, rcode, stats = asyncio.run(mid_frame_rst_run(SIDES["port"]))
    assert empty
    assert rcode == ref_wire.Rcode.NOERROR
    assert stats["rst_drops"] >= 1


async def idle_deadline_run(s):
    store, cache = fixture_store(s)
    server = await start_server(s, cache, tcp_idle_timeout=0.4)
    try:
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", server.tcp_port)
        frames = []
        for qid in range(3):
            w = query(s, "web.foo.com", "A", qid)
            writer.write(struct.pack(">H", len(w)) + w)
            await writer.drain()
            frames += await read_frames(reader, 1)
            await asyncio.sleep(0.2)   # under the deadline per frame
        t0 = asyncio.get_running_loop().time()
        eof = await asyncio.wait_for(reader.read(16), 5)
        elapsed = asyncio.get_running_loop().time() - t0
        stats = server.engine.tcp_stats.snapshot()
        writer.close()
    finally:
        await server.stop()
    return [norm_id(f) for f in frames], eof, elapsed < 2.0, stats


@pytest.mark.usefixtures("python_lane")
def test_idle_deadline_fires_under_pipelining():
    _, eof, quick, stats = both(idle_deadline_run)
    assert eof == b""
    assert quick
    assert stats["idle_timeouts"] >= 1


# -- TestWriteBufferCap -------------------------------------------------


async def slow_reader_run(s):
    store, cache = fixture_store(s)
    server = await start_server(s, cache, tcp_idle_timeout=30.0,
                                max_tcp_write_buffer=4096)
    try:
        raw = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        raw.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        raw.setblocking(False)
        loop = asyncio.get_running_loop()
        await loop.sock_connect(raw, ("127.0.0.1", server.tcp_port))
        wire = query(s, "svc.foo.com", "A", 1, edns_payload=4096)
        frame = struct.pack(">H", len(wire)) + wire
        aborted = False
        try:
            # the kernel absorbs up to ~tcp_wmem max before the
            # user-space backlog grows, so pump well past that
            for i in range(20000):
                await loop.sock_sendall(raw, frame)
                if i % 64 == 0:
                    await asyncio.sleep(0)
        except (ConnectionResetError, BrokenPipeError, OSError):
            aborted = True
        raw.close()
        drops = server.engine.tcp_stats.slow_reader_drops
        exposed = [line for line in server.collector.expose().splitlines()
                   if line.startswith("binder_tcp_slow_reader_drops")]
        # other clients are unaffected
        r = await tcp_oneshot_raw(server.tcp_port,
                                  query(s, "web.foo.com", "A", 2))
    finally:
        await server.stop()
    return aborted, drops, exposed, norm_id(r)


def slow_reader_expectations(aborted, drops, exposed, reply):
    assert aborted
    assert drops >= 1
    assert exposed and float(exposed[0].split()[-1]) >= 1.0
    assert ref_wire.Message.decode(reply).rcode == ref_wire.Rcode.NOERROR


@pytest.mark.usefixtures("python_lane")
def test_slow_reader_disconnected_at_cap_with_metric():
    got = {name: asyncio.run(slow_reader_run(s))
           for name, s in SIDES.items()}
    for aborted, drops, exposed, reply in got.values():
        slow_reader_expectations(aborted, drops, exposed, reply)
    # how much the client pumped before the cap is the kernel's timing:
    # the outcome, the served reply and the exposition's shape are equal
    assert got["port"][0] == got["ref"][0]
    assert got["port"][3] == got["ref"][3]
    assert [line.split()[0] for line in got["port"][2]] == \
        [line.split()[0] for line in got["ref"][2]]


def test_slow_reader_disconnected_at_cap_on_the_c_lane():
    slow_reader_expectations(*asyncio.run(slow_reader_run(SIDES["port"])))


# -- TestAccountingAndCoalescing ----------------------------------------


async def accounting_run(s):
    store, cache = fixture_store(s)
    server = await start_server(s, cache)
    engine = server.engine
    stats = engine.tcp_stats
    try:
        wire = query(s, "web.foo.com", "A", 1)
        one = await tcp_oneshot_raw(server.tcp_port, wire)
        await wait_until(lambda: stats.oneshot_closes >= 1)
        after_oneshot = stats.snapshot()
        # now a client that keeps sending: the second burst promotes
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", server.tcp_port)
        writer.write(struct.pack(">H", len(wire)) + wire)
        await writer.drain()
        await read_frames(reader, 1)
        writer.write(struct.pack(">H", len(wire)) + wire)
        await writer.drain()
        await read_frames(reader, 1)
        writer.close()
        await writer.wait_closed()
        after_piped = stats.snapshot()
    finally:
        await server.stop()
    return norm_id(one), after_oneshot, after_piped


def accounting_expectations(after_oneshot, after_piped):
    assert after_oneshot["accepts"] >= 1
    assert after_oneshot["fast_serves"] >= 1
    assert after_oneshot["promotions"] == 0
    assert after_oneshot["oneshot_closes"] >= 1
    assert after_piped["promotions"] == 1


@pytest.mark.usefixtures("python_lane")
def test_oneshot_vs_promotion_accounting():
    _, after_oneshot, after_piped = both(accounting_run)
    accounting_expectations(after_oneshot, after_piped)


def test_oneshot_vs_promotion_accounting_on_the_c_lane():
    """The C lane serves these frames in one bulk call; the stream lane
    still counts the serve, the close and the promotion."""
    s = SIDES["port"]
    assert s.server._fastio is not None
    _, after_oneshot, after_piped = asyncio.run(accounting_run(s))
    accounting_expectations(after_oneshot, after_piped)


async def coalesce_run(s):
    store, cache = fixture_store(s)
    server = await start_server(s, cache)
    try:
        reader, writer = await asyncio.open_connection(
            "127.0.0.1", server.tcp_port)
        block = b""
        for qid in range(1, 6):
            w = query(s, "web.foo.com", "A", qid)
            block += struct.pack(">H", len(w)) + w
        writer.write(block)
        await writer.drain()
        frames = await read_frames(reader, 5)
        stats = server.engine.tcp_stats.snapshot()
        writer.close()
        await writer.wait_closed()
    finally:
        await server.stop()
    return (sorted(s.wire.Message.decode(f).id for f in frames),
            sorted(norm_id(f) for f in frames), stats)


@pytest.mark.usefixtures("python_lane")
def test_pipelined_burst_coalesces_into_one_write():
    ids, _, stats = both(coalesce_run)
    assert ids == [1, 2, 3, 4, 5]
    assert stats["coalesced_writes"] >= 1
    assert stats["coalesced_frames"] >= 5


def test_pipelined_burst_coalesces_on_the_c_lane():
    ids, _, stats = asyncio.run(coalesce_run(SIDES["port"]))
    assert ids == [1, 2, 3, 4, 5]
    assert stats["coalesced_writes"] >= 1
    assert stats["coalesced_frames"] >= 5


# -- TestObservability --------------------------------------------------


async def observability_run(s):
    store, cache = fixture_store(s)
    server = await start_server(s, cache)
    try:
        await tcp_oneshot_raw(server.tcp_port,
                              query(s, "web.foo.com", "A", 1))
        text = server.collector.expose()
        snap = s.introspector(server=server).snapshot()
    finally:
        await server.stop()
    families = sorted({line.split()[2] for line in text.splitlines()
                       if line.startswith("# TYPE binder_tcp_")})
    tcp = snap["tcp"]
    return (validate_tcp_metrics(text), families,
            validate_status_snapshot(snap), sorted(tcp),
            tcp["accepts"] >= 1, tcp["max_conns"],
            tcp["max_write_buffer"])


@pytest.mark.usefixtures("python_lane")
def test_tcp_metrics_and_status_section():
    errs, families, snap_errs, keys, accepted, max_conns, max_wbuf = \
        both(observability_run)
    assert errs == [] and families
    assert snap_errs == []
    assert accepted
    assert max_conns == ref_dns_server.DnsServer.MAX_TCP_CONNS
    assert max_wbuf == ref_dns_server.DnsServer.MAX_TCP_WRITE_BUFFER


def test_tcp_metrics_and_status_section_on_the_c_lane():
    errs, families, snap_errs, _, accepted, _, _ = asyncio.run(
        observability_run(SIDES["port"]))
    assert errs == [] and families and snap_errs == [] and accepted


# -- TestChaosStreamFaults ----------------------------------------------


def test_dsl_parses_stream_actions():
    text = """
        at 0.0 tcp-slow-reader conns=2 queries=64 hold_ms=100
        at 0.1 tcp-half-close queries=2
        at 0.2 tcp-rst conns=1
    """
    timelines = {name: s.plan.parse(text).timeline
                 for name, s in SIDES.items()}
    assert timelines["port"] == timelines["ref"]
    assert [a for _, a, _ in timelines["port"]] == [
        "tcp-slow-reader", "tcp-half-close", "tcp-rst"]


async def driver_soak_run(s):
    store, cache = fixture_store(s)
    server = await start_server(s, cache)
    try:
        plan = s.plan.parse(
            "at 0.0 tcp-slow-reader conns=1 queries=32 hold_ms=100;"
            "at 0.05 tcp-half-close queries=2;"
            "at 0.1 tcp-rst conns=2")
        driver = s.driver(plan, store=store, tcp_target=(
            "127.0.0.1", server.tcp_port, "web.foo.com"))
        await driver.run()
        await driver.stream_quiesce()
        engine = server.engine
        empty = await wait_until(lambda: not engine._tcp_conns)
        r = await tcp_oneshot_raw(server.tcp_port,
                                  query(s, "web.foo.com", "A", 7))
        stats = engine.tcp_stats
        applied = [a for _, a in driver.applied]
        out = (empty, norm_id(r), stats.rst_drops >= 1,
               stats.accepts >= 3, applied)
    finally:
        await server.stop()
    return out


@pytest.mark.usefixtures("python_lane")
def test_driver_soaks_live_server():
    empty, reply, rst, accepts, applied = both(driver_soak_run)
    assert empty
    assert ref_wire.Message.decode(reply).rcode == ref_wire.Rcode.NOERROR
    # the torn-frame RSTs were shed, not wedged
    assert rst and accepts
    assert applied == ["tcp-slow-reader", "tcp-half-close", "tcp-rst"]


def test_driver_without_target_skips():
    for s in SIDES.values():
        drv = s.driver(s.plan())
        # must not raise (and must not wedge waiting for a loop)
        drv.apply("tcp-rst", {})
        assert "tcp-rst" in [a for _, a in drv.applied]
