"""The port's native query-log ring, held to the reference's contract.

The seven scenarios of ``tests/test_log_ring.py`` on port modules and
the port's build of ``native/fastio/`` (``binder_torch.fastio_build``):
with a JSON logger attached and the query log on, the C lane serves
(zone table and answer cache) and every serve writes one bunyan line
to the same stream as the Python logger, in the shape the Python path
gives the same event; TCP serves log through the same ring; without a
JSON stream the C lane stands down as before; logging does not change
an answer.

Then the two packages side by side: each package's ``main`` on the C
lane (``LANE_MAIN``; the reference gets the port's build of the same
sources) in a process of its own, with the query log on as shipped.
The same queries over UDP and TCP must log the same ``DNS query``
lines, field for field, but for the process's identity, the clock and
the client's port number.
"""
import asyncio
import io
import json
import logging
import os
import re
import socket
import struct
import subprocess
import sys
import time

import pytest

from binder_torch import _binderfastio as fastio
from binder_torch.dns import Message, Rcode, Type, make_query
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache
from binder_torch.utils.jsonlog import make_logger
from tests.test_torch_fastio import LANE_MAIN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = "foo.com"


def fixture_store():
    store = FakeStore()
    cache = MirrorCache(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "192.168.0.1"}})
    store.put_json("/com/foo/svc", {
        "type": "service",
        "service": {"srvce": "_pg", "proto": "_tcp", "port": 5432},
    })
    for i in range(3):
        store.put_json(f"/com/foo/svc/lb{i}",
                       {"type": "load_balancer",
                        "load_balancer": {"address": f"10.0.1.{i + 1}"}})
    store.start_session()
    return store, cache


async def start_logged_server(cache, stream, **kw):
    log = make_logger("binder-logring-test", stream=stream)
    server = BinderServer(zk_cache=cache, dns_domain=DOMAIN,
                          datacenter_name="coal", host="127.0.0.1",
                          port=0, collector=MetricsCollector(),
                          log=log, query_log=True, **kw)
    await server.start()
    return server


async def udp_ask(port, name, qtype, qid=4242, payload=1232):
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    class Proto(asyncio.DatagramProtocol):
        def connection_made(self, transport):
            transport.sendto(make_query(name, qtype, qid=qid,
                                        edns_payload=payload).encode())

        def datagram_received(self, data, addr):
            if not fut.done():
                fut.set_result(data)

    transport, _ = await loop.create_datagram_endpoint(
        Proto, remote_addr=("127.0.0.1", port))
    try:
        return Message.decode(await asyncio.wait_for(fut, 2.0))
    finally:
        transport.close()


async def tcp_ask(port, name, qtype, qid=7, edns_payload=1232):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    wire = make_query(name, qtype, qid=qid,
                      edns_payload=edns_payload).encode()
    writer.write(struct.pack(">H", len(wire)) + wire)
    await writer.drain()
    (length,) = struct.unpack(">H", await reader.readexactly(2))
    data = await reader.readexactly(length)
    writer.close()
    await writer.wait_closed()
    return Message.decode(data)


def log_lines(server, stream):
    server._drain_native_log()
    return [json.loads(ln) for ln in stream.getvalue().splitlines()]


def test_ring_armed_with_json_logger():
    async def run():
        _, cache = fixture_store()
        server = await start_logged_server(cache, io.StringIO())
        try:
            assert server._log_ring
            assert server._fastpath_active()
        finally:
            await server.stop()

    asyncio.run(run())


def test_zone_serve_logs_resolve_shape():
    """Cold A query in the logged posture: served natively from the
    precompiled zone and logged with the resolve-shape line."""
    async def run():
        _, cache = fixture_store()
        stream = io.StringIO()
        server = await start_logged_server(cache, stream)
        try:
            r1 = await udp_ask(server.udp_port, "web.foo.com", Type.A,
                               qid=100)
            r2 = await udp_ask(server.udp_port, "web.foo.com", Type.A,
                               qid=101)
            assert r1.rcode == r2.rcode == Rcode.NOERROR
            assert r1.answers[0].address == "192.168.0.1"
            stats = fastio.fastpath_stats(server._fastpath)
            assert stats["zone_hits"] >= 2      # served natively
            assert stats["log_lines"] >= 2      # ...and logged
            qlines = [ln for ln in log_lines(server, stream)
                      if ln.get("msg") == "DNS query"]
            assert len(qlines) == 2
            for ln, qid in zip(qlines, (100, 101)):
                assert ln["req_id"] == qid
                assert ln["client"] == "127.0.0.1"
                assert ln["port"].endswith("/udp")
                assert ln["edns"] is True
                assert ln["rcode"] == "NOERROR"
                assert ln["query"] == {"srv": None, "name": "web.foo.com",
                                       "type": "A"}
                assert ln["answers"] == ["web... A 192.168.0.1"]
                assert ln["additional"] == []
                assert ln["level"] == 30
                assert ln["name"] == "binder-logring-test"
                assert isinstance(ln["latency"], float)
                assert "T" in ln["time"] and ln["time"].endswith("Z")
        finally:
            await server.stop()

    asyncio.run(run())


def test_cached_hit_logs_cached_shape():
    """A shape the zone cannot serve (out-of-suffix REFUSED): the first
    query logs through Python, repeats serve natively from the answer
    cache and log the Python hit-path shape (``cached: true``)."""
    async def run():
        _, cache = fixture_store()
        stream = io.StringIO()
        server = await start_logged_server(cache, stream)
        try:
            r1 = await udp_ask(server.udp_port, "x.example.com", Type.A,
                               qid=200)
            # the first repeat promotes; the next repeat is the C one
            await udp_ask(server.udp_port, "x.example.com", Type.A, qid=205)
            r2 = await udp_ask(server.udp_port, "x.example.com", Type.A,
                               qid=201)
            assert r1.rcode == r2.rcode == Rcode.REFUSED
            assert fastio.fastpath_stats(server._fastpath)["hits"] >= 1
            by_id = {ln["req_id"]: ln for ln in log_lines(server, stream)
                     if ln.get("msg") == "DNS query"}
            # first: the Python resolve line, with its reason
            assert by_id[200]["rcode"] == "REFUSED"
            assert by_id[200]["reason"] == "not within dns domain suffix"
            # repeat: the C line in the hit-path shape
            assert by_id[201]["rcode"] == "REFUSED"
            assert by_id[201]["cached"] is True
            assert by_id[201]["answers"] == []
        finally:
            await server.stop()

    asyncio.run(run())


def test_tcp_serve_logs_through_ring():
    async def run():
        _, cache = fixture_store()
        stream = io.StringIO()
        server = await start_logged_server(cache, stream)
        try:
            r = await tcp_ask(server.tcp_port, "web.foo.com", Type.A,
                              qid=300, edns_payload=None)
            assert r.rcode == Rcode.NOERROR
            assert fastio.fastpath_stats(server._fastpath)["zone_hits"] >= 1
            tcp = [ln for ln in log_lines(server, stream)
                   if ln.get("req_id") == 300]
            assert len(tcp) == 1
            assert tcp[0]["port"].endswith("/tcp")
            assert tcp[0]["edns"] is False
            assert tcp[0]["answers"] == ["web... A 192.168.0.1"]
        finally:
            await server.stop()

    asyncio.run(run())


def test_srv_zone_serve_logs_rotating_answers():
    async def run():
        _, cache = fixture_store()
        stream = io.StringIO()
        server = await start_logged_server(cache, stream)
        try:
            r = await udp_ask(server.udp_port, "_pg._tcp.svc.foo.com",
                              Type.SRV, qid=400)
            assert r.rcode == Rcode.NOERROR
            assert len(r.answers) == 3
            srv = [ln for ln in log_lines(server, stream)
                   if ln.get("req_id") == 400]
            assert len(srv) == 1
            assert srv[0]["query"]["srv"] == "_pg._tcp"
            assert srv[0]["query"]["type"] == "SRV"
            # the logged answers are the exact served rotation
            served = [f"SRV {a.target.split('.')[0]}.svc...:{a.port}"
                      for a in r.answers]
            assert srv[0]["answers"] == served
            assert len(srv[0]["additional"]) == 3
        finally:
            await server.stop()

    asyncio.run(run())


def test_no_json_logger_keeps_stand_down():
    """queryLog on with a non-JSON logger: no ring, and the C lane
    stands down as it did before the ring existed."""
    async def run():
        _, cache = fixture_store()
        plain = logging.getLogger("binder-torch-logring-plain")
        plain.setLevel(logging.INFO)
        plain.propagate = False
        plain.handlers = [logging.NullHandler()]
        server = BinderServer(zk_cache=cache, dns_domain=DOMAIN,
                              datacenter_name="coal", host="127.0.0.1",
                              port=0, collector=MetricsCollector(),
                              log=plain, query_log=True)
        await server.start()
        try:
            assert not server._log_ring
            assert not server._fastpath_active()
            r1 = await udp_ask(server.udp_port, "web.foo.com", Type.A)
            r2 = await udp_ask(server.udp_port, "web.foo.com", Type.A)
            assert r1.rcode == r2.rcode == Rcode.NOERROR
            stats = fastio.fastpath_stats(server._fastpath)
            assert stats["zone_hits"] == 0
            assert stats["hits"] == 0
        finally:
            await server.stop()

    asyncio.run(run())


def test_logged_matches_unlogged_wire():
    """The logged posture answers as the log-off posture does (record
    types, rcodes) for the same store."""
    async def run():
        _, cache = fixture_store()
        logged = await start_logged_server(cache, io.StringIO())
        _, cache2 = fixture_store()
        quiet = BinderServer(zk_cache=cache2, dns_domain=DOMAIN,
                             datacenter_name="coal", host="127.0.0.1",
                             port=0, collector=MetricsCollector(),
                             query_log=False)
        await quiet.start()
        try:
            for name, qt in (("web.foo.com", Type.A),
                             ("svc.foo.com", Type.A),
                             ("_pg._tcp.svc.foo.com", Type.SRV),
                             ("1.0.168.192.in-addr.arpa", Type.PTR),
                             ("nope.foo.com", Type.A)):
                a = await udp_ask(logged.udp_port, name, qt, qid=1)
                b = await udp_ask(quiet.udp_port, name, qt, qid=1)
                assert a.rcode == b.rcode, name
                assert ([type(x).__name__ for x in a.answers]
                        == [type(x).__name__ for x in b.answers]), name
        finally:
            await logged.stop()
            await quiet.stop()

    asyncio.run(run())


# -- the two packages' lines, side by side --------------------------------

#: fields that name the process or the moment, not the query
VOLATILE = ("time", "pid", "hostname", "latency", "timers")
#: (name, qtype, edns payload): host A (zone table), service A and SRV
#: (multi-record, rotated by the C lane), PTR, a refusal outside the
#: domain, an unknown name and a type with no data; each asked three
#: times so the C answer cache and its promotion show
QUERIES = [("web.foo.com", Type.A, 1232), ("web.foo.com", Type.A, None),
           ("svc.foo.com", Type.A, 1232),
           ("_http._tcp.svc.foo.com", Type.SRV, 1232),
           ("1.0.168.192.in-addr.arpa", Type.PTR, 1232),
           ("x.example.com", Type.A, 1232), ("nope.foo.com", Type.A, 1232),
           ("web.foo.com", Type.AAAA, None)]


def boot_logged(package, tmp_path):
    """``package.main`` on the C lane with the shipped config, the
    query log on (unset, as shipped) and loopback allowlisted; its
    process, UDP port and log path."""
    with open(os.path.join(ROOT, "etc", "config.json")) as f:
        config = json.load(f)
    config["store"]["fixture"] = os.path.join(ROOT, "etc", "fixture.json")
    config["rrl"]["allowlist"] = ["127.0.0.0/8"]
    assert "queryLog" not in config
    path = tmp_path / f"{package}.json"
    path.write_text(json.dumps(config))
    log_path = str(tmp_path / f"{package}.log")
    with open(log_path, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", LANE_MAIN, "native", package, "-f",
             str(path), "-p", "0"], cwd=ROOT, stdout=out,
            stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONUNBUFFERED="1"))
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        with open(log_path, "rb") as f:
            m = re.search(rb"UDP DNS service started on [\d.]+:(\d+)",
                          f.read())
        if m:
            return proc, int(m.group(1)), log_path
        assert proc.poll() is None, open(log_path, "rb").read()[-2000:]
        time.sleep(0.05)
    proc.kill()
    raise AssertionError(f"{package}.main did not start")


def ask(port, wire, transport):
    if transport == "udp":
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(5)
            s.sendto(wire, ("127.0.0.1", port))
            return s.recv(65535)
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(struct.pack(">H", len(wire)) + wire)
        buf = b""
        while len(buf) < 2 or len(buf) < 2 + struct.unpack(
                ">H", buf[:2])[0]:
            chunk = s.recv(65535)
            assert chunk, "connection closed mid-reply"
            buf += chunk
        return buf[2:]


def query_lines(log_path, want):
    """The ``DNS query`` lines of a log once ``want`` of them are there
    (the ring drains every 0.1 s)."""
    deadline = time.monotonic() + 10
    while True:
        with open(log_path, "rb") as f:
            lines = [json.loads(x) for x in f.read().splitlines()
                     if x.startswith(b"{")]
        lines = [x for x in lines if x.get("msg") == "DNS query"]
        if len(lines) >= want or time.monotonic() > deadline:
            return lines
        time.sleep(0.05)


def line_key(line):
    return line["port"].rsplit("/", 1)[1], line["req_id"]


def comparable(line):
    """A line without its volatile fields, its port reduced to the
    transport, its trace ID to the sequence after the process's pid,
    and a multi-record answer list as a set."""
    out = {k: v for k, v in line.items() if k not in VOLATILE}
    out["port"] = line["port"].rsplit("/", 1)[1]
    if "trace" in out:
        out["trace"] = out["trace"].split("-", 1)[1]
    for key in ("answers", "additional"):
        if isinstance(out.get(key), list) and len(out[key]) > 1:
            out[key] = sorted(out[key])
    return out


@pytest.mark.reference
def test_query_log_lines_equal_the_reference(tmp_path):
    wires = [make_query(name, qtype, qid=1000 + k,
                        edns_payload=edns).encode()
             for k, (name, qtype, edns) in enumerate(QUERIES * 3)]
    lines = {}
    for package in ("binder_torch", "binder_tpu"):
        proc, port, log_path = boot_logged(package, tmp_path)
        try:
            for transport in ("udp", "tcp"):
                for w in wires:
                    ask(port, w, transport)
            lines[package] = query_lines(log_path, 2 * len(wires))
        finally:
            proc.terminate()
            proc.wait(timeout=10)
    port_lines, ref_lines = lines["binder_torch"], lines["binder_tpu"]
    assert len(port_lines) == len(ref_lines) == 2 * len(wires)
    # paired by transport and query ID: the C lane's lines reach the
    # log when its ring drains (every 0.1 s), the Python lane's at
    # once, so a loaded host interleaves the two lanes differently in
    # each process's file
    for got, want in zip(sorted(port_lines, key=line_key),
                         sorted(ref_lines, key=line_key)):
        assert comparable(got) == comparable(want), (got, want)
    # the C lane logged some of them: its cached-hit shape is there
    assert any(x.get("cached") is True for x in port_lines)
    assert {x["port"].rsplit("/", 1)[1] for x in port_lines} == \
        {"udp", "tcp"}
