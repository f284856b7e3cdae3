"""Serve-loop parity: an in-process ``BinderServer`` from each package.

Both servers mirror the same zone: a reference FakeStore is built
(fixture, a small synthetic zone, a 64-instance service), walked into a
plain ``path -> data`` mapping, and loaded into the port's FakeStore
with ``load_state``.  Each server runs on the Python serve lane and is
built with the keyword arguments ``main.run`` derives from a config:
once from the bench's headline config and once from the shipped
``etc/config.json`` policy blocks.
Both get the same seeded ``random.Random``, and each then answers the
same UDP and TCP query stream over real sockets.  Replies are compared
byte for byte; no name needs an order-insensitive relaxation.  The
port's ``/metrics`` exposition must pass ``tools.lint``'s validators,
and the malformed corpus must get identical replies from both servers'
UDP and TCP lanes.  A seeded flood through each package's
``ResponseRateLimiter``, on a patched clock, must give the same verdict
sequence.
"""
import asyncio
import json
import os
import random
import socket
import struct
import types

import pytest

from binder_torch import server as port_server
from binder_torch.dns import server as port_dns_server
from binder_torch.dns import wire as port_wire
from binder_torch.metrics.collector import MetricsCollector as PortMetrics
from binder_torch.policy import rrl as port_rrl
from binder_torch.store import FakeStore as PortStore
from binder_torch.store import MirrorCache as PortMirror
from binder_torch.store.fake import load_state
from binder_tpu import server as ref_server
from binder_tpu.dns import server as ref_dns_server
from binder_tpu.metrics.collector import MetricsCollector as RefMetrics
from binder_tpu.policy import rrl as ref_rrl
from binder_tpu.store import FakeStore as RefStore
from binder_tpu.store import MirrorCache as RefMirror
from binder_tpu.store.fake import populate_synthetic
from tools import lint
from tools.hostile import read_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = "foo.com"
HOSTS = 3000
SEED = 7
T = port_wire.Type

with open(os.path.join(ROOT, "etc", "config.json")) as _f:
    SHIPPED = json.load(_f)

#: the bench's headline config (``bench_impl.start_server``) and the
#: shipped config; both go through main.run's defaults
CONFIGS = {
    "bench": {"queryLog": False},
    "shipped": {k: SHIPPED[k] for k in ("maxTcpConns", "tcpIdleTimeout",
                                        "maxTcpWriteBuffer", "degradation",
                                        "admission", "rrl")},
}


@pytest.fixture(autouse=True)
def python_lane(monkeypatch):
    """Pin both packages to the Python serve lane: a native build of
    the reference's optional ``_binderfastio`` must not give it the C
    lane while the port (which has none yet) serves in Python."""
    for mod in (port_server, port_dns_server, ref_server, ref_dns_server):
        monkeypatch.setattr(mod, "_fastio", None)
    for mod in (port_dns_server, ref_dns_server):
        for name in ("_fp_serve_wire", "_fp_serve_frames",
                     "_fp_serve_balancer"):
            monkeypatch.setattr(mod, name, None)


def server_kwargs(options):
    """The BinderServer keyword arguments ``main.run`` builds."""
    kw = dict(
        query_log=bool(options.get("queryLog", True)),
        degradation=dict(options.get("degradation") or {}),
        admission=dict(options.get("admission") or {}),
        rrl=dict(options.get("rrl") or {}),
        verify=dict(options.get("verify") or {}),
        zone_precompile=True, answer_precompile=True)
    for key, arg, cast in (("tcpIdleTimeout", "tcp_idle_timeout", float),
                           ("maxTcpConns", "max_tcp_conns", int),
                           ("maxTcpWriteBuffer", "max_tcp_write_buffer",
                            int)):
        if key in options:
            kw[arg] = cast(options[key])
    return kw


def reference_tree():
    store = RefStore()
    with open(os.path.join(ROOT, "etc", "fixture.json")) as f:
        for path, obj in json.load(f).items():
            store.put_json(path, obj)
    store.put_json("/com/foo/big", {
        "type": "service",
        "service": {"srvce": "_http", "proto": "_tcp", "port": 80}})
    for k in range(64):
        store.put_json(f"/com/foo/big/lb{k}", {
            "type": "load_balancer",
            "load_balancer": {"address": f"10.200.0.{k + 1}"}})
    populate_synthetic(store, DOMAIN, hosts=HOSTS)
    return store


def walk(node, prefix=""):
    out = {}
    for label, kid in node.children.items():
        path = prefix + "/" + label
        out[path] = kid.data
        out.update(walk(kid, path))
    return out


def query_stream(n):
    """Seeded ``(name, qtype, edns)`` mix: host A, PTR, service A/SRV,
    the 64-instance service (TC=1 over UDP), and policy shapes."""
    rng = random.Random(SEED)
    racks = max(1, min(1024, HOSTS // 512))
    out = []
    for _ in range(n):
        i = rng.randrange(HOSTS)
        host = f"h{i:06d}.r{i % racks:04d}.zs.{DOMAIN}"
        addr = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
        out.append(rng.choice([
            (host, T.A, 1232),
            (port_wire.reverse_name_for_ip(addr), T.PTR, 1232),
            (f"svc.{DOMAIN}", T.A, rng.choice([None, 1232])),
            (f"_http._tcp.svc.{DOMAIN}", T.SRV, 1232),
            (f"_http._tcp.big.{DOMAIN}", T.SRV, 1232),
            (f"big.{DOMAIN}", T.A, None),
            (f"nope.{DOMAIN}", T.A, 1232),
            (f"_zs._tcp.r0001.zs.{DOMAIN}", T.SRV, 1232),
            (f"web.{DOMAIN}", T.AAAA, None),
        ]))
    return out


def recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "connection closed mid-reply"
        buf += chunk
    return buf


def drive(port, stream):
    """Blocking client, one query at a time: UDP then TCP replies."""
    wires = [port_wire.make_query(name, qtype, qid=i, edns_payload=edns)
             .encode() for i, (name, qtype, edns) in enumerate(stream)]
    udp, tcp = [], []
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(5)
        for w in wires:
            s.sendto(w, ("127.0.0.1", port))
            udp.append(s.recv(65535))
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        for w in wires:
            s.sendall(struct.pack(">H", len(w)) + w)
            (n,) = struct.unpack(">H", recv_exact(s, 2))
            tcp.append(recv_exact(s, n))
    return udp, tcp


async def serve_once(mod, store, cache, collector, options, stream):
    server = mod.BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        collector=collector, host="127.0.0.1", port=0,
        **server_kwargs(options))
    server.resolver.rng = random.Random(SEED)
    await server.start()
    try:
        loop = asyncio.get_running_loop()
        udp, tcp = await loop.run_in_executor(
            None, drive, server.udp_port, stream)
        raw = []
        for lane, src in (("udp", ("192.0.2.7", 5353)),
                          ("tcp", ("192.0.2.7", 40001))):
            for _, frame in read_corpus(os.path.join(
                    ROOT, "tests", "data", "malformed_corpus.bin")):
                out = []
                server.engine._handle_raw(frame, src, lane, out.append)
                raw.append(out)
        collector.fold()
        return udp, tcp, raw, collector.expose()
    finally:
        await server.stop()


def run_both(config):
    ref_store = reference_tree()
    ref_cache = RefMirror(ref_store, DOMAIN)
    port_store = PortStore()
    load_state(port_store, walk(ref_store._root))
    port_cache = PortMirror(port_store, DOMAIN)
    ref_store.start_session()
    port_store.start_session()
    stream = query_stream(300)
    options = CONFIGS[config]
    got = asyncio.run(serve_once(port_server, port_store, port_cache,
                                 PortMetrics(), options, stream))
    want = asyncio.run(serve_once(ref_server, ref_store, ref_cache,
                                  RefMetrics(), options, stream))
    return stream, got, want


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_same_stream_same_bytes(config):
    stream, got, want = run_both(config)
    (udp, tcp, raw, scrape), (r_udp, r_tcp, r_raw, r_scrape) = got, want
    for i, (name, qtype, _) in enumerate(stream):
        assert udp[i] == r_udp[i], ("udp", i, name, qtype)
        assert tcp[i] == r_tcp[i], ("tcp", i, name, qtype)
    assert raw == r_raw
    # the stream exercised the lanes it was built for
    decoded = [port_wire.Message.decode(w) for w in udp]
    assert any(m.tc and not m.answers for m in decoded)
    big = [port_wire.Message.decode(w) for w, (n, t, _) in zip(tcp, stream)
           if n == f"_http._tcp.big.{DOMAIN}"]
    assert big and all(len(m.answers) == 64 for m in big)
    # the exposition: same families, and valid by the repo's linters
    families = sorted(line.split()[2] for line in scrape.splitlines()
                      if line.startswith("# TYPE"))
    assert families == sorted(line.split()[2]
                              for line in r_scrape.splitlines()
                              if line.startswith("# TYPE"))
    for validate in (lint.validate_exposition, lint.validate_rrl_metrics,
                     lint.validate_precompile_metrics,
                     lint.validate_tcp_metrics,
                     lint.validate_verify_metrics):
        assert validate(r_scrape) == [], validate.__name__
        assert validate(scrape) == [], validate.__name__


class Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def test_rrl_verdicts_match_on_seeded_flood(monkeypatch):
    clocks = {}
    limiters = {}
    for key, mod in (("port", port_rrl), ("ref", ref_rrl)):
        clocks[key] = Clock()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=clocks[key].monotonic))
        limiters[key] = mod.ResponseRateLimiter.from_config(
            dict(SHIPPED["rrl"], maxBuckets=64,
                 allowlist=["198.51.100.0/24"]))
    rng = random.Random(SEED)
    verdicts = {"port": [], "ref": []}
    for _ in range(20000):
        dt = rng.expovariate(5000.0)
        src = rng.choice([f"203.0.113.{rng.randrange(256)}",
                          f"192.0.2.{rng.randrange(8)}",
                          f"198.51.100.{rng.randrange(4)}",
                          f"10.{rng.randrange(256)}.0.1",
                          "2001:db8::1", "2001:db8:0:1::7"])
        tcp = rng.random() < 0.05
        for key, lim in limiters.items():
            clocks[key].now += dt
            if tcp:
                lim.note_tcp(src)
            verdicts[key].append(lim.decide(src))
    assert verdicts["port"] == verdicts["ref"]
    assert {port_rrl.SEND, port_rrl.SLIP, port_rrl.DROP} <= set(
        verdicts["port"])
    port, ref = limiters["port"], limiters["ref"]
    assert port.introspect() == ref.introspect()
