"""Independent-implementation conformance for ``binder_torch``.

The port's side of the reference's ``tests/test_conformance.py``:

1. The RFC golden byte-vectors of ``TestGoldenVectors`` through
   ``binder_torch.dns`` and ``binder_tpu.dns`` alike; ``chip_smoke.py``
   carries the same bytes (``GOLDEN``) for the conformance phase.
2. glibc's resolver (``res_query`` and ``ns_parserr`` in libresolv)
   against a port server on an ephemeral port, through
   ``binder_torch.cli.libresolv_probe --server``: SRV content and its A
   additionals, A with its TTL, PTR, and the EDNS OPT echo.  No
   resolv.conf rewrite, no port 53, no root, so this runs in Tier-1
   wherever ``libresolv.so.2`` loads.
3. ``getent`` (gethostbyname / gethostbyaddr) against a port server on
   127.0.0.1:53: it cannot be pointed at another port, so it stays
   behind ``BINDER_LIBC_CONFORMANCE=1`` and root, as in the reference.
   ``tests/test_torch_libc_ns.py`` runs it on both packages in a
   private network and mount namespace instead.
4. dig(1), ``TestDigConformance``'s exchanges against a port server,
   where dig is installed.
"""
import asyncio
import ctypes
import errno
import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from binder_torch.cli import libresolv_probe
from binder_torch.dns import wire as port_wire
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache
from binder_tpu.dns import wire as ref_wire
from tests.test_conformance import (LIBC_GATE, TestGoldenVectors,
                                    resolv_override)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = "foo.com"
WIRES = {"port": port_wire, "ref": ref_wire}


@pytest.fixture
def glibc():
    """Skips where glibc's libresolv does not load."""
    try:
        ctypes.CDLL("libresolv.so.2")
    except OSError:
        pytest.skip("no libresolv.so.2 on this host")


# -- 1. RFC golden byte-vectors ----------------------------------------


def test_the_smoke_carries_the_reference_vectors():
    g = TestGoldenVectors
    assert {k: bytes.fromhex(v) for k, v in chip_smoke.GOLDEN.items()} == {
        "query_a": g.QUERY_A, "response_a": g.RESPONSE_A,
        "response_srv": g.RESPONSE_SRV, "response_ptr": g.RESPONSE_PTR,
        "response_soa": g.RESPONSE_SOA, "query_edns": g.QUERY_EDNS}
    assert chip_smoke.golden_errors() == []


@pytest.mark.parametrize("side", sorted(WIRES))
def test_query_encode_matches_rfc_bytes(side):
    w = WIRES[side]
    g = TestGoldenVectors
    for name in ("example.com", "ExAmPlE.CoM"):
        assert w.make_query(name, w.Type.A, qid=0x1234, rd=True,
                            edns_payload=None).encode() == g.QUERY_A
    assert w.make_query("web.foo.com", w.Type.A, qid=0x42,
                        edns_payload=1232).encode() == g.QUERY_EDNS


@pytest.mark.parametrize("side", sorted(WIRES))
def test_query_decode_matches_rfc_fields(side):
    w = WIRES[side]
    m = w.Message.decode(TestGoldenVectors.QUERY_A)
    assert (m.id, m.qr, m.rd, m.opcode) == (0x1234, False, True, 0)
    assert [(q.name, q.qtype, q.qclass) for q in m.questions] == [
        ("example.com", 1, 1)]
    assert not m.answers and not m.authorities and not m.additionals
    (opt,) = w.Message.decode(TestGoldenVectors.QUERY_EDNS).additionals
    assert isinstance(opt, w.OPTRecord)
    assert (opt.udp_payload_size, opt.version, opt.dnssec_ok,
            opt.has_options) == (1232, 0, False, False)


@pytest.mark.parametrize("side", sorted(WIRES))
def test_responses_decode_as_the_rfcs_write_them(side):
    w = WIRES[side]
    g = TestGoldenVectors
    m = w.Message.decode(g.RESPONSE_A)
    assert m.qr and m.aa and m.ra and m.rcode == w.Rcode.NOERROR
    (a,) = m.answers
    assert isinstance(a, w.ARecord)
    assert (a.name, a.ttl, a.address) == ("example.com", 300,
                                          "93.184.216.34")
    again = w.Message.decode(m.encode())
    assert again.answers == m.answers and again.questions == m.questions
    assert (again.id, again.rcode, again.aa) == (m.id, m.rcode, m.aa)
    (srv,) = w.Message.decode(g.RESPONSE_SRV).answers
    assert isinstance(srv, w.SRVRecord)
    assert (srv.name, srv.priority, srv.weight, srv.port, srv.target,
            srv.ttl) == ("_pg._tcp.svc.foo.com", 10, 20, 5432,
                         "lb0.svc.foo.com", 30)
    (ptr,) = w.Message.decode(g.RESPONSE_PTR).answers
    assert isinstance(ptr, w.PTRRecord)
    assert (ptr.name, ptr.target) == ("3.2.1.10.in-addr.arpa",
                                      "web.foo.com")
    (soa,) = w.Message.decode(g.RESPONSE_SOA).authorities
    assert isinstance(soa, w.SOARecord)
    assert (soa.mname, soa.rname, soa.serial, soa.refresh, soa.retry,
            soa.expire, soa.minimum) == ("ns.foo.com", "adadmin",
                                         0x78512EC6, 3600, 900, 604800, 60)


@pytest.mark.parametrize("side", sorted(WIRES))
def test_srv_encode_target_uncompressed(side):
    w = WIRES[side]
    m = w.Message(id=7, qr=True, aa=True)
    m.questions = list(w.Message.decode(
        TestGoldenVectors.RESPONSE_SRV).questions)
    m.answers = [w.SRVRecord(name="_pg._tcp.svc.foo.com", ttl=30,
                             priority=10, weight=20, port=5432,
                             target="lb0.svc.foo.com")]
    assert bytes.fromhex("036c62300373766303666f6f03636f6d00") \
        in m.encode()


def test_both_codecs_encode_the_vectors_alike():
    g = TestGoldenVectors
    for vector in (g.RESPONSE_A, g.RESPONSE_SRV, g.RESPONSE_PTR,
                   g.RESPONSE_SOA, g.QUERY_EDNS):
        assert port_wire.Message.decode(vector).encode() == \
            ref_wire.Message.decode(vector).encode()


# -- 2. glibc's resolver through the probe's --server route -------------


def fixture_cache():
    store = FakeStore()
    cache = MirrorCache(store, DOMAIN)
    store.put_json("/com/foo/web",
                   {"type": "host", "host": {"address": "10.7.7.7"}})
    store.put_json("/com/foo/svc", {
        "type": "service",
        "service": {"srvce": "_pg", "proto": "_tcp", "port": 5432}})
    store.put_json("/com/foo/svc/lb0",
                   {"type": "load_balancer",
                    "load_balancer": {"address": "10.0.1.1"}})
    store.start_session()
    return cache


async def serve(coro_fn, port=0):
    server = BinderServer(zk_cache=fixture_cache(), dns_domain=DOMAIN,
                          datacenter_name="coal", host="127.0.0.1",
                          port=port, collector=MetricsCollector())
    await server.start()
    try:
        return await coro_fn(server)
    finally:
        await server.stop()


def probe(port, name, qtype):
    out = subprocess.run(
        [sys.executable, "-m", "binder_torch.cli.libresolv_probe",
         "--server", f"127.0.0.1:{port}", name, qtype],
        cwd=ROOT, capture_output=True, text=True, timeout=30)
    assert out.returncode == 0, (out.stdout, out.stderr)
    return json.loads(out.stdout)


@pytest.mark.usefixtures("glibc")
def test_srv_a_ptr_and_edns_echo_through_glibc():
    """``TestLibresolvConformance``'s assertions, on an ephemeral port."""
    async def run(server):
        loop = asyncio.get_running_loop()
        port = server.udp_port

        def ask(name, qtype):
            return loop.run_in_executor(None, probe, port, name, qtype)

        return (await ask("_pg._tcp.svc.foo.com", "SRV"),
                await ask("web.foo.com", "A"),
                await ask("7.7.7.10.in-addr.arpa", "PTR"))

    srv, a, ptr = asyncio.run(serve(run))
    # SRV: answer content parsed by glibc, not by either codec
    assert srv["ancount"] == 1, srv
    (rec,) = srv["answers"]
    assert (rec["type"], rec["port"], rec["priority"], rec["target"]) == (
        33, 5432, 0, "lb0.svc.foo.com")
    adds = [x for x in srv["additional"] if x["type"] == 1]
    assert adds and adds[0]["name"] == "lb0.svc.foo.com"
    assert adds[0]["address"] == "10.0.1.1"
    # glibc sent EDNS: the OPT comes back with the server's ceiling
    assert srv["opt"] == {"payload": 1232}, srv
    assert [x["address"] for x in a["answers"]] == ["10.7.7.7"]
    assert a["answers"][0]["ttl"] == 30
    assert a["opt"] == {"payload": 1232}
    assert [x["target"] for x in ptr["answers"]] == ["web.foo.com"]


@pytest.mark.usefixtures("glibc")
def test_probe_agrees_with_the_port_codec():
    """glibc's parse of an answer equals the codec's decode of the same
    question's answer, field by field."""
    async def run(server):
        loop = asyncio.get_running_loop()
        got = await loop.run_in_executor(
            None, probe, server.udp_port, "_pg._tcp.svc.foo.com", "SRV")
        q = port_wire.make_query("_pg._tcp.svc.foo.com",
                                 port_wire.Type.SRV, qid=5).encode()
        reply = await loop.run_in_executor(
            None, chip_smoke.ask_once, server.udp_port, q)
        return got, port_wire.Message.decode(reply)

    got, msg = asyncio.run(serve(run))
    assert [(x["name"], x["ttl"], x["priority"], x["weight"], x["port"],
             x["target"]) for x in got["answers"]] == [
        (r.name, r.ttl, r.priority, r.weight, r.port, r.target)
        for r in msg.answers]
    assert [(x["name"], x["ttl"], x["address"])
            for x in got["additional"]] == [
        (r.name, r.ttl, r.address) for r in msg.additionals
        if isinstance(r, port_wire.ARecord)]


def test_probe_refuses_bad_arguments():
    for args in ([], ["web.foo.com"], ["web.foo.com", "MX"],
                 ["--server", "nowhere", "web.foo.com", "A"]):
        assert libresolv_probe.main(args) == 2, args


# -- 3. getent (glibc's stub resolver): root and port 53 -----------------


@pytest.mark.skipif(
    not LIBC_GATE,
    reason="set BINDER_LIBC_CONFORMANCE=1 (requires root; rewrites "
           "/etc/resolv.conf and binds 127.0.0.1:53)")
def test_getent_a_and_ptr():
    async def run(server):
        loop = asyncio.get_running_loop()

        def getent(*args):
            return subprocess.run(["getent", *args], capture_output=True,
                                  text=True, timeout=15)

        out = await loop.run_in_executor(None, getent, "ahostsv4",
                                         "web.foo.com")
        assert "10.7.7.7" in out.stdout, out
        out = await loop.run_in_executor(None, getent, "hosts",
                                         "10.7.7.7")
        assert "web.foo.com" in out.stdout, out

    try:
        with resolv_override("nameserver 127.0.0.1\n"
                             "options timeout:2 attempts:1\n"):
            asyncio.run(serve(run, port=53))
    except OSError as e:
        if e.errno == errno.EADDRINUSE:
            pytest.skip("127.0.0.1:53 already bound on this host")
        raise


# -- 4. dig(1), the reference's own conformance client ------------------


def test_dig_exchanges():
    """``TestDigConformance``'s exchanges against a port server."""
    dig = shutil.which("dig")
    if dig is None:
        pytest.skip("dig(1) not installed")

    async def run(server):
        port = server.udp_port
        loop = asyncio.get_running_loop()

        def digq(*args):
            return subprocess.run(
                [dig, "@127.0.0.1", "-p", str(port), "+time=3",
                 "+tries=1", *args],
                capture_output=True, text=True, timeout=15).stdout

        out = await loop.run_in_executor(None, digq, "web.foo.com", "A")
        assert "status: NOERROR" in out and "10.7.7.7" in out
        out = await loop.run_in_executor(
            None, digq, "_pg._tcp.svc.foo.com", "SRV")
        assert "status: NOERROR" in out and "5432" in out \
            and "lb0.svc.foo.com" in out
        out = await loop.run_in_executor(None, digq, "-x", "10.7.7.7")
        assert "web.foo.com" in out
        out = await loop.run_in_executor(None, digq, "other.example", "A")
        assert "status: REFUSED" in out
        out = await loop.run_in_executor(
            None, digq, "+tcp", "web.foo.com", "A")
        assert "status: NOERROR" in out and "10.7.7.7" in out

    asyncio.run(serve(run))
