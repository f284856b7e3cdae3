"""The port's C lane, held against its own Python lane.

``binder_torch._binderfastio`` is built at first use from
``native/fastio/`` by ``binder_torch.fastio_build`` into the git-ignored
``binder_torch/_build/``.  The Python lane is held to the reference by
``test_torch_serve.py``; here the same seeded query stream goes through
one port ``BinderServer`` with the extension and one with ``_fastio``
pinned to ``None``, over UDP and over TCP: asked twice (the second pass
is served from the C answer cache), then again after store mutations
(a changed address, a deleted host, a new name).  Every reply must be
byte-identical between the lanes; where the answer holds more than one
record, the lanes rotate the records independently, so those replies
compare by header and record set.

The build itself: the cache key follows the sources, concurrent first
use from several processes compiles once, and a failed build raises
``NativeBuildError`` (not ``ImportError``, which the serve modules
would take as "no extension" and fall back to Python), naming the
compiler and what it said, also when it stops ``binder_torch.main``.

``LANE_MAIN`` and ``pin_python_lane`` pin a package to one serve lane;
the tests that compare the port with the reference through a live
server use them, so that both packages serve on the same lane.
"""
import asyncio
import dataclasses
import importlib
import json
import os
import random
import shutil
import socket
import struct
import subprocess
import sys

import pytest

import binder_torch
from binder_torch import _binderfastio, fastio_build
from binder_torch import server as port_server
from binder_torch.dns import server as port_dns_server
from binder_torch.dns import wire
from binder_torch.metrics.collector import MetricsCollector
from binder_torch.store import FakeStore, MirrorCache
from binder_torch.store.fake import populate_synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAIN = "foo.com"
HOSTS = 3000
SEED = 11
T = wire.Type

#: the extension's functions (native/fastio/fastio.c, fastio_methods)
EXTENSION_FUNCTIONS = (
    "recv_batch", "send_batch", "io_stats", "fastpath_new", "fastpath_put",
    "fastpath_zone_put", "fastpath_serve_wire", "fastpath_serve_frames",
    "fastpath_serve_balancer", "fastpath_drain", "fastpath_stats",
    "fastpath_clear", "fastpath_zone_reserve", "fastpath_invalidate",
    "fastpath_invalidate_many", "fastpath_log_enable",
    "fastpath_log_drain")
NATIVE_SERVE = ("_fp_serve_wire", "_fp_serve_frames", "_fp_serve_balancer")

#: ``python -c LANE_MAIN <lane> <package> <main arguments>`` runs
#: ``<package>.main`` on one serve lane.  ``python`` pins the package's
#: modules to the Python lane; ``native`` gives the reference the C lane
#: built by the port from the same ``native/`` sources (this tree has no
#: build of its own for it), and the port its own.  It exits before
#: serving if the package is not on that lane.
LANE_MAIN = """
import importlib, importlib.util, sys
lane, package = sys.argv[1:3]
if lane == "native" and package != "binder_torch":
    from binder_torch import fastio_build
    name = package + "._binderfastio"
    spec = importlib.util.spec_from_file_location(
        name, fastio_build.build("extension")[0])
    ext = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ext)
    sys.modules[name] = ext
server = importlib.import_module(package + ".server")
dns_server = importlib.import_module(package + ".dns.server")
if lane == "python":
    server._fastio = dns_server._fastio = None
    for attr in %r:
        setattr(dns_server, attr, None)
if (server._fastio is None) != (lane == "python"):
    sys.exit(package + " is not on the " + lane + " lane")
importlib.import_module(package + ".main").main(sys.argv[3:])
""" % (NATIVE_SERVE,)


def pin_python_lane(monkeypatch, *packages):
    """Pin each ``(server, dns.server)`` module pair to the Python
    serve lane for the rest of the test."""
    for server_mod, dns_mod in packages:
        monkeypatch.setattr(server_mod, "_fastio", None)
        monkeypatch.setattr(dns_mod, "_fastio", None)
        for name in NATIVE_SERVE:
            monkeypatch.setattr(dns_mod, name, None)


# -- the lanes ----------------------------------------------------------


def zone():
    store = FakeStore()
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
    cache = MirrorCache(store, DOMAIN)
    store.start_session()
    return store, cache


def host(i):
    racks = max(1, min(1024, HOSTS // 512))
    return (f"h{i:06d}.r{i % racks:04d}.zs.{DOMAIN}",
            f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}")


def host_path(i):
    racks = max(1, min(1024, HOSTS // 512))
    return f"/com/foo/zs/r{i % racks:04d}/h{i:06d}"


#: hosts the mutations touch (each also asked in every pass)
CHANGED, DELETED = range(0, 8), range(8, 12)


def query_stream(n):
    """Seeded ``(name, qtype, edns)`` mix over every answer shape: host
    A and PTR (the zone tables), service A/SRV (rotating), TC=1 over
    UDP, unknown names, a qtype with no data, and the hosts the
    mutations change."""
    rng = random.Random(SEED)
    out = []
    for i in list(CHANGED) + list(DELETED):
        name, addr = host(i)
        out += [(name, T.A, 1232), (wire.reverse_name_for_ip(addr), T.PTR,
                                    1232)]
    for _ in range(n):
        name, addr = host(rng.randrange(HOSTS))
        out.append(rng.choice([
            (name, T.A, 1232), (name, T.A, None),
            (wire.reverse_name_for_ip(addr), T.PTR, 1232),
            (f"svc.{DOMAIN}", T.A, rng.choice([None, 1232])),
            (f"_http._tcp.svc.{DOMAIN}", T.SRV, 1232),
            (f"_http._tcp.big.{DOMAIN}", T.SRV, 1232),
            (f"big.{DOMAIN}", T.A, None),
            (f"nope.{DOMAIN}", T.A, 1232),
            (f"web.{DOMAIN}", T.AAAA, None),
            (f"new.{DOMAIN}", T.A, 1232),
        ]))
    return out


def recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "connection closed mid-reply"
        buf += chunk
    return buf


def drive(port, transport, wires):
    """One query at a time over one socket; the replies in order."""
    out = []
    if transport == "udp":
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(5)
            for w in wires:
                s.sendto(w, ("127.0.0.1", port))
                out.append(s.recv(65535))
        return out
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        for w in wires:
            s.sendall(struct.pack(">H", len(w)) + w)
            (n,) = struct.unpack(">H", recv_exact(s, 2))
            out.append(recv_exact(s, n))
    return out


def mutate(store):
    for i in CHANGED:
        store.put_json(host_path(i), {"type": "host",
                                      "host": {"address": f"10.99.0.{i}"}})
    for i in DELETED:
        store.delete(host_path(i))
    store.put_json("/com/foo/new", {"type": "host",
                                    "host": {"address": "10.98.0.1"}})


async def serve(transport, stream):
    """Three passes of ``stream`` through a fresh server on whatever
    lane the modules are pinned to (the mutations before the third),
    and the C lane's counters (None on the Python lane)."""
    store, cache = zone()
    server = port_server.BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        collector=MetricsCollector(), host="127.0.0.1", port=0,
        query_log=False, rrl={"allowlist": ["127.0.0.0/8"]})
    server.resolver.rng = random.Random(SEED)
    await server.start()
    wires = [wire.make_query(name, qtype, qid=k + 1, edns_payload=edns)
             .encode() for k, (name, qtype, edns) in enumerate(stream)]
    loop = asyncio.get_running_loop()
    port = server.udp_port if transport == "udp" else server.tcp_port
    try:
        passes = []
        for k in range(3):
            if k == 2:
                mutate(store)
            passes.append(await loop.run_in_executor(
                None, drive, port, transport, wires))
        stats = (_binderfastio.fastpath_stats(server._fastpath)
                 if server._fastpath is not None else None)
        return passes, stats
    finally:
        await server.stop()


def rr_sets(data):
    m = wire.Message.decode(data)

    def rows(section):
        return sorted(repr(dataclasses.astuple(r)) for r in section)
    return (data[:12], rows(m.answers), rows(m.authorities),
            rows(m.additionals))


@pytest.mark.parametrize("transport", ["udp", "tcp"])
def test_c_lane_answers_like_python_lane(transport, monkeypatch):
    stream = query_stream(300)
    native, stats = asyncio.run(serve(transport, stream))
    with monkeypatch.context() as m:
        pin_python_lane(m, (port_server, port_dns_server))
        python, none = asyncio.run(serve(transport, stream))
    assert none is None and stats is not None
    rotated = 0
    for k, (c_pass, py_pass) in enumerate(zip(native, python)):
        for (name, qtype, _), got, want in zip(stream, c_pass, py_pass):
            if got == want:
                continue
            # records rotate per lane: only a multi-record answer may
            # differ, and then only in order
            assert len(wire.Message.decode(want).answers) > 1, \
                (k, name, qtype)
            assert rr_sets(got) == rr_sets(want), (k, name, qtype)
            rotated += 1
    assert rotated < len(stream)
    # the C lane served from its zone tables, and over UDP from its
    # answer cache too (Python fills that from UDP answers)
    assert stats["zone_hits"] > 0, stats
    assert stats["hits"] > 0 or transport == "tcp", stats
    # the mutations reached both lanes' answers
    after = {(name, qtype): wire.Message.decode(w)
             for (name, qtype, _), w in zip(stream, native[2])}
    for i in CHANGED:
        assert [a.address for a in after[(host(i)[0], T.A)].answers] == \
            [f"10.99.0.{i}"]
    for i in DELETED:
        assert after[(host(i)[0], T.A)].rcode == wire.Rcode.REFUSED
    assert [a.address for a in after[(f"new.{DOMAIN}", T.A)].answers] == \
        ["10.98.0.1"]
    before = {(name, qtype): wire.Message.decode(w)
              for (name, qtype, _), w in zip(stream, native[1])}
    assert before[(f"new.{DOMAIN}", T.A)].rcode == wire.Rcode.REFUSED
    assert [a.address for a in before[(host(0)[0], T.A)].answers] == \
        [host(0)[1]]


async def degraded_during_fill():
    """Lose the store session while the chunked zone fill is running,
    let it finish, and ask every 7th host: while stale-serving, then
    past the cap.  The replies' (rcode, TTLs) in each window."""
    store, cache = zone()
    server = port_server.BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        collector=MetricsCollector(), host="127.0.0.1", port=0,
        query_log=False, rrl={"allowlist": ["127.0.0.0/8"]},
        degradation={"maxStalenessSeconds": 1.0,
                     "staleTtlClampSeconds": 5})
    await server.start()
    store.lose_session()
    assert server._policy.mode() == "stale-serving"
    await server._zone_fill_task
    wires = [wire.make_query(host(i)[0], T.A, qid=i + 1).encode()
             for i in range(0, HOSTS, 7)]
    loop = asyncio.get_running_loop()
    out = []
    try:
        for window in ("stale-serving", "stale-exhausted"):
            if window == "stale-exhausted":
                await asyncio.sleep(1.1)
            replies = await loop.run_in_executor(None, drive,
                                                 server.udp_port, "udp",
                                                 wires)
            assert server._policy.mode() == window
            out.append([(m.rcode, [a.ttl for a in m.answers])
                        for m in map(wire.Message.decode, replies)])
        return out
    finally:
        await server.stop()


def test_zone_fill_serves_nothing_unclamped_while_degraded(monkeypatch):
    # a session lost while a large zone's chunked fill is still running
    # (as in a respawned or rolled worker at 100k names): the fill must
    # not put full-TTL answers in the C zone table under the degraded
    # epoch, or the C drain serves them unclamped, and past the cap
    from binder_torch.resolver.precompile import Precompiler
    monkeypatch.setattr(Precompiler, "SEED_INLINE_MAX", 100)
    stale, exhausted = asyncio.run(degraded_during_fill())
    assert stale and all(rcode == 0 and ttls and max(ttls) <= 5
                         for rcode, ttls in stale), \
        [r for r in stale if not r[1] or max(r[1]) > 5][:5]
    assert all(rcode == wire.Rcode.SERVFAIL and not ttls
               for rcode, ttls in exhausted)


# -- the build ------------------------------------------------------------


def test_module_is_the_port_built_extension():
    assert os.path.dirname(os.path.dirname(_binderfastio.__file__)) == \
        fastio_build.BUILD_DIR
    assert os.path.exists(fastio_build.artifact_path("extension"))
    assert _binderfastio.__name__ == "binder_torch._binderfastio"
    assert binder_torch._binderfastio is _binderfastio
    for name in EXTENSION_FUNCTIONS:
        assert callable(getattr(_binderfastio, name)), name
    assert port_server._fastio is _binderfastio
    assert port_dns_server._fastio is _binderfastio
    assert port_dns_server._fp_serve_balancer is \
        _binderfastio.fastpath_serve_balancer


def test_cache_key_follows_every_source(tmp_path, monkeypatch):
    native = tmp_path / "native"
    shutil.copytree(os.path.join(ROOT, "native", "fastio"),
                    native / "fastio")
    shutil.copytree(os.path.join(ROOT, "native", "balancer"),
                    native / "balancer")
    shutil.copytree(os.path.join(ROOT, "native", "common"),
                    native / "common")
    for sub in ("adjust", "zklog", "loadgen"):
        shutil.copytree(os.path.join(ROOT, "native", sub), native / sub)
    monkeypatch.setattr(fastio_build, "NATIVE_DIR", str(native))
    art = fastio_build.ARTIFACTS
    keys = {n: fastio_build.cache_key(a) for n, a in art.items()}
    assert keys == {n: fastio_build.cache_key(a) for n, a in art.items()}
    assert set(keys) == {"extension", "mbalancer", "instance_adjust",
                         "zlogcat", "dnsblast"}
    assert len(set(keys.values())) == len(keys)
    for rel, changes in (("fastio/fastpath.c", {"extension"}),
                         ("fastio/fpcore.h", {"extension"}),
                         ("balancer/mbalancer.cpp", {"mbalancer"}),
                         ("adjust/instance_adjust.cpp",
                          {"instance_adjust"}),
                         ("zklog/zlogcat.cpp", {"zlogcat"}),
                         ("loadgen/dnsblast.cpp", {"dnsblast"}),
                         ("common/dnskey.h", {"extension", "mbalancer"})):
        with open(native / rel, "a") as f:
            f.write("\n/* changed */\n")
        now = {n: fastio_build.cache_key(a) for n, a in art.items()}
        assert {n for n in now if now[n] != keys[n]} == changes, rel
        keys = now
    monkeypatch.setattr(fastio_build, "CFLAGS",
                        fastio_build.CFLAGS + ("-DX",))
    assert fastio_build.cache_key(art["extension"]) != keys["extension"]
    monkeypatch.setattr(fastio_build, "CXXFLAGS",
                        fastio_build.CXXFLAGS + ("-DX",))
    now = {n: fastio_build.cache_key(a) for n, a in art.items()}
    assert {n for n in now if now[n] != keys[n]} == set(keys)


def test_install_links_every_artifact():
    # the port's ``make -C native``: five artifacts, each under a
    # stable relative name in _build/bin/
    proc = subprocess.run(
        [sys.executable, "-m", "binder_torch.fastio_build", "install"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.splitlines()) == len(fastio_build.ARTIFACTS) == 5
    for name, art in fastio_build.ARTIFACTS.items():
        link = fastio_build.bin_path(name)
        assert link == os.path.join(fastio_build.BUILD_DIR, "bin",
                                    art.output)
        assert not os.path.isabs(os.readlink(link))
        assert os.path.realpath(link) == os.path.realpath(
            fastio_build.artifact_path(name))
        assert f"{link} -> {fastio_build.artifact_path(name)}" in proc.stdout
        if not art.python:
            assert os.access(link, os.X_OK)


FAILED_INSTALL = """
import sys
sys.path.insert(0, sys.argv[1])
from binder_torch import fastio_build
fastio_build.CXX = "no-such-cxx-for-the-port"
fastio_build.BUILD_DIR = sys.argv[2]
sys.exit(fastio_build.main(["install"]))
"""


def test_failed_install_exits_with_the_compiler_error(tmp_path):
    build_dir = str(tmp_path / "build")
    proc = subprocess.run(
        [sys.executable, "-c", FAILED_INSTALL, ROOT, build_dir], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "no-such-cxx-for-the-port" in proc.stderr
    assert "cannot build mbalancer" in proc.stderr
    # built in order up to the failure; nothing links what was not built
    linked = os.listdir(os.path.join(build_dir, "bin"))
    assert linked == [fastio_build.ARTIFACTS["extension"].output]


FIRST_USE = """
import json, sys
sys.path.insert(0, sys.argv[1])
from binder_torch import fastio_build
fastio_build.BUILD_DIR = sys.argv[2]
print("ready", flush=True)
sys.stdin.read()                      # start together
path, seconds = fastio_build.build("extension")
from binder_torch import _binderfastio
assert _binderfastio.__file__ == path
_binderfastio.fastpath_new(16, 1000, [0.001], [64.0])
print(json.dumps({"path": path, "compiled": seconds is not None}))
"""


def test_concurrent_first_use_builds_once(tmp_path):
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen(
        [sys.executable, "-c", FIRST_USE, ROOT, build_dir], cwd=ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for _ in range(6)]
    outs = []
    for p in procs:
        assert p.stdout.readline() == b"ready\n"
    for p in procs:               # every process is up; release them
        p.stdin.close()
    for p in procs:
        out, err = p.stdout.read(), p.stderr.read()
        assert p.wait(timeout=120) == 0, err.decode()[-2000:]
        p.stdout.close()
        p.stderr.close()
        outs.append(json.loads(out))
    assert sum(o["compiled"] for o in outs) == 1
    assert len({o["path"] for o in outs}) == 1
    built = os.path.dirname(outs[0]["path"])
    assert os.listdir(built) == [os.path.basename(outs[0]["path"])]
    assert sorted(os.listdir(build_dir)) == [".lock",
                                             os.path.basename(built)]


def broken_sources(tmp_path):
    native = tmp_path / "native"
    for sub in ("fastio", "common"):
        shutil.copytree(os.path.join(ROOT, "native", sub), native / sub)
    with open(native / "fastio" / "fastpath.c", "a") as f:
        f.write("\nthis is not C;\n")
    return str(native)


@pytest.mark.parametrize("fault", ["no-compiler", "compile-error"])
def test_failed_build_is_not_an_import_error(fault, tmp_path, monkeypatch):
    monkeypatch.setattr(fastio_build, "BUILD_DIR", str(tmp_path / "build"))
    if fault == "no-compiler":
        monkeypatch.setattr(fastio_build, "CC", "no-such-cc-for-the-port")
        said = "no-such-cc-for-the-port"
    else:
        monkeypatch.setattr(fastio_build, "NATIVE_DIR",
                            broken_sources(tmp_path))
        said = "this is not C"
    monkeypatch.delitem(sys.modules, "binder_torch._binderfastio")
    with pytest.raises(fastio_build.NativeBuildError) as err:
        importlib.import_module("binder_torch._binderfastio")
    assert not isinstance(err.value, ImportError)
    assert said in str(err.value)
    assert fastio_build.CC in str(err.value)       # the command
    assert not os.path.exists(fastio_build.artifact_path("extension"))


BROKEN_MAIN = """
import sys
sys.path.insert(0, sys.argv[1])
from binder_torch import fastio_build
fastio_build.CC = "no-such-cc-for-the-port"
fastio_build.BUILD_DIR = sys.argv[2]
from binder_torch.main import main
main(["-f", "etc/config.json", "-p", "0"])
"""


def test_failed_build_stops_main(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", BROKEN_MAIN, ROOT, str(tmp_path / "b")],
        cwd=ROOT, capture_output=True, timeout=60)
    err = proc.stderr.decode()
    assert proc.returncode == 1
    assert "binder_torch.fastio_build.NativeBuildError" in err
    assert "no-such-cc-for-the-port" in err
    assert b"DNS service started" not in proc.stdout


def test_chip_smoke_native_phase_on_the_cpu():
    # the smoke's native phase at a small zone: the build is found, the
    # extension is the port's, and the lanes agree
    sys.path.insert(0, ROOT)
    import chip_smoke
    report = chip_smoke.native_phase(hosts=2000)
    assert report["functions"] == len(EXTENSION_FUNCTIONS)
    assert set(report["build_s"]) == {"extension", "mbalancer",
                                      "instance_adjust"}
    parity = report["parity"]
    assert parity["differ"] == 0 and parity["identical"] > 0
    assert parity["replies"] == parity["identical"] + \
        parity["same_records_rotated"]
    assert parity["c_zone_hits"] > 0 and parity["c_cache_hits"] > 0
