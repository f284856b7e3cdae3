#!/usr/bin/env python3
"""Start the PyTorch port (``binder_torch``) on one GPU, end to end.

Run from the root of a checkout on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, each under its own deadline; any failure reaps every process
it started and exits non-zero without printing the ``ok`` line:

1. device: require CUDA; print the card's name and power limit.
2. serve: boot ``python -m binder_torch.main`` on a 100,000-name
   synthetic zone plus the shipped fixture and a 64-instance service,
   send a seeded A/PTR/SRV mix over UDP (concurrency 64) and TCP, and
   check every answer; record per-query latencies.
3. deploy: the production shape, all of it port code.  Render
   ``deploy/config/template`` with Triton metadata and layer on only
   what a loopback run needs (each override printed); seed the same
   zone into ``python -m binder_torch.store.zk_testserver`` through the
   port's ZooKeeper client; boot the supervisor of a 4-worker
   reuseport group over it; stream the mix from 16 sockets plus TCP
   while a second process rewrites 64 host znodes at about 500/s and
   measures how soon all 16 probe sockets read each write back; SIGKILL
   one worker mid-stream and check its respawn serves a later write;
   forward a ``dc1`` name to a peer port server and compare with the
   peer's own answer; SIGTERM the supervisor and check nothing is left.
4. aggregate: the port's latency summary (mean, p50, p99) on ``cuda``
   over the serve and deploy latencies and over a seeded 2**24 + 1
   batch, held against numpy.
5. collective: the data-parallel mean over NCCL on the one card.

The port has no hand-written kernel (the JAX package has no Pallas
kernel to port), so the kernel line is an empty list.  The last line
is ``{"ok": true, "device": {...}}``.  ``--churn ZK_PORT DNS_PORT`` is
the deploy phase's churn process, started by the script itself.
"""
from __future__ import annotations

import json
import os
import random
import re
import select
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

DOMAIN = "foo.com"
HOSTS = 100_000
N_UDP = 20_000
N_TCP = 500
CONCURRENCY = 64
SEED = 1234
BIG_INSTANCES = 64
LARGE_BATCH = (1 << 24) + 1
MEAN_RTOL = 1e-6

BOOT_DEADLINE_S = 180.0
UDP_DEADLINE_S = 300.0
TCP_DEADLINE_S = 120.0
REPLY_STALL_S = 5.0
RANK_DEADLINE_S = 240.0

#: the shipped fixture (etc/fixture.json) plus one service with many
#: instances: the shape for which TC=1 and the TCP lane exist
BIG_SERVICE = {"type": "service",
               "service": {"srvce": "_http", "proto": "_tcp", "port": 80}}


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1: device --------------------------------------------------


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise PhaseError("device: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)
    if smi.returncode != 0:
        raise PhaseError(f"device: nvidia-smi failed: {smi.stderr}")
    log("nvidia-smi: " + smi.stdout.strip().splitlines()[0])
    return torch


# -- phase 2: serve ---------------------------------------------------


def host_name(i: int, racks: int) -> str:
    return f"h{i:06d}.r{i % racks:04d}.zs.{DOMAIN}"


def host_addr(i: int) -> str:
    return f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"


def write_config(tmp: str, hosts: int) -> str:
    with open(os.path.join(ROOT, "etc", "fixture.json")) as f:
        fixture = json.load(f)
    fixture["/com/foo/big"] = BIG_SERVICE
    for k in range(BIG_INSTANCES):
        fixture[f"/com/foo/big/lb{k}"] = {
            "type": "load_balancer",
            "load_balancer": {"address": f"10.200.0.{k + 1}"}}
    fixture_path = os.path.join(tmp, "fixture.json")
    with open(fixture_path, "w") as f:
        json.dump(fixture, f)
    config_path = os.path.join(tmp, "config.json")
    with open(config_path, "w") as f:
        json.dump({
            "dnsDomain": DOMAIN, "datacenterName": "dc0",
            "host": "127.0.0.1",
            "store": {"backend": "fake", "fixture": fixture_path,
                      "synthetic": {"hosts": hosts}},
            "queryLog": False,
            # one client address drives the whole stream: keep the
            # limiter on but let loopback through
            "rrl": {"allowlist": ["127.0.0.0/8"]},
        }, f)
    return config_path


def boot_server(config_path: str, log_path: str,
                what: str = "serve: server"):
    """Start ``python -m binder_torch.main`` on ``config_path``; return
    the process and its UDP port once it serves."""
    proc = spawn(["-m", "binder_torch.main", "-f", config_path, "-p", "0"],
                 log_path)
    m = wait_line(proc, log_path, rb"UDP DNS service started on [\d.]+:(\d+)",
                  what, BOOT_DEADLINE_S)
    return proc, int(m.group(1))


def spawn(args, log_path: str):
    out = open(log_path, "wb")
    proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, stdout=out,
                            stderr=subprocess.STDOUT)
    out.close()
    return proc


def wait_line(proc, log_path: str, pattern: bytes, what: str,
              deadline_s: float):
    """The first match of ``pattern`` in ``proc``'s log, once it is
    there; PhaseError if ``proc`` exits or ``deadline_s`` passes."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        with open(log_path, "rb") as f:
            m = re.search(pattern, f.read())
        if m:
            return m
        if proc.poll() is not None:
            raise PhaseError(f"{what} exited {proc.returncode} before "
                             "it was ready")
        time.sleep(0.05)
    raise PhaseError(f"{what} not ready in {deadline_s:.0f}s")


def cpu_seconds(pid: int) -> float:
    """User + system CPU time of ``pid`` so far, from /proc."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(") ", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def reap(proc) -> None:
    if proc is None or proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def descendants(pid: int):
    """Pids of every process below ``pid``, from /proc."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(") ", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(entry))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), ()):
            out.append(child)
            todo.append(child)
    return out


def stop_children():
    """Stop every process this script started that still runs, and
    return the pids of any that would not go.

    Spawning the collective's ranks starts multiprocessing's resource
    tracker, which ignores SIGTERM and otherwise lives on until it reads
    end of file after this process exits: close its pipe and wait for
    it, then kill whatever else is left below this process."""
    from multiprocessing import resource_tracker
    resource_tracker._resource_tracker._stop()
    left = descendants(os.getpid())
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for pid in left:
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
    return descendants(os.getpid())


def query_mix(rng: random.Random, n: int, hosts: int):
    """``(name, qtype, expect)`` triples: ~50% host A, ~20% PTR,
    ~15% service A, ~15% service SRV."""
    from binder_torch.dns import Type, reverse_name_for_ip
    racks = max(1, min(1024, hosts // 512))
    out = []
    for _ in range(n):
        u = rng.random()
        i = rng.randrange(hosts)
        if u < 0.50:
            out.append((host_name(i, racks), Type.A, ("a", {host_addr(i)})))
        elif u < 0.70:
            out.append((reverse_name_for_ip(host_addr(i)), Type.PTR,
                        ("ptr", host_name(i, racks))))
        elif u < 0.85:
            out.append((f"svc.{DOMAIN}", Type.A,
                        ("a", {"10.0.1.1", "10.0.1.2"})))
        else:
            out.append((f"_http._tcp.svc.{DOMAIN}", Type.SRV,
                        ("srv", 2, 8080)))
    return out


def check_reply(msg, expect) -> str:
    """Empty string when ``msg`` answers as expected, else why not."""
    from binder_torch.dns import Rcode, Type
    if msg.rcode != Rcode.NOERROR:
        return f"rcode {msg.rcode}"
    if msg.tc:
        return "unexpected TC=1"
    kind = expect[0]
    if kind == "a":
        got = {r.address for r in msg.answers if r.rtype == Type.A}
        if got != expect[1] or len(msg.answers) != len(expect[1]):
            return f"A answers {sorted(got)}"
    elif kind == "ptr":
        got = [r.target for r in msg.answers if r.rtype == Type.PTR]
        if got != [expect[1]]:
            return f"PTR answers {got}"
    elif kind == "srv":
        count, port = expect[1], expect[2]
        srv = [r for r in msg.answers if r.rtype == Type.SRV]
        if (len(srv) != count or len(msg.answers) != count
                or {r.port for r in srv} != {port}
                or len({r.target for r in srv}) != count):
            return f"SRV answers {[(r.target, r.port) for r in srv]}"
        glue = {r.name for r in msg.additionals if r.rtype == Type.A}
        if len(expect) > 3 and (glue != {r.target for r in srv}
                                or len(glue) != expect[3]):
            return f"SRV additionals {sorted(glue)}"
    return ""


def udp_stream(port: int, queries, concurrency: int):
    """Drive ``queries`` over one UDP socket with ``concurrency`` in
    flight; return ``(latencies_us, errors)``."""
    from binder_torch.dns import Message, make_query
    wires = [make_query(name, qtype, qid=i & 0xFFFF).encode()
             for i, (name, qtype, _) in enumerate(queries)]
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.connect(("127.0.0.1", port))
    sock.setblocking(False)
    lat = []
    errors = []
    pending = {}
    nxt = 0
    deadline = time.monotonic() + UDP_DEADLINE_S
    try:
        while nxt < len(queries) or pending:
            while nxt < len(queries) and len(pending) < concurrency:
                pending[nxt & 0xFFFF] = (nxt, time.perf_counter_ns())
                sock.send(wires[nxt])
                nxt += 1
            ready, _, _ = select.select([sock], [], [], REPLY_STALL_S)
            if not ready or time.monotonic() > deadline:
                errors.append(f"{len(pending)} UDP repl(ies) missing")
                break
            while True:
                try:
                    data = sock.recv(65535)
                except BlockingIOError:
                    break
                t1 = time.perf_counter_ns()
                qid = struct.unpack_from(">H", data)[0]
                sent = pending.pop(qid, None)
                if sent is None:
                    errors.append(f"unsolicited reply id {qid}")
                    continue
                idx, t0 = sent
                lat.append((t1 - t0) / 1000.0)
                why = check_reply(Message.decode(data), queries[idx][2])
                if why:
                    errors.append(f"{queries[idx][0]}: {why}")
    finally:
        sock.close()
    return lat, errors


def tcp_ask(sock, wire: bytes):
    from binder_torch.dns import Message
    sock.sendall(struct.pack(">H", len(wire)) + wire)
    head = _recv_exact(sock, 2)
    return Message.decode(_recv_exact(sock, struct.unpack(">H", head)[0]))


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise PhaseError("serve: TCP connection closed mid-reply")
        buf += chunk
    return buf


def udp_ask(port: int, wire: bytes):
    from binder_torch.dns import Message
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(REPLY_STALL_S)
        s.sendto(wire, ("127.0.0.1", port))
        return Message.decode(s.recv(65535))


def big_checks(port: int, tcp_sock):
    """The 64-instance service: truncated over UDP, whole over TCP."""
    from binder_torch.dns import Type, make_query
    errors = []
    addrs = {f"10.200.0.{k + 1}" for k in range(BIG_INSTANCES)}
    srv_name = f"_http._tcp.big.{DOMAIN}"
    a_name = f"big.{DOMAIN}"
    r = tcp_ask(tcp_sock, make_query(srv_name, Type.SRV, qid=1).encode())
    why = check_reply(r, ("srv", BIG_INSTANCES, 80, BIG_INSTANCES))
    if why:
        errors.append(f"TCP {srv_name}: {why}")
    r = tcp_ask(tcp_sock, make_query(a_name, Type.A, qid=2,
                                     edns_payload=None).encode())
    why = check_reply(r, ("a", addrs))
    if why or any(x.rtype == Type.A for x in r.additionals):
        errors.append(f"TCP {a_name}: {why or 'unexpected additionals'}")
    for name, qtype, payload in ((srv_name, Type.SRV, 1232),
                                 (a_name, Type.A, None)):
        r = udp_ask(port, make_query(name, qtype, qid=3,
                                     edns_payload=payload).encode())
        if not r.tc or r.answers:
            errors.append(f"UDP {name}: TC={int(r.tc)} with "
                          f"{len(r.answers)} answer(s), expected TC=1 "
                          "and none")
    return errors


def tcp_checks(port: int, queries):
    """``queries`` one at a time over one TCP connection, then the
    64-instance service checks; return the errors."""
    from binder_torch.dns import make_query
    errors = []
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=REPLY_STALL_S) as s:
        deadline = time.monotonic() + TCP_DEADLINE_S
        for i, (name, qtype, expect) in enumerate(queries):
            if time.monotonic() > deadline:
                errors.append("TCP stream past its deadline")
                break
            why = check_reply(tcp_ask(s, make_query(
                name, qtype, qid=i).encode()), expect)
            if why:
                errors.append(f"TCP {name}: {why}")
        errors += big_checks(port, s)
    return errors


def serve_phase(hosts: int = HOSTS, n_udp: int = N_UDP,
                n_tcp: int = N_TCP):
    """Boot the port's server and drive it; return the UDP latencies
    (microseconds).  Raises PhaseError on any wrong or missing
    answer."""
    rng = random.Random(SEED)
    proc = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        try:
            t0 = time.monotonic()
            proc, port = boot_server(write_config(tmp, hosts),
                                     os.path.join(tmp, "server.log"))
            boot_s = time.monotonic() - t0
            udp_q = query_mix(rng, n_udp, hosts)
            server_cpu0 = cpu_seconds(proc.pid)
            client_cpu0 = time.process_time()
            t0 = time.monotonic()
            lat, errors = udp_stream(port, udp_q, CONCURRENCY)
            udp_s = time.monotonic() - t0
            # the busy share of each side over the UDP stream says
            # which one held the rate down
            server_busy = (cpu_seconds(proc.pid) - server_cpu0) / udp_s
            client_busy = (time.process_time() - client_cpu0) / udp_s
            errors += tcp_checks(port, query_mix(rng, n_tcp, hosts))
            if proc.poll() is not None:
                errors.append(f"server exited {proc.returncode} mid-run")
        finally:
            reap(proc)
    pct = np.percentile(np.asarray(lat, np.float64), [50, 99]) \
        if lat else [float("nan")] * 2
    log(json.dumps({
        "serve": {"zone_names": hosts, "boot_s": boot_s,
                  "udp_queries": n_udp, "udp_answered": len(lat),
                  "tcp_queries": n_tcp + 2, "udp_big_tc_checks": 2,
                  "errors": len(errors), "udp_qps": len(lat) / udp_s,
                  "udp_p50_us": float(pct[0]), "udp_p99_us": float(pct[1]),
                  "udp_server_cpu_busy": server_busy,
                  "udp_client_cpu_busy": client_busy}}))
    if errors:
        for e in errors[:20]:
            log("serve error: " + e)
        raise PhaseError(f"serve: {len(errors)} wrong or missing "
                         "answer(s)")
    return lat


# -- phase 3: deploy --------------------------------------------------

DEPLOY_SHARDS = 4
DEPLOY_UDP = 60_000
FLOWS = 16
CHURN_NAMES = 64
CHURN_INTERVAL_S = 0.002
FRESH_LIMIT_S = 5.0
RETRY_AFTER_S = 1.0
KILL_AT = 0.5
DEPLOY_BOOT_DEADLINE_S = 300.0
DRAIN_DEADLINE_S = 30.0
MANIFEST = os.path.join("deploy", "config", "manifest.json")

#: the Triton branch of the deploy template: the one with recursion
TRITON_METADATA = {
    "dns_domain": DOMAIN, "datacenter_name": "dc0", "region_name": "home",
    "ufds_domain": f"ufds.{DOMAIN}", "ufds_ldap_root_dn": "cn=root",
    "ufds_ldap_root_pw": "secret",
    "auto": {"ZONENAME": "chip-smoke-zone", "SERVER_UUID": "chip-smoke"},
    "SERVICE_NAME": "binder",
}

#: the peer datacenter's names, served by its own process
DC1_HOSTS = {"web": "10.77.0.1", "db": "10.77.0.2"}


def churn_name(k: int) -> str:
    return f"c{k:02d}.churn.{DOMAIN}"


def churn_addr(w: int) -> str:
    """Address of churn write ``w`` (0, 1, ...): monotone in ``w``, so a
    probe can tell a newer write from an older one."""
    return f"10.{210 + (w >> 16)}.{(w >> 8) & 255}.{w & 255}"


def churn_write(addr: str) -> int:
    _, b, c, d = (int(x) for x in addr.split("."))
    return ((b - 210) << 16) | (c << 8) | d if b >= 210 else -1


def host_json(addr: str) -> bytes:
    return b'{"type": "host", "host": {"address": "%s"}}' % addr.encode()


def zone_nodes(hosts: int):
    """``(path, data)`` in creation order, parents first: the serve
    phase's zone (synthetic hosts in racks, the fixture, the ``big``
    service) plus the churn names.  The last one is the last host."""
    racks = max(1, min(1024, hosts // 512))
    leaves = {}
    with open(os.path.join(ROOT, "etc", "fixture.json")) as f:
        for path, obj in json.load(f).items():
            leaves[path] = json.dumps(obj).encode()
    leaves["/com/foo/big"] = json.dumps(BIG_SERVICE).encode()
    for k in range(BIG_INSTANCES):
        leaves[f"/com/foo/big/lb{k}"] = json.dumps({
            "type": "load_balancer",
            "load_balancer": {"address": f"10.200.0.{k + 1}"}}).encode()
    for k in range(CHURN_NAMES):
        leaves[f"/com/foo/churn/c{k:02d}"] = host_json(f"10.209.0.{k}")
    for r in range(racks):
        leaves[f"/com/foo/zs/r{r:04d}"] = (
            b'{"type": "service", "service": {"srvce": "_zs", '
            b'"proto": "_tcp", "port": 80}}')
    for i in range(hosts):
        leaves[f"/com/foo/zs/r{i % racks:04d}/h{i:06d}"] = \
            host_json(host_addr(i))
    nodes = {}
    for path, data in leaves.items():
        parts = path.split("/")[1:]
        for d in range(1, len(parts)):
            nodes.setdefault("/" + "/".join(parts[:d]), b"")
        nodes[path] = data
    return sorted(nodes.items(), key=lambda kv: kv[0].count("/"))


async def zk_connect(port: int):
    from binder_torch.store.zk_client import ZKClient
    import asyncio
    client = ZKClient(address="127.0.0.1", port=port,
                      session_timeout_ms=30000)
    client.start()
    deadline = time.monotonic() + 30
    while not client.is_connected():
        if time.monotonic() > deadline:
            raise PhaseError("deploy: no ZooKeeper session in 30s")
        await asyncio.sleep(0.01)
    return client


async def zk_create_all(port: int, items) -> None:
    """Create every ``(path, data)``.  The client keeps at most
    ``MAX_IN_FLIGHT`` requests outstanding and sends them in order, and
    one connection answers in order, so a parent always exists before
    its children."""
    import asyncio
    client = await zk_connect(port)
    try:
        await asyncio.gather(*(client.create(path, data)
                               for path, data in items))
    finally:
        client.close()


async def zk_set(port: int, path: str, data: bytes) -> None:
    client = await zk_connect(port)
    try:
        await client.mkdirp(path, data)
    finally:
        client.close()


def boot_peer(tmp: str):
    """The peer datacenter ``dc1``: a single-process port server on
    127.0.0.2 over a fake store holding ``*.dc1`` names."""
    fixture = {"/com/foo/dc1": {"type": "service",
                                 "service": {"port": 53}}}
    for name, addr in DC1_HOSTS.items():
        fixture[f"/com/foo/dc1/{name}"] = {
            "type": "host", "host": {"address": addr, "ttl": 44}}
    with open(os.path.join(tmp, "dc1-fixture.json"), "w") as f:
        json.dump(fixture, f)
    config = os.path.join(tmp, "dc1.json")
    with open(config, "w") as f:
        json.dump({"dnsDomain": DOMAIN, "datacenterName": "dc1",
                   "host": "127.0.0.2", "queryLog": False,
                   "store": {"backend": "fake", "fixture": os.path.join(
                       tmp, "dc1-fixture.json")},
                   "rrl": {"allowlist": ["127.0.0.0/8"]}}, f)
    return boot_server(config, os.path.join(tmp, "dc1.log"),
                       "deploy: peer dc1")


def deploy_config(tmp: str, zk_port: int, dc1_port: int,
                  shards: int) -> str:
    """The deploy template rendered with Triton metadata, plus only
    what a loopback run needs; each override is printed."""
    from binder_torch.config.render import render_manifest
    options = json.loads(render_manifest(
        os.path.join(ROOT, MANIFEST), TRITON_METADATA, output_path=None))
    overrides = {
        "host": "127.0.0.1", "port": 0, "shards": shards,
        "store.port": zk_port, "queryLog": False,
        "rrl": {"allowlist": ["127.0.0.0/8"]},
        # no directory on loopback: a static map in the ``ufds`` block
        # stands in for UFDS discovery (dc1 on 127.0.0.2, outside the
        # self-address filter that covers 127.0.0.1)
        "recursion.ufds": {"dcs": {"dc1": [f"127.0.0.2:{dc1_port}"]}},
    }
    for key, value in overrides.items():
        *parents, leaf = key.split(".")
        node = options
        for name in parents:
            node = node[name]
        node[leaf] = value
        log(f"deploy override: {key} = {json.dumps(value)}")
    path = os.path.join(tmp, "deploy.json")
    with open(path, "w") as f:
        json.dump(options, f)
    return path


def http_json(port: int, path: str):
    import urllib.request
    for _ in range(50):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                body = r.read()
            return json.loads(body) if path == "/status" else body.decode()
        except OSError:
            time.sleep(0.1)
    raise PhaseError(f"deploy: no answer from :{port}{path}")


def shard_series(mport: int, family: str):
    """``{shard: value}`` of one ``binder_shard_*`` counter family."""
    out = {}
    pattern = re.compile(re.escape(family)
                         + r'\{[^}]*shard="(\d+)"[^}]*\} (\S+)$')
    for line in http_json(mport, "/metrics").splitlines():
        m = pattern.match(line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def cmdline(pid: int) -> str:
    with open(f"/proc/{pid}/cmdline", "rb") as f:
        return f.read().replace(b"\0", b" ").decode()


def fresh_ask(port: int, name: str, qid: int, host: str = "127.0.0.1",
              rd: bool = False) -> bytes:
    """One A query on a fresh socket (a fresh reuseport draw)."""
    from binder_torch.dns import Type, make_query
    q = make_query(name, Type.A, qid=qid, rd=rd).encode()
    for _ in range(3):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(REPLY_STALL_S / 5)
            s.sendto(q, (host, port))
            try:
                return s.recv(65535)
            except socket.timeout:
                continue
    raise PhaseError(f"deploy: no answer for {name}")


def a_addrs(data: bytes):
    from binder_torch.dns import Message
    return [r.address for r in Message.decode(data).answers
            if hasattr(r, "address")]


def wait_everywhere(port: int, name: str, addr: str, flows: int,
                    deadline_s: float) -> float:
    """Seconds until ``flows`` fresh sockets all get ``addr``."""
    t0 = time.monotonic()
    while True:
        if all(a_addrs(fresh_ask(port, name, k + 1)) == [addr]
               for k in range(flows)):
            return time.monotonic() - t0
        if time.monotonic() - t0 > deadline_s:
            raise PhaseError(f"deploy: {name} did not serve {addr} on "
                             f"{flows} flows in {deadline_s:.0f}s")
        time.sleep(0.05)


def zone_sweep(port: int, hosts: int, deadline: float) -> None:
    """Ask every host's A record over ``FLOWS`` sockets, again and
    again for the ones not yet right, until all are or ``deadline``."""
    racks = max(1, min(1024, hosts // 512))
    todo = list(range(hosts))
    while todo:
        queries = [(host_name(i, racks), 1, ("a", {host_addr(i)}))
                   for i in todo]
        _, errors, _ = udp_flows(port, queries, FLOWS, CONCURRENCY)
        wrong = {e.split(":")[0] for e in errors}
        todo = [i for i in todo if host_name(i, racks) in wrong]
        if todo and time.monotonic() > deadline:
            raise PhaseError(f"deploy: {len(todo)} host(s) still not "
                             f"served right, e.g. {errors[:3]}")
        if todo:
            time.sleep(0.5)


def udp_flows(port: int, queries, flows: int, concurrency: int,
              on_progress=None):
    """Drive ``queries`` over ``flows`` UDP sockets (distinct source
    ports, so SO_REUSEPORT spreads them over the group) with
    ``concurrency`` in flight in all; a query unanswered after
    ``RETRY_AFTER_S`` is sent once more.  Returns ``(latencies_us,
    errors, retries)``."""
    from binder_torch.dns import Message, make_query
    wires = [make_query(name, qtype, qid=i & 0xFFFF).encode()
             for i, (name, qtype, _) in enumerate(queries)]
    per = max(1, concurrency // flows)
    socks = []
    for _ in range(flows):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("127.0.0.1", port))
        s.setblocking(False)
        socks.append(s)
    by_fd = {s.fileno(): k for k, s in enumerate(socks)}
    pending = [dict() for _ in socks]     # qid -> [idx, t_first, t_sent]
    retried = [set() for _ in socks]
    lat, errors = [], []
    retries = 0
    nxt = done = 0
    deadline = time.monotonic() + UDP_DEADLINE_S
    try:
        while nxt < len(queries) or any(pending):
            for k, s in enumerate(socks):
                while nxt < len(queries) and len(pending[k]) < per:
                    now = time.perf_counter_ns()
                    pending[k][nxt & 0xFFFF] = [nxt, now, now]
                    s.send(wires[nxt])
                    nxt += 1
            ready, _, _ = select.select(socks, [], [], 0.05)
            for s in ready:
                k = by_fd[s.fileno()]
                while True:
                    try:
                        data = s.recv(65535)
                    except BlockingIOError:
                        break
                    t1 = time.perf_counter_ns()
                    qid = struct.unpack_from(">H", data)[0]
                    entry = pending[k].pop(qid, None)
                    if entry is None:
                        if qid not in retried[k]:
                            errors.append(f"unsolicited reply id {qid}")
                        continue
                    idx, t_first, _ = entry
                    lat.append((t1 - t_first) / 1000.0)
                    done += 1
                    why = check_reply(Message.decode(data),
                                      queries[idx][2])
                    if why:
                        errors.append(f"{queries[idx][0]}: {why}")
                    if on_progress is not None:
                        on_progress(done)
            now = time.perf_counter_ns()
            for k, s in enumerate(socks):
                for qid, entry in list(pending[k].items()):
                    if now - entry[2] < RETRY_AFTER_S * 1e9:
                        continue
                    if qid in retried[k]:
                        errors.append(f"{queries[entry[0]][0]}: no reply "
                                      "to the query or its retry")
                        del pending[k][qid]
                        continue
                    retried[k].add(qid)
                    retries += 1
                    entry[2] = now
                    s.send(wires[entry[0]])
            if time.monotonic() > deadline:
                errors.append("UDP stream past its deadline")
                break
    finally:
        for s in socks:
            s.close()
    return lat, errors, retries


# the churn process: writes through its own ZooKeeper session and
# probes the group from its own sockets, so neither competes with the
# query stream for this process's interpreter


def probe_until(socks, name: str, want_w: int, k: int,
                deadline: float) -> bool:
    """Ask ``name`` on every socket until each returns churn write
    ``want_w`` or a later one of name ``k``."""
    from binder_torch.dns import Type, make_query
    left = list(socks)
    qid = 0
    while left:
        if time.monotonic() > deadline:
            return False
        qid = (qid + 1) & 0xFFFF
        q = make_query(name, Type.A, qid=qid).encode()
        for s in left:
            s.send(q)
        got = {}
        t_end = time.monotonic() + 0.5
        while len(got) < len(left) and time.monotonic() < t_end:
            ready, _, _ = select.select(left, [], [], 0.05)
            for s in ready:
                try:
                    data = s.recv(65535)
                except (BlockingIOError, ConnectionRefusedError):
                    continue
                if struct.unpack_from(">H", data)[0] == qid:
                    got[s] = data
        done = []
        for s, data in got.items():
            addrs = a_addrs(data)
            if len(addrs) == 1:
                w = churn_write(addrs[0])
                if w >= want_w and w % CHURN_NAMES == k % CHURN_NAMES:
                    done.append(s)
        left = [s for s in left if s not in done]
    return True


def churn_main(zk_port: int, dns_port: int) -> int:
    import asyncio
    import threading
    socks = []
    for _ in range(FLOWS):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("127.0.0.1", dns_port))
        s.setblocking(False)
        socks.append(s)
    latest = [None]          # the newest acknowledged write to probe
    fresh_ms, stale = [], []
    done = threading.Event()

    def prober():
        while not done.is_set():
            item, latest[0] = latest[0], None
            if item is None:
                time.sleep(0.001)
                continue
            k, w, t_ack = item
            ok = probe_until(socks, churn_name(k), w, k,
                             t_ack + FRESH_LIMIT_S)
            (fresh_ms if ok else stale).append(
                (time.monotonic() - t_ack) * 1000.0)

    async def run():
        client = await zk_connect(zk_port)
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        threading.Thread(target=lambda: (sys.stdin.read(),
                                         loop.call_soon_threadsafe(
                                             stop.set)),
                         daemon=True).start()
        print("churn: ready", flush=True)
        last = {}
        w = 0
        t0 = t_next = time.monotonic()
        while not stop.is_set():
            k = w % CHURN_NAMES
            await client.set_data(f"/com/foo/churn/c{k:02d}",
                                  host_json(churn_addr(w)))
            last[k] = w
            latest[0] = (k, w, time.monotonic())
            w += 1
            t_next += CHURN_INTERVAL_S
            await asyncio.sleep(max(0.0, t_next - time.monotonic()))
        elapsed = time.monotonic() - t0
        client.close()
        return last, w, elapsed

    thread = threading.Thread(target=prober, daemon=True)
    thread.start()
    last, writes, elapsed = asyncio.run(run())
    done.set()
    thread.join()
    # every acknowledged write is read back from every probe socket
    t_stop = time.monotonic()
    final_ok = all(probe_until(socks, churn_name(k), w, k,
                               t_stop + FRESH_LIMIT_S)
                   for k, w in sorted(last.items()))
    final_s = time.monotonic() - t_stop
    for s in socks:
        s.close()
    print(json.dumps({"writes": writes, "seconds": elapsed,
                      "fresh_ms": fresh_ms, "stale_ms": stale,
                      "final_ok": final_ok, "final_s": final_s}),
          flush=True)
    return 0


def cross_dc(port: int, dc1_port: int):
    """A dc1 name asked of dc0's group must come back as dc1 itself
    answers it, but for the ID and the RA bit."""
    errors = []
    for k, name in enumerate(sorted(DC1_HOSTS)):
        fqdn = f"{name}.dc1.{DOMAIN}"
        via = bytearray(fresh_ask(port, fqdn, 0x100 + k, rd=True))
        direct = bytearray(fresh_ask(dc1_port, fqdn, 0x200 + k,
                                     host="127.0.0.2", rd=True))
        if a_addrs(bytes(via)) != [DC1_HOSTS[name]]:
            errors.append(f"{fqdn} via dc0: {a_addrs(bytes(via))}")
        via[3] &= 0x7F
        direct[3] &= 0x7F
        if via[2:] != direct[2:]:
            errors.append(f"{fqdn}: dc0's forward differs from dc1's "
                          "own answer beyond ID and RA")
    return errors


def started_s_ago(pid: int) -> float:
    """Seconds since ``pid`` started, from /proc."""
    with open(f"/proc/{pid}/stat") as f:
        start = int(f.read().rsplit(") ", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start / os.sysconf("SC_CLK_TCK")


def worker_busy(mport: int, workers, cpu0, t0: float, killed):
    """CPU busy share of every worker over the stream, by shard.  The
    killed worker's share runs to its kill, its successor's from its
    own start; a successor not yet up is listed with no share."""
    out = []
    now = time.monotonic()
    for w in workers:
        pid = w["pid"]
        if pid == killed["pid"]:
            out.append({"shard": w["shard"], "pid": pid, "ended": "SIGKILL",
                        "over_s": killed["at"] - t0,
                        "busy": (killed["cpu"] - cpu0[pid])
                        / (killed["at"] - t0)})
            continue
        out.append({"shard": w["shard"], "pid": pid, "over_s": now - t0,
                    "busy": (cpu_seconds(pid) - cpu0[pid]) / (now - t0)})
    new = http_json(mport, "/status")["shards"]["workers"][killed["shard"]]
    entry = {"shard": killed["shard"], "pid": new["pid"],
             "respawned": True, "over_s": None, "busy": None}
    if new["pid"] not in (None, killed["pid"]):
        try:
            cpu, up = cpu_seconds(new["pid"]), started_s_ago(new["pid"])
            entry.update(over_s=up, busy=cpu / up)
        except OSError:
            pass
    out.append(entry)
    return out


def deploy_phase(hosts: int = HOSTS, n_udp: int = DEPLOY_UDP,
                 shards: int = DEPLOY_SHARDS):
    """The production shape over the port: the deploy template, the
    port's ZooKeeper server at the serve phase's zone, a reuseport
    group of ``shards`` workers under churn and a worker crash, and a
    cross-DC forward.  Returns the stream's latencies (microseconds)."""
    import asyncio
    rng = random.Random(SEED + 1)
    procs = []
    report = {"zone_names": hosts, "shards": shards}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as tmp:
        try:
            zk_log = os.path.join(tmp, "zk.log")
            zk = spawn(["-m", "binder_torch.store.zk_testserver", "0"],
                       zk_log)
            procs.append(zk)
            zk_port = int(wait_line(zk, zk_log,
                                    rb"listening on [\d.]+:(\d+)",
                                    "deploy: ZooKeeper server",
                                    60).group(1))
            nodes = zone_nodes(hosts)
            t0 = time.monotonic()
            asyncio.run(zk_create_all(zk_port, nodes))
            report["zk_znodes"] = len(nodes)
            report["seed_s"] = time.monotonic() - t0
            log(f"deploy: seeded {len(nodes)} znodes in "
                f"{report['seed_s']}s")

            peer, dc1_port = boot_peer(tmp)
            procs.append(peer)
            config = deploy_config(tmp, zk_port, dc1_port, shards)

            group_log = os.path.join(tmp, "group.log")
            t0 = time.monotonic()
            group = spawn(["-m", "binder_torch.main", "-f", config,
                           "-p", "0"], group_log)
            procs.append(group)
            wait_line(group, group_log,
                      rb"TCP DNS service started on [\d.]+:\d+",
                      "deploy: shard group", DEPLOY_BOOT_DEADLINE_S)
            with open(group_log, "rb") as f:
                text = f.read()
            port = int(re.search(rb"UDP DNS service started on "
                                 rb"[\d.]+:(\d+)", text).group(1))
            mport = int(re.search(rb"metrics server started on port "
                                  rb"(\d+)", text).group(1))
            last = host_name(hosts - 1, max(1, min(1024, hosts // 512)))
            while a_addrs(fresh_ask(port, last, 1)) != [host_addr(hosts - 1)]:
                if time.monotonic() - t0 > DEPLOY_BOOT_DEADLINE_S:
                    raise PhaseError(f"deploy: {last} not served in "
                                     f"{DEPLOY_BOOT_DEADLINE_S:.0f}s")
                time.sleep(0.05)
            report["boot_first_answer_s"] = time.monotonic() - t0
            # the last host answering is not the whole zone: the owner
            # fetches data of earlier znodes in the same pipelined walk
            zone_sweep(port, hosts, t0 + DEPLOY_BOOT_DEADLINE_S)
            report["boot_zone_served_s"] = time.monotonic() - t0
            log(f"deploy: group served the last host after "
                f"{report['boot_first_answer_s']}s and every host on "
                f"{FLOWS} flows after {report['boot_zone_served_s']}s")

            workers = http_json(mport, "/status")["shards"]["workers"]
            pids = [w["pid"] for w in workers]
            if len(set(pids)) != shards or group.pid in pids:
                raise PhaseError(f"deploy: worker pids {pids}")
            for pid in pids:
                line = cmdline(pid)
                if "-m binder_torch.main" not in line or \
                        "binder_tpu" in line:
                    raise PhaseError(f"deploy: worker {pid} runs {line!r}")
            report["workers_run"] = "binder_torch.main"

            # churn and a worker crash under the query stream
            churn = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--churn",
                 str(zk_port), str(port)], cwd=ROOT,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            procs.append(churn)
            if churn.stdout.readline().strip() != b"churn: ready":
                raise PhaseError("deploy: churn process did not start")
            requests0 = shard_series(mport, "binder_shard_requests")
            queries = query_mix(rng, n_udp, hosts)
            killed = {}

            def on_progress(done):
                if not killed and done >= n_udp * KILL_AT:
                    snap = http_json(mport, "/status")["shards"]["workers"]
                    victim = snap[shards - 1]["pid"]
                    cpu = cpu_seconds(victim)
                    os.kill(victim, signal.SIGKILL)
                    killed.update(pid=victim, shard=shards - 1, cpu=cpu,
                                  at=time.monotonic())

            cpu0 = {pid: cpu_seconds(pid) for pid in pids + [group.pid]}
            client_cpu0 = time.process_time()
            t0 = time.monotonic()
            lat, errors, retries = udp_flows(port, queries, FLOWS,
                                             CONCURRENCY, on_progress)
            udp_s = time.monotonic() - t0
            report.update(udp_queries=n_udp, udp_answered=len(lat),
                          udp_retries=retries, udp_qps=len(lat) / udp_s)
            report["client_cpu_busy"] = \
                (time.process_time() - client_cpu0) / udp_s
            report["supervisor_cpu_busy"] = \
                (cpu_seconds(group.pid) - cpu0[group.pid]) / udp_s
            if not killed:
                raise PhaseError("deploy: no worker was killed")
            report["worker_cpu_busy"] = worker_busy(mport, workers, cpu0,
                                                    t0, killed)
            churn.stdin.close()
            out = churn.stdout.read().decode().strip().splitlines()
            if churn.wait(timeout=60) != 0 or not out:
                raise PhaseError("deploy: churn process failed")
            churned = json.loads(out[-1])
            fresh = np.asarray(churned["fresh_ms"], np.float64)
            report["churn"] = {
                "writes": churned["writes"],
                "writes_per_s": churned["writes"] / churned["seconds"],
                "fresh_samples": int(fresh.size),
                "fresh_p50_ms": float(np.percentile(fresh, 50))
                if fresh.size else None,
                "fresh_p99_ms": float(np.percentile(fresh, 99))
                if fresh.size else None,
                "stale_samples": len(churned["stale_ms"]),
                "all_read_back": churned["final_ok"],
                "read_back_s": churned["final_s"]}
            if churned["stale_ms"] or not churned["final_ok"] or \
                    not fresh.size:
                errors.append("churn: an acknowledged write was not read "
                              f"back within {FRESH_LIMIT_S:.0f}s")
            errors += tcp_checks(port, query_mix(rng, N_TCP, hosts))

            # the crashed worker: respawned under a new pid, serving a
            # write made after the crash
            deadline = time.monotonic() + 30
            while True:
                w = http_json(mport, "/status")["shards"]["workers"][
                    killed["shard"]]
                if w["pid"] not in (None, killed["pid"]) and w["up"]:
                    break
                if time.monotonic() > deadline:
                    raise PhaseError("deploy: killed worker not respawned")
                time.sleep(0.1)
            if "binder_tpu" in cmdline(w["pid"]):
                raise PhaseError("deploy: respawned worker runs the "
                                 "reference")
            respawns = shard_series(mport, "binder_shard_respawns")
            before = shard_series(mport, "binder_shard_requests")
            asyncio.run(zk_set(zk_port, "/com/foo/postkill",
                               host_json("10.203.0.1")))
            report["post_kill_write_s"] = wait_everywhere(
                port, f"postkill.{DOMAIN}", "10.203.0.1", 64, 10.0)
            time.sleep(1.5)     # one stats report from every worker
            after = shard_series(mport, "binder_shard_requests")
            report["respawn"] = {
                "shard": killed["shard"], "old_pid": killed["pid"],
                "new_pid": w["pid"],
                "respawns": respawns.get(killed["shard"], 0),
                "requests_after_respawn":
                    after.get(killed["shard"], 0)
                    - before.get(killed["shard"], 0)}
            if respawns.get(killed["shard"], 0) < 1 or \
                    report["respawn"]["requests_after_respawn"] <= 0:
                errors.append(f"respawn: {report['respawn']}")
            report["shard_requests"] = {
                s: after.get(s, 0) - requests0.get(s, 0)
                for s in range(shards)}
            if len(report["shard_requests"]) != shards or \
                    min(report["shard_requests"].values()) <= 0:
                errors.append(f"a shard served nothing: "
                              f"{report['shard_requests']}")

            cross = cross_dc(port, dc1_port)
            report["cross_dc_names"] = len(DC1_HOSTS)
            errors += cross

            # drain: SIGTERM the supervisor, then nothing is left
            live = [x["pid"] for x in
                    http_json(mport, "/status")["shards"]["workers"]]
            group.send_signal(signal.SIGTERM)
            try:
                rc = group.wait(timeout=DRAIN_DEADLINE_S)
            except subprocess.TimeoutExpired:
                raise PhaseError("deploy: supervisor did not drain")
            report["drain_rc"] = rc
            if rc != 0:
                errors.append(f"supervisor exited {rc} on SIGTERM")
            deadline = time.monotonic() + 10
            while any(os.path.exists(f"/proc/{p}") for p in live):
                if time.monotonic() > deadline:
                    errors.append(f"workers {live} outlived the drain")
                    break
                time.sleep(0.05)
            report["errors"] = len(errors)
        except PhaseError:
            # what the processes said last, for the failure's reader
            for name in ("zk.log", "dc1.log", "group.log"):
                path = os.path.join(tmp, name)
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        tail = f.read()[-3000:].decode(errors="replace")
                    log(f"--- {name} (last 3000 bytes) ---\n{tail}")
            raise
        finally:
            for proc in reversed(procs):
                reap(proc)
        left = descendants(os.getpid())
        report["left_after_drain"] = left
    pct = np.percentile(np.asarray(lat, np.float64), [50, 99]) \
        if lat else [float("nan")] * 2
    report.update(udp_p50_us=float(pct[0]), udp_p99_us=float(pct[1]))
    log(json.dumps({"deploy": report}))
    if errors or left:
        for e in errors[:20]:
            log("deploy error: " + e)
        raise PhaseError(f"deploy: {len(errors)} error(s), "
                         f"{len(left)} process(es) left")
    return lat


# -- phase 4: aggregate -----------------------------------------------


def reference_percentile(ordered: np.ndarray, q: float) -> np.float32:
    """``jnp.percentile(x, q)`` (linear) in numpy: float32 rank with
    ``n`` rounded to float32, ``low * (1 - w)`` fused into the add."""
    n = np.float32(ordered.size)
    rank = np.float32(q) / np.float32(100) * (n - np.float32(1))
    low, high = np.floor(rank), np.ceil(rank)
    hw = rank - low
    lw = np.float32(1) - hw
    last = int(n) - 1
    lo = ordered[min(max(int(low), 0), last)]
    hi = ordered[min(max(int(high), 0), last)]
    return np.float32(np.float64(lo) * np.float64(lw)
                      + np.float64(np.float32(hi * hw)))


def hold_aggregate(torch, aggregate, x: np.ndarray, label: str) -> None:
    """Run the port's aggregate on cuda over ``x``, hold it against
    numpy, and time it."""
    dev = torch.from_numpy(x).to("cuda")
    mean, p50, p99 = (float(v) for v in aggregate(dev))
    torch.cuda.synchronize()
    ordered = np.sort(x)
    ref_mean = float(np.mean(x, dtype=np.float64))
    fails = []
    if not abs(mean - ref_mean) <= MEAN_RTOL * abs(ref_mean):
        fails.append(f"mean {mean!r} vs {ref_mean!r}")
    dev_max = abs(mean - ref_mean)
    for q, got in ((50.0, p50), (99.0, p99)):
        ref = reference_percentile(ordered, q)
        if np.float32(got) != ref:
            fails.append(f"p{q:g} {got!r} vs the reference rule {ref!r}")
        # numpy ranks in float64: it may sit up to one order
        # statistic away from the float32 rank the reference uses
        r = q / 100 * (x.size - 1)
        lo = ordered[max(int(np.floor(r)) - 1, 0)]
        hi = ordered[min(int(np.ceil(r)) + 1, x.size - 1)]
        npv = float(np.percentile(x, q))
        if not lo <= got <= hi:
            fails.append(f"p{q:g} {got!r} outside [{lo!r}, {hi!r}] "
                         f"around np.percentile {npv!r}")
        dev_max = max(dev_max, abs(got - npv))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        aggregate(dev)
    start.record()
    for _ in range(20):
        aggregate(dev)
    end.record()
    torch.cuda.synchronize()
    log(json.dumps({"aggregate": {
        "batch": label, "n": int(x.size), "mean": mean, "p50": p50,
        "p99": p99, "max_abs_dev_vs_numpy": dev_max,
        "ms": start.elapsed_time(end) / 20}}))
    if fails:
        raise PhaseError(f"aggregate ({label}): " + "; ".join(fails))


def aggregate_phase(torch, latencies, sharded) -> None:
    from binder_torch.graft_entry import entry
    aggregate, (example,) = entry()
    if example.device.type != "cuda":
        raise PhaseError("aggregate: entry() example is not on cuda")
    hold_aggregate(torch, aggregate,
                   np.asarray(latencies, np.float32), "served latencies")
    hold_aggregate(torch, aggregate,
                   np.asarray(sharded, np.float32), "sharded latencies")
    rng = np.random.default_rng(SEED)
    big = rng.lognormal(mean=5.0, sigma=1.0,
                        size=LARGE_BATCH).astype(np.float32)
    hold_aggregate(torch, aggregate, big, "lognormal 2**24+1")


# -- phase 5: collective ----------------------------------------------


def collective_phase() -> None:
    from binder_torch.graft_entry import dryrun_multichip, run_ranks
    dryrun_multichip(1)
    (mean,) = run_ranks(1, "cuda", timeout_s=RANK_DEADLINE_S)
    expect = float(np.mean(np.linspace(0.0, 1.0, 8, dtype=np.float32),
                           dtype=np.float64))
    log(json.dumps({"collective": {"backend": "nccl", "ranks": 1,
                                   "mean": mean, "expected": expect}}))
    if abs(mean - expect) > 1e-6:
        raise PhaseError(f"collective: mean {mean!r} != {expect!r}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "binder_torch")):
        print("chip_smoke: binder_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--churn"]:
        return churn_main(int(sys.argv[2]), int(sys.argv[3]))
    try:
        torch = device_phase()
        latencies = serve_phase()
        sharded = deploy_phase()
        aggregate_phase(torch, latencies, sharded)
        collective_phase()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        left = stop_children()
    if left:
        print(f"chip_smoke: FAILED: process(es) {left} would not stop",
              file=sys.stderr)
        return 1
    log(json.dumps({"kernels": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
