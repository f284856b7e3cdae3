#!/usr/bin/env python3
"""Start the PyTorch port (``binder_torch``) on one GPU, end to end.

Run from the root of a checkout on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, each under its own deadline; any failure reaps the server and
exits non-zero without printing the ``ok`` line:

1. device: require CUDA; print the card's name and power limit.
2. serve: boot ``python -m binder_torch.main`` on a 100,000-name
   synthetic zone plus the shipped fixture and a 64-instance service,
   send a seeded A/PTR/SRV mix over UDP (concurrency 64) and TCP, and
   check every answer; record per-query latencies.
3. aggregate: the port's latency summary (mean, p50, p99) on ``cuda``
   over those latencies and over a seeded 2**24 + 1 batch, held
   against numpy.
4. collective: the data-parallel mean over NCCL on the one card.

The port has no hand-written kernel (the JAX package has no Pallas
kernel to port), so the kernel line is an empty list.  The last line
is ``{"ok": true, "device": {...}}``.
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


def boot_server(config_path: str, log_path: str):
    out = open(log_path, "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "binder_torch.main", "-f", config_path,
         "-p", "0"],
        cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    out.close()
    deadline = time.monotonic() + BOOT_DEADLINE_S
    pattern = re.compile(rb"UDP DNS service started on [\d.]+:(\d+)")
    while time.monotonic() < deadline:
        with open(log_path, "rb") as f:
            m = pattern.search(f.read())
        if m:
            return proc, int(m.group(1))
        if proc.poll() is not None:
            raise PhaseError(f"serve: server exited {proc.returncode} "
                             "before it served")
        time.sleep(0.1)
    raise PhaseError("serve: no 'UDP DNS service started' line within "
                     f"{BOOT_DEADLINE_S:.0f}s")


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


# -- phase 3: aggregate -----------------------------------------------


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


def aggregate_phase(torch, latencies) -> None:
    from binder_torch.graft_entry import entry
    aggregate, (example,) = entry()
    if example.device.type != "cuda":
        raise PhaseError("aggregate: entry() example is not on cuda")
    hold_aggregate(torch, aggregate,
                   np.asarray(latencies, np.float32), "served latencies")
    rng = np.random.default_rng(SEED)
    big = rng.lognormal(mean=5.0, sigma=1.0,
                        size=LARGE_BATCH).astype(np.float32)
    hold_aggregate(torch, aggregate, big, "lognormal 2**24+1")


# -- phase 4: collective ----------------------------------------------


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
    try:
        torch = device_phase()
        latencies = serve_phase()
        aggregate_phase(torch, latencies)
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
