#!/usr/bin/env python3
"""Start the PyTorch port (``binder_torch``) on one GPU host, end to end.

Run from the root of a checkout on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, each under its own deadline; any failure reaps every process
it started and exits non-zero without printing the ``ok`` line:

1. device: print the card's name and power limit (``nvidia-smi``);
   then, beside phase 2, require CUDA.
2. native: build the port's native code from ``native/`` with the
   port's fixes (``fastio_build.FIXES``; the fast-path
   extension ``_binderfastio``, the ``mbalancer`` binary and the
   ``instance_adjust`` reconciler, through ``binder_torch.fastio_build``)
   and print the seconds each build took; check the extension loaded
   from the port's build directory with every function; replay a
   seeded query mix through one in-process ``BinderServer`` on the C
   lane and again on the Python lane and hold the replies byte for
   byte (multi-record answers by record set: the lanes rotate
   independently).  The same ``build_all`` call also builds what the
   check phase runs (``zlogcat``, ``dnsblast``, the ``-Werror``
   builds, the ASan extension, the fuzzers), so the compilers overlap.
3. serve: boot ``python -m binder_torch.main`` on a 100,000-name
   synthetic zone plus the shipped fixture and a 64-instance service,
   send a seeded A/PTR/SRV mix over UDP (concurrency 64) and TCP, and
   check every answer; record per-query latencies; the server's
   ``/metrics`` must show the C lane resident and serving.
4. deploy: the production shape, all of it port code.  Render
   ``deploy/config/template`` with Triton metadata and layer on only
   what a loopback run needs (each override printed); load the same
   zone into ``python -m binder_torch.store.zk_testserver`` in bulk
   from a file; boot the supervisor of a 4-worker
   reuseport group over it; stream the mix from 16 sockets plus TCP
   while a second process rewrites 64 host znodes at about 500/s and
   measures how soon all 16 probe sockets read each write back; SIGKILL
   one worker mid-stream and check its respawn serves a later write;
   forward a ``dc1`` name to a peer port server and compare with the
   peer's own answer; SIGTERM the supervisor and check nothing is left.
   Every worker's C lane must be resident and serving.
5. balancer: binder's upstream topology, ``mbalancer`` in front of 4
   ``python -m binder_torch.main -b <socket>`` backends on the serve
   phase's zone; the serve mix from 16 client addresses through the
   balancer's UDP and TCP port; every answer right, every backend
   serving, direct return negotiated and used, the backends' C lanes
   serving; SIGTERM to every process leaves nothing.
6. topology: the shipped topology in its production posture.
   ``python -m binder_torch.topology start`` puts 4 port servers, each
   with its own ZooKeeper session and mirror of the deploy phase's
   zone, under ``instance_adjust`` behind ``mbalancer`` (answer cache
   on), from the shipped ``etc/config.json`` with the query log on;
   half of them relay through the balancer (so its cache is in the
   path) and half answer on direct return.  The serve mix from 16
   client addresses and TCP, churn probed from 16 more, one backend
   SIGKILLed and restored by ``topology start``: every answer right,
   every write read back through the cache, every backend serving on
   its C lane and logging one line per query it completed; ``topology
   stop`` leaves nothing.  A 1 Hz series runs from the stream's start
   to the restored backend serving: the client's answers and retries,
   each backend's completed queries, ZooKeeper session gauges, session
   rebuilds and loop-lag stalls, the balancer's forwards and health per
   backend, the ZooKeeper server's busy share and the churn's
   ``set_data`` round trips, with the kill and the re-converge on the
   same clock.
7. systemd: the port installed as on a systemd host
   (``binder_torch/deploy/README.md``), its units run by the
   ``systemctl`` stand-in ``binder_torch.deploy.systemctl_shim``:
   ``python -m binder_torch.fastio_build install`` builds all five
   artifacts (``zlogcat`` and ``dnsblast`` too); ``binder-config.
   service`` renders ``etc/config.json`` from Triton metadata (the
   loopback overrides printed); ``binder-balancer.service`` and the
   port-built ``instance_adjust -m systemd -i 4 -w`` bring up 4
   ``binder@.service`` instances over the deploy phase's zone in the
   port's ZooKeeper server.  Every host through the balancer, ``bdig``
   on a few names, 60,000 queries from the port-built ``dnsblast`` (16
   source addresses, window 64) and 30,000 UDP plus 500 TCP from the
   Python client with every reply checked; a ``zkput`` fixture read
   back within 5 s; a scale 4 -> 2 -> 4 under a stream, a SIGKILL
   restored by a converge, the metric ports, a teardown that leaves
   nothing.  Each converge must issue the ``systemctl`` verbs the
   reference's ``tests/test_instance_adjust_systemd.py`` expects.
8. chaos: (a) a 4-worker group over the fake store at the serve
   phase's zone with a ``chaos`` block scripting every supervisor-side
   fault, under the 16-socket stream: every query answered or refused,
   nothing stale past the cap, every action injected, the respawned
   and rolled workers the port's, the replica skew caught, and the
   ``rrl-flood`` limited (dropped or slipped, as the reference's gate
   holds) on the workers it reached, each worker's own limiter read on
   its metrics port through the flood and the kill, so that a worker
   killed before its next stats frame still counts;
   (b) in process, recursion to a remote DC through a ``ChaosUpstream``
   under loss, then a dead peer, then recovery, with the store's
   session lost and restored: stale within the cap, SERVFAIL past it,
   and re-convergence.
9. hostile: ``tools/hostile_smoke.py`` on the port, at the serve
   phase's zone with the reference smoke's RRL limit (150/s, burst
   300, slip 2, 512 buckets): once the zone fill has settled, a paced
   legit control from 127.0.0.1, then ``python -m
   binder_torch.loadgen.hostile`` (64 flows, 6,000 qps, 10 s, the
   default mix over the zone's host names) with the same probe under
   it.  Gates: the spoof prefixes slipped and dropped and the RRL
   counters moved, goodput under the flood at least half the
   control's, malformed frames never answered, the server up, RSS
   growth from after the control at most 64 MiB, the bucket cap, the
   RRL exposition and ``/status`` valid, the C lane resident and
   serving.
10. population: ``tools/population_smoke.py`` on the port at the same
   zone.  Leg A: ``binder_torch.loadgen.population.run_population``
   (200,000 identities behind 4 NAT'd farms, 48 direct clients,
   Zipf 1.1, 300 -> 2,000 qps, a 20% spoofed overlay, 10 s) against
   RRL v2 (60/s, burst 120, adaptive, the direct cohort's /16
   allowlisted): farm goodput at least 0.5, false positives at most
   0.10, adaptations, drops and allowlisted counts, the C lane.  Leg
   B: a 2-worker group whose chaos block floods and then rolls every
   worker, rolled again by SIGHUP, under a closed-loop allowlisted
   probe: no probe query lost, at most 3 retried, every pid replaced
   twice by ``binder_torch.main`` workers, 2 rolls a shard and no
   abort, clean quiesces, sequential rolls, the shard exposition, the
   flood limited, nothing left after SIGTERM.  Two departures from the
   reference smokes, both printed: the name population (the zone's
   100,000 hosts, not 8 or 16), and leg B's flood of 1,600 packets, not
   400 (``ROLL_PLAN`` says why).
11. federation: ``tools/federation_smoke.py`` on the port, in processes,
   at the serve phase's zone a datacenter.  Two ``west`` servers on
   127.0.0.2; a federated ``east`` whose fake store carries
   ``/dcs/{east,west}`` (TTL clamp 15, the shipped cache of 4,096);
   and (b) a second ``east`` routed by ``recursion.ufds`` over LDAPS
   (the port's ``LdapTestServer`` in this process, a CA and a
   certificate from the ``openssl`` command line): the discovered map
   routes ``west`` and a west name asked with RD=1 comes back
   byte-identical to west's own answer; that binder stops before the
   LDAP server does.  Then (a): 256 forwarded answers byte-identical
   to west's, a working set of 2,000 west names asked once, and a 10 s
   stream of local and foreign names in turn, one query at a time with
   no retry, with both west processes SIGKILLed at 55% of it.  Gates:
   every foreign answer after dark NOERROR with the right address and
   a TTL of at most 15 (and every working-set name again after the
   stream), a never-seen west name REFUSED, no client-visible timeout
   (2.5 s), local p50 and p99 within the reference's bounds, the first
   stale answer within 5 s, ``validate_federation_metrics``, ``/status
   federation.dark == ["west"]`` with a convergence time, ``bin/bstat``
   rendering ``(DARK)``, the ``dc-join``, ``dc-dark`` and
   ``federation-failover`` flight events, east's C lane serving.
12. verify: the in-process half of ``tools/verify_smoke.py`` at the
   serve phase's zone: a ``BinderServer`` in this process with the
   verifier (audit every 0.05 s) and both precompile tiers on, the C
   lane resident.  Once the zone fill and the precompile seed have
   settled, a 10 s clean soak of churn and queries: no violation,
   every invariant checked, a full audit pass, every propagation stage
   from ``mirror-apply`` to ``compiled-install`` observed, the verify
   exposition and ``/status`` valid, RSS growth within 96 MiB.  Then
   ``corrupt-answer`` and ``drop-reverse`` through the port's
   ``ChaosDriver`` and one ``audit_cycle()``: each detected, each seen
   as a flight event, in ``binder_verify_violations_total`` and in
   ``/status verify.recent_violations``; the cycle's seconds and
   checks/s are printed, and what served the corrupted name.
13. tcp: ``tools/tcp_smoke.py`` against ``python -m binder_torch.main``
   at the serve phase's zone with a 4,096-byte write cap, read through
   ``/status`` and ``/metrics``: one-shot serves and closes counted, a
   second pipelined burst promoted and a burst coalesced, a slow
   reader dropped at the cap while another client is served, a
   half-closed client answered, the connection table empty again after
   a torn frame and RST, ``validate_tcp_metrics`` and a valid ``tcp``
   section, the C lane serving.
14. conformance: glibc's resolver against the tcp phase's server
   (``binder_torch.cli.libresolv_probe --server``, which points
   ``_res`` at the server's port): a host's A record and its TTL, its
   PTR, the fixture's SRV with its A additionals and the OPT echo of
   payload 1232, each parsed by ``ns_parserr``; and the RFC golden
   byte-vectors through ``binder_torch.dns``.
15. zone: ``tools/zone_smoke.py`` on the port at its default size, its
   probes from 10,000 to 1,000,000 names, and the C zone lane at the
   serve phase's zone.  (a) ``python -m binder_torch.probe.zone`` at
   2,000 and 100,000 names, each in its own process: mutation p50 at
   100,000 at most 4.0x the control's, no re-rendered answer differing
   from a fresh engine render, the chunked rebuild's worst loop lag at
   most 250 ms with no lookup missed mid-rebuild and at least 2 chunks,
   and ``validate_mirror_metrics`` on a collector-wired server.  (b)
   the zone probe at 10,000 and 1,000,000 names (150 mutations, the
   bench's storm) and ``python -m binder_torch.probe.verify`` at 10,000,
   100,000 and 1,000,000 (400 mutations): no parity failure and no
   violation at any size, mutation p50 at 1,000,000 at most 4.0x the
   10,000's in both probes, the rebuild at 1,000,000 within 250 ms of
   loop lag and missing no lookup; each probe's readings and peak RSS
   are printed.  The two sizes of each latency ratio run back to back,
   the zone probe's chain of sizes beside the verify probe's and both
   beside leg (c).  (c) an in-process ``BinderServer`` with the C zone
   resident and ``degradation`` on (clamp 5 s, cap 10 s): once the
   zone fill settles, a seeded sample of 2,000 hosts asked once; one of
   them mutated and the session expired, the sample asked during the
   chunked rebuild and after it: every answer right, the mutated host
   served by the C zone, the loop's lag under the watchdog's 250 ms;
   then the session lost: every answer stale-served with TTL at most 5;
   and back: every answer right with the record's own TTL.  The C
   zone's share of the sample after each event is printed, and whether
   it comes back within 10 s.
16. check: the port's ``make check`` (``binder_torch.check``) on what
   the native phase built, its three steps at once: the five shipped
   artifacts with ``-Werror`` (the root ``Makefile``'s flags under the
   compiler's own defaults); the fuzz smoke,
   the four ASan/UBSan mutational fuzzers at 20,000 iterations and the
   four coverage-guided ones at 5,000 over ``native/fuzz/corpus``, which
   must stay byte for byte as it was; the port's in-process C-lane
   suites, the counterparts of the reference's fast-path suites among
   them, in pytest processes with ``libasan`` preloaded against the
   ASan extension, every extension loaded there the ASan build, their
   ``reference`` cases deselected and no ``binder_tpu`` module loaded.
   No warning, no sanitizer report, no failed or skipped case.  It runs beside the aggregate and collective
   phases, whose gates hold values, not times; its line is printed
   before a failure is raised, so the steps that passed still show.
17. aggregate: the port's latency summary (mean, p50, p99) on ``cuda``
   over the serve and deploy latencies and over a seeded 2**24 + 1
   batch, held against numpy.
18. collective: the data-parallel mean over NCCL on the one card.
19. libc: the getent tier of ``make ci`` (``tests/test_conformance.py``
   ``TestLibcConformance``) at the serve phase's zone, beside check,
   aggregate and collective.  ``python -m binder_torch.cli.resolv_ns``
   makes a private network and mount namespace (loopback up,
   192.0.2.1/32 on ``lo`` for ``AI_ADDRCONFIG``, a ``resolv.conf`` that
   names 127.0.0.1:53 with ``edns0``, ``hosts: files dns``, no host
   ``nscd``) and runs ``chip_smoke.py --libc-leg`` in it: ``python -m
   binder_torch.main`` on port 53 there, and, once its zone fill has
   settled, a seeded sample of 2,000 hosts through ``getent ahostsv4``
   and ``getent hosts`` by name and by address, ``libresolv_probe``
   without ``--server`` (A with TTL 30, PTR, the fixture's SRV with its
   A additionals, OPT 1232), and a name the zone does not hold.  Gates:
   every answer the zone's, the unknown name not found, the files in
   the namespace the ones bound, the C lane serving, the server up, the
   host's ``/etc/resolv.conf`` and ``/etc/nsswitch.conf`` the same
   sha256 and mtime after as before, no process left.  A step of the
   namespace that cannot be made fails the phase.

The port has no hand-written GPU kernel (the JAX package has no Pallas
kernel to port; the native code is host code), so the kernel line is
an empty list.  Before it, a ``{"native": ...}`` line carries the build
seconds, the lane parity and the C lane's hits in each phase.  Phases 10
to 16 and 19 print each of their departures from the reference smoke,
and every phase's seconds are printed as it ends.  The last
line is ``{"ok": true, "device": {...}}``.  ``--churn ZK_PORT
DNS_PORT [--spread]`` is the deploy and topology phases'
churn process, started by the script itself; ``--churn-cost N[,N...]``
measures one server's CPU per churn write at zones of ``N`` hosts.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import hashlib
import json
import os
import random
import re
import select
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

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


def card_reading() -> None:
    """Print the card's name and power limit; fails at once on a host
    without ``nvidia-smi``."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except OSError as e:
        raise PhaseError(f"device: nvidia-smi did not run: {e}") from None
    if smi.returncode != 0:
        raise PhaseError(f"device: nvidia-smi failed: {smi.stderr}")
    log("nvidia-smi: " + smi.stdout.strip().splitlines()[0])


def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise PhaseError("device: torch.cuda.is_available() is false")
    return torch


# -- phase 2: native ---------------------------------------------------

#: the extension's functions (native/fastio/fastio.c, fastio_methods)
EXTENSION_FUNCTIONS = (
    "recv_batch", "send_batch", "io_stats", "fastpath_new", "fastpath_put",
    "fastpath_zone_put", "fastpath_serve_wire", "fastpath_serve_frames",
    "fastpath_serve_balancer", "fastpath_drain", "fastpath_stats",
    "fastpath_clear", "fastpath_zone_reserve", "fastpath_invalidate",
    "fastpath_invalidate_many", "fastpath_log_enable",
    "fastpath_log_drain")
#: the dns server's handles on the extension's serve entry points
NATIVE_SERVE = ("_fp_serve_wire", "_fp_serve_frames", "_fp_serve_balancer")
PARITY_UDP = 4_000
PARITY_TCP = 300


@contextlib.contextmanager
def python_lane():
    """Pin the port's serve modules to the Python lane while inside."""
    from binder_torch import server
    from binder_torch.dns import server as dns_server
    names = [(server, "_fastio"), (dns_server, "_fastio")] + [
        (dns_server, name) for name in NATIVE_SERVE]
    saved = [(mod, name, getattr(mod, name)) for mod, name in names]
    try:
        for mod, name in names:
            setattr(mod, name, None)
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def zone_mirror(hosts: int):
    """The serve phase's zone as an in-process fake store and mirror."""
    from binder_torch.store import FakeStore, MirrorCache
    from binder_torch.store.fake import load_state, populate_synthetic
    store = FakeStore()
    load_state(store, zone_fixture())
    populate_synthetic(store, DOMAIN, hosts=hosts)
    cache = MirrorCache(store, DOMAIN)
    store.start_session()
    return cache


def ask_each(port: int, transport: str, wires):
    """``wires`` one at a time over one socket; the replies in order."""
    out = []
    if transport == "udp":
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(REPLY_STALL_S)
            for w in wires:
                s.sendto(w, ("127.0.0.1", port))
                out.append(s.recv(65535))
        return out
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=REPLY_STALL_S) as s:
        for w in wires:
            s.sendall(struct.pack(">H", len(w)) + w)
            out.append(_recv_exact(s, struct.unpack(
                ">H", _recv_exact(s, 2))[0]))
    return out


async def lane_replies(cache, udp_wires, tcp_wires):
    """The replies of a fresh server on whichever lane the modules are
    pinned to, and its C lane's counters (None on the Python lane)."""
    from binder_torch import _binderfastio
    from binder_torch.metrics.collector import MetricsCollector
    from binder_torch.server import BinderServer
    server = BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        collector=MetricsCollector(), host="127.0.0.1", port=0,
        query_log=False, rrl={"allowlist": ["127.0.0.0/8"]})
    server.resolver.rng = random.Random(SEED)
    await server.start()
    try:
        loop = asyncio.get_running_loop()
        udp = await loop.run_in_executor(None, ask_each, server.udp_port,
                                         "udp", udp_wires)
        tcp = await loop.run_in_executor(None, ask_each, server.tcp_port,
                                         "tcp", tcp_wires)
        stats = (_binderfastio.fastpath_stats(server._fastpath)
                 if server._fastpath is not None else None)
        return udp + tcp, stats
    finally:
        await server.stop()


def record_sets(data: bytes):
    from binder_torch.dns import Message
    m = Message.decode(data)

    def rows(section):
        return sorted(repr(dataclasses.astuple(r)) for r in section)
    return (data[:12], rows(m.answers), rows(m.authorities),
            rows(m.additionals))


def lane_parity(hosts: int = HOSTS, n_udp: int = PARITY_UDP,
                n_tcp: int = PARITY_TCP):
    """The seeded mix (each UDP query asked twice: the second is a C
    answer-cache hit) through the C lane and then the Python lane."""
    from binder_torch.dns import Message, Type, make_query
    rng = random.Random(SEED + 3)
    mix = [(n, t, 1232) for n, t, _ in query_mix(rng, n_udp, hosts)] + [
        (f"_http._tcp.big.{DOMAIN}", Type.SRV, 1232),
        (f"big.{DOMAIN}", Type.A, None), (f"nope.{DOMAIN}", Type.A, 1232),
        (f"web.{DOMAIN}", Type.AAAA, None)]
    udp = [make_query(n, t, qid=(k + 1) & 0xFFFF, edns_payload=e).encode()
           for k, (n, t, e) in enumerate(mix)]
    tcp = udp[:n_tcp] + udp[-4:]
    cache = zone_mirror(hosts)
    t0 = time.monotonic()
    native, stats = asyncio.run(lane_replies(cache, udp + udp, tcp))
    native_s = time.monotonic() - t0
    with python_lane():
        t0 = time.monotonic()
        python, none = asyncio.run(lane_replies(cache, udp + udp, tcp))
        python_s = time.monotonic() - t0
    if stats is None or none is not None:
        raise PhaseError("native: the lanes were not pinned as asked")
    identical = rotated = 0
    differ = []
    for k, (got, want) in enumerate(zip(native, python)):
        if got == want:
            identical += 1
        elif (len(Message.decode(want).answers) > 1
              and record_sets(got) == record_sets(want)):
            rotated += 1
        else:
            differ.append(k)
    report = {"zone_names": hosts, "replies": len(native),
              "identical": identical, "same_records_rotated": rotated,
              "differ": len(differ), "c_lane_s": native_s,
              "python_lane_s": python_s,
              "c_zone_hits": stats["zone_hits"],
              "c_cache_hits": stats["hits"]}
    if differ:
        raise PhaseError(f"native: {len(differ)} C-lane repl(ies) differ "
                         f"from the Python lane, e.g. #{differ[:5]}")
    if stats["zone_hits"] + stats["hits"] <= 0:
        raise PhaseError(f"native: the C lane served nothing: {stats}")
    return report


def check_builds():
    """What the check phase runs: every shipped artifact, its
    ``-Werror`` build, the ASan extension and the fuzzers."""
    from binder_torch import fastio_build
    return (tuple(fastio_build.ARTIFACTS) + fastio_build.WERROR
            + ("extension.asan",) + fastio_build.FUZZERS
            + fastio_build.COV_FUZZERS)


def native_phase(hosts: int = HOSTS, also=()):
    """Build the port's native code (and ``also``, in the same
    ``build_all`` call), check the extension, and hold the C lane
    against the Python lane; returns the report."""
    from binder_torch import fastio_build
    names = ("extension", "mbalancer", "instance_adjust")
    report = {"clean_checkout": {
        name: not os.path.exists(fastio_build.artifact_path(name))
        for name in names}}
    t0 = time.monotonic()
    try:                    # the compilers at once
        built = fastio_build.build_all(names + tuple(also))
    except fastio_build.NativeBuildError as e:
        if not all(name in e.built for name in names):
            raise
        built = e.built     # a build of ``also`` is the check phase's
    report["build_wall_s"] = time.monotonic() - t0
    report["build_s"] = {name: built[name][1] for name in names}
    report["also_build_s"] = {name: seconds for name, (_, seconds)
                              in built.items() if name not in names}
    for name in names:
        path, seconds = built[name]
        log(f"native: {name} at {os.path.relpath(path, ROOT)}, "
            f"compiled in {seconds}s")
    from binder_torch import _binderfastio
    if os.path.dirname(os.path.dirname(_binderfastio.__file__)) != \
            fastio_build.BUILD_DIR:
        raise PhaseError(f"native: the extension came from "
                         f"{_binderfastio.__file__}")
    missing = [f for f in EXTENSION_FUNCTIONS
               if not callable(getattr(_binderfastio, f, None))]
    if missing:
        raise PhaseError(f"native: the extension lacks {missing}")
    report["functions"] = len(EXTENSION_FUNCTIONS)
    report["parity"] = lane_parity(hosts)
    log(json.dumps({"native_phase": report}))
    return report


# -- phase 16: check --------------------------------------------------


def make_check_phase(build_s=None, iterations=None, asan_runs=None) -> dict:
    """The port's ``make check`` on what the native phase built:
    ``binder_torch.check``'s steps (b) to (d), at once (each reads only
    what it was given): the ``-Werror`` build, the fuzz smoke at
    ``iterations`` (mutational, coverage-guided; ``native/Makefile``'s
    counts by default), and the suites of ``asan_runs`` (the check's by
    default) under ASan.  ``build_s``: the compile seconds of each
    artifact, from the native phase's ``build_all``."""
    from binder_torch import check
    fuzz, cov = iterations or (check.FUZZ_ITERATIONS, check.COV_ITERATIONS)
    done = check.run({"werror": check.werror_step,
                      "fuzz": lambda: check.fuzz_step(fuzz, cov),
                      "asan": lambda: check.asan_step(asan_runs)},
                     concurrent=True)
    report = {"build_s": build_s,
              "seconds": {name: s for name, (_, _, s) in done.items()},
              "failed": [name for name, (_, e, _) in done.items() if e],
              **{name: r for name, (r, _, _) in done.items()}}
    if report["asan"] is not None:
        for run in report["asan"]["runs"].values():
            run["loaded"] = sorted(run["loaded"]["modules"])
    log(json.dumps({"check": report}))
    if report["failed"]:
        raise PhaseError("check: " + "\n".join(
            e for _, e, _ in done.values() if e))
    return report


# -- phase 3: serve ---------------------------------------------------


def host_name(i: int, racks: int, sub: str = "zs") -> str:
    """Synthetic host ``i`` of a zone under ``<sub>.<DOMAIN>``
    (``populate_synthetic``'s layout)."""
    return f"h{i:06d}.r{i % racks:04d}.{sub}.{DOMAIN}"


def host_addr(i: int) -> str:
    return f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"


def zone_fixture():
    """The shipped fixture plus the 64-instance ``big`` service."""
    with open(os.path.join(ROOT, "etc", "fixture.json")) as f:
        fixture = json.load(f)
    fixture["/com/foo/big"] = BIG_SERVICE
    for k in range(BIG_INSTANCES):
        fixture[f"/com/foo/big/lb{k}"] = {
            "type": "load_balancer",
            "load_balancer": {"address": f"10.200.0.{k + 1}"}}
    return fixture


def write_config(tmp: str, hosts: int, *, name: str = "config",
                 dc: str = "dc0", host: str = "127.0.0.1",
                 subtree: str = "zs", fixture=None, **extra) -> str:
    """A single-process server's config, ``<tmp>/<name>.json``:
    datacenter ``dc`` on ``host``, the shipped fixture and the ``big``
    service plus ``fixture``, and ``hosts`` synthetic hosts under
    ``<subtree>.<DOMAIN>``; ``extra`` sets further top-level keys."""
    data = zone_fixture()
    data.update(fixture or {})
    fixture_path = os.path.join(tmp, f"{name}-fixture.json")
    with open(fixture_path, "w") as f:
        json.dump(data, f)
    config_path = os.path.join(tmp, f"{name}.json")
    with open(config_path, "w") as f:
        json.dump(dict({
            "dnsDomain": DOMAIN, "datacenterName": dc, "host": host,
            "store": {"backend": "fake", "fixture": fixture_path,
                      "synthetic": {"hosts": hosts, "subtree": subtree}},
            "queryLog": False,
            # one client address drives the whole stream: keep the
            # limiter on but let loopback through
            "rrl": {"allowlist": ["127.0.0.0/8"]},
        }, **extra), f)
    return config_path


def boot_server(config_path: str, log_path: str,
                what: str = "serve: server", port: int = 0):
    """Start ``python -m binder_torch.main`` on ``config_path`` (on
    ``port``, an ephemeral one by default); return the process and its
    UDP port once it serves."""
    proc = spawn(["-m", "binder_torch.main", "-f", config_path, "-p",
                  str(port)], log_path)
    m = wait_line(proc, log_path, rb"UDP DNS service started on [\d.]+:(\d+)",
                  what, BOOT_DEADLINE_S)
    return proc, int(m.group(1))


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def metrics_port(log_path: str) -> int:
    return int(re.search(rb"metrics server started on port (\d+)",
                         read_bytes(log_path)).group(1))


#: the C lane's residency gauges in a server's ``/metrics``
#: (binder_torch/server.py)
NATIVE_GAUGES = ("binder_fastpath_entries", "binder_zone_entries")
#: what the C lane served: its zone-table serves (``binder_zone_serves``
#: counts those alone) and its answer-cache hits (folded into
#: ``binder_answer_cache_hits`` together with the Python answer cache's
#: hits, which ``/status`` reports on their own)
NATIVE_COUNTERS = ("c_zone_hits", "c_cache_hits")

#: the serve and deploy streams' readings on the Python lane, before
#: the port had its C lane (PERF.md section 6, runs A, B and C, one H100
#: host each), printed beside this run's for comparison
PYTHON_LANE_READINGS = {
    "serve": {"udp_qps": [4827.638099511424, 12167.926191014554,
                          9291.262829109179],
              "udp_p50_us": [10742.146, 4269.023499999999, 5819.664],
              "udp_p99_us": [27206.841309999974, 9570.880469999984,
                             10862.36385]},
    "deploy": {"udp_qps": [3600.0303175113168, 15714.211748987598,
                           10774.113278288978],
               "udp_p50_us": [8192.0235, 1896.5875, 2855.8285],
               "udp_p99_us": [38843.57747000001, 6552.6429,
                              9939.055210000004]},
}


def metric_sum(text: str, family: str) -> float:
    """The sum of every series of ``family`` in an exposition."""
    total = 0.0
    for line in text.splitlines():
        if line.split("{", 1)[0].split(" ", 1)[0] == family:
            total += float(line.rsplit(" ", 1)[1])
    return total


def native_reading(mport: int):
    text = http_json(mport, "/metrics")
    python_hits = http_json(mport, "/status")["answer_cache"]["hits"]
    out = {f: metric_sum(text, f) for f in NATIVE_GAUGES}
    out["c_zone_hits"] = metric_sum(text, "binder_zone_serves")
    out["c_cache_hits"] = (metric_sum(text, "binder_answer_cache_hits")
                           - python_hits)
    return out


def native_delta(before, after):
    """The C lane's state after a stream and what it served in it."""
    out = {f: after[f] for f in NATIVE_GAUGES}
    out.update({f: after[f] - before[f] for f in NATIVE_COUNTERS})
    return out


def native_gate(what: str, before, after):
    """Errors unless the C lane was resident after a stream and served
    in it."""
    errors = [f"{what}: {g} is {after[g]}" for g in NATIVE_GAUGES
              if not after[g] > 0]
    served = native_delta(before, after)
    if not served["c_zone_hits"] + served["c_cache_hits"] > 0:
        errors.append(f"{what}: the C lane served nothing: {served}")
    return errors


def metrics_text(port: int, path: str = "/metrics",
                 timeout: float = 1.0) -> str:
    """One GET of a metrics port, no retry: OSError when nothing
    answers (a sampler must not stall on a process that died)."""
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.read().decode()


class Series:
    """A thread that calls ``read()`` every ``period`` seconds (every
    ``fast`` seconds while ``fast_while()`` is true) until
    :meth:`stop`, and keeps ``(unix time, value)`` of each reading; a
    reading that raises ``OSError`` or ``ValueError`` (a process gone,
    a port not yet up) is left out."""

    def __init__(self, read, period: float = 1.0, fast: float = None,
                 fast_while=None):
        import threading
        self.read, self.period = read, period
        self.fast, self.fast_while = fast, fast_while
        self.points = []
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._done.is_set():
            t = time.time()
            try:
                self.points.append((t, self.read()))
            except (OSError, ValueError):
                pass
            fast = self.fast is not None and self.fast_while()
            self._done.wait(max(0.0, (self.fast if fast else self.period)
                                - (time.time() - t)))

    def __enter__(self):
        self._thread.start()
        return self

    def stop(self):
        self._done.set()
        if self._thread.ident is not None:
            self._thread.join()
        return self.points

    def __exit__(self, *exc):
        self.stop()


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


def check_phase(phase: str, errors, left) -> None:
    """Log a phase's errors and fail it if it had any or left a
    process; the failure line names the first error, since it may be
    the only line of the run a reader sees."""
    if not errors and not left:
        return
    for e in errors[:20]:
        log(f"{phase} error: " + e)
    raise PhaseError(f"{phase}: {len(errors)} error(s), "
                     f"{len(left)} process(es) left"
                     + (f"; first: {errors[0]}" if errors else ""))


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
                n_tcp: int = N_TCP, native=None):
    """Boot the port's server and drive it; return the UDP latencies
    (microseconds), and put the C lane's readings in ``native``.
    Raises PhaseError on any wrong or missing answer."""
    rng = random.Random(SEED)
    proc = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        try:
            t0 = time.monotonic()
            log_path = os.path.join(tmp, "server.log")
            proc, port = boot_server(write_config(tmp, hosts), log_path)
            boot_s = time.monotonic() - t0
            mport = metrics_port(log_path)
            udp_q = query_mix(rng, n_udp, hosts)
            before = native_reading(mport)
            server_cpu0 = cpu_seconds(proc.pid)
            client_cpu0 = time.process_time()
            t0 = time.monotonic()
            lat, errors = udp_stream(port, udp_q, CONCURRENCY)
            udp_s = time.monotonic() - t0
            # the busy share of each side over the UDP stream says
            # which one held the rate down
            server_busy = (cpu_seconds(proc.pid) - server_cpu0) / udp_s
            client_busy = (time.process_time() - client_cpu0) / udp_s
            after = native_reading(mport)
            errors += native_gate("serve", before, after)
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
                  "udp_client_cpu_busy": client_busy,
                  "c_lane": native_delta(before, after),
                  "python_lane_before": PYTHON_LANE_READINGS["serve"]}}))
    if native is not None:
        native["serve"] = native_delta(before, after)
    if errors:
        for e in errors[:20]:
            log("serve error: " + e)
        raise PhaseError(f"serve: {len(errors)} wrong or missing "
                         "answer(s)")
    return lat


# -- phase 4: deploy --------------------------------------------------

DEPLOY_SHARDS = 4
#: the 16-socket stream (``STREAM_CUTS``)
DEPLOY_UDP = 30_000
FLOWS = 16
CHURN_NAMES = 64
CHURN_INTERVAL_S = 0.002
FRESH_LIMIT_S = 5.0
#: the churn's length in ``--churn-cost``
CHURN_COST_S = 6.0
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


async def zk_set(port: int, path: str, data: bytes) -> None:
    client = await zk_connect(port)
    try:
        await client.mkdirp(path, data)
    finally:
        client.close()


class ZooKeeper:
    """The port's ZooKeeper server holding :func:`zone_nodes`, loaded
    in bulk from a file before it listens: its port, log, znode count
    and seed seconds (from its start to its first line)."""

    def __init__(self, hosts: int, tmp: str):
        self.log = os.path.join(tmp, "zk.log")
        nodes = zone_nodes(hosts)
        tree = os.path.join(tmp, "zk-tree.json")
        with open(tree, "w") as f:
            json.dump([[path, data.decode()] for path, data in nodes], f)
        t0 = time.monotonic()
        self.proc = spawn(["-m", "binder_torch.store.zk_testserver", "0",
                           tree], self.log)
        try:
            self.port = int(wait_line(self.proc, self.log,
                                      rb"listening on [\d.]+:(\d+)",
                                      "ZooKeeper server", 60).group(1))
        except BaseException:
            reap(self.proc)
            raise
        self.seed_s = time.monotonic() - t0
        self.znodes = len(nodes)


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
    return write_overridden(options, overrides,
                            os.path.join(tmp, "deploy.json"), "deploy")


def write_overridden(options, overrides, path: str, what: str) -> str:
    """Write ``options`` with each dotted key of ``overrides`` set,
    printing every override; return ``path``."""
    for key, value in overrides.items():
        *parents, leaf = key.split(".")
        node = options
        for name in parents:
            node = node[name]
        node[leaf] = value
        log(f"{what} override: {key} = {json.dumps(value)}")
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
    raise PhaseError(f"no answer from :{port}{path}")


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
              rd: bool = False, required: bool = True):
    """One A query on a fresh socket (a fresh reuseport draw), asked up
    to three times; with no reply, PhaseError, or None when not
    ``required``."""
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
    if required:
        raise PhaseError(f"no answer for {name}")
    return None


def a_addrs(data: bytes):
    from binder_torch.dns import Message
    return [r.address for r in Message.decode(data).answers
            if hasattr(r, "address")]


def same_but_id_ra(a: bytes, b: bytes) -> bool:
    """Byte-identical but for the ID and the forwarder's RA bit."""
    a, b = bytearray(a), bytearray(b)
    a[3] |= 0x80
    b[3] |= 0x80
    return a[2:] == b[2:]


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


def zone_sweep(port: int, hosts: int, deadline: float,
               indices=None, what: str = "deploy", sources=None) -> None:
    """Ask every host's A record (or those of ``indices``) over
    ``FLOWS`` sockets (bound to ``sources`` when given), again and
    again for the ones not yet right, until all are or ``deadline``."""
    racks = max(1, min(1024, hosts // 512))
    todo = list(range(hosts)) if indices is None else list(indices)
    while todo:
        queries = [(host_name(i, racks), 1, ("a", {host_addr(i)}))
                   for i in todo]
        _, errors, _ = udp_flows(port, queries, FLOWS, CONCURRENCY,
                                 sources=sources)
        wrong = {e.split(":")[0] for e in errors}
        todo = [i for i in todo if host_name(i, racks) in wrong]
        if todo and time.monotonic() > deadline:
            raise PhaseError(f"{what}: {len(todo)} host(s) still not "
                             f"served right, e.g. {errors[:3]}")
        if todo:
            time.sleep(0.5)


def udp_flows(port: int, queries, flows: int, concurrency: int,
              on_progress=None, sources=None, check=check_reply,
              stop=None, live=None):
    """Drive ``queries`` over ``flows`` UDP sockets (distinct source
    ports, so SO_REUSEPORT spreads them over the group; each bound to
    its address in ``sources`` when given) with ``concurrency`` in
    flight in all; a query unanswered after ``RETRY_AFTER_S`` is sent
    once more.  ``check(msg, expect)`` judges each reply (an empty
    string when it is right).  With ``stop``, the stream cycles
    through ``queries`` (at most 65,536, one per query ID) until
    ``stop()`` is true.  ``live``, a dict, is kept up to date with the
    counts of queries ``answered``, ``retries`` sent and queries
    ``lost`` (no reply to the query or its retry) while the stream
    runs.  Returns ``(latencies_us, errors, retries)``."""
    from binder_torch.dns import Message, make_query
    wires = [make_query(name, qtype, qid=i & 0xFFFF).encode()
             for i, (name, qtype, _) in enumerate(queries)]
    per = max(1, concurrency // flows)
    socks = []
    for k in range(flows):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if sources is not None:
            s.bind((sources[k], 0))
        s.connect(("127.0.0.1", port))
        s.setblocking(False)
        socks.append(s)
    by_fd = {s.fileno(): k for k, s in enumerate(socks)}
    pending = [dict() for _ in socks]     # qid -> [idx, t_first, t_sent]
    retried = [set() for _ in socks]
    lat, errors = [], []
    retries = 0
    nxt = done = 0
    total = len(queries) if stop is None else None    # None: until stop
    deadline = time.monotonic() + UDP_DEADLINE_S
    if live is None:
        live = {}
    live.update(answered=0, retries=0, lost=0)
    try:
        while total is None or nxt < total or any(pending):
            if total is None and stop():
                total = nxt
            for k, s in enumerate(socks):
                while (total is None or nxt < total) \
                        and len(pending[k]) < per:
                    idx = nxt % len(queries)
                    now = time.perf_counter_ns()
                    pending[k][idx & 0xFFFF] = [idx, now, now]
                    retried[k].discard(idx & 0xFFFF)
                    s.send(wires[idx])
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
                    live["answered"] = done
                    why = check(Message.decode(data), queries[idx][2])
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
                        live["lost"] += 1
                        del pending[k][qid]
                        continue
                    retried[k].add(qid)
                    retries += 1
                    live["retries"] = retries
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


def churn_main(zk_port: int, dns_port: int, sources=None) -> int:
    """Rewrite the churn names at about 500 writes/s and probe each
    write back from ``FLOWS`` sockets (bound to ``sources`` when given:
    behind the balancer, each client address reaches one backend)."""
    import asyncio
    import threading
    socks = []
    for k in range(FLOWS):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if sources is not None:
            s.bind((sources[k], 0))
        s.connect(("127.0.0.1", dns_port))
        s.setblocking(False)
        socks.append(s)
    latest = [None]          # the newest acknowledged write to probe
    fresh_ms, stale = [], []
    acks = []                # (unix time, set_data round trip ms)
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
            t_set = time.monotonic()
            await client.set_data(f"/com/foo/churn/c{k:02d}",
                                  host_json(churn_addr(w)))
            acks.append((time.time(), (time.monotonic() - t_set) * 1e3))
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
                      "final_ok": final_ok, "final_s": final_s,
                      "acks": per_second(acks)}),
          flush=True)
    return 0


def per_second(samples):
    """``[unix second, n, p50, max]`` of ``(unix time, value)``
    samples, one row a second that has any."""
    by = {}
    for t, v in samples:
        by.setdefault(int(t), []).append(v)
    return [[t, len(v), float(np.percentile(v, 50)), max(v)]
            for t, v in sorted(by.items())]



def churn_cost_main(sizes) -> int:
    """``--churn-cost N[,N...]``: for each zone of ``N`` hosts, one
    ``python -m binder_torch.main`` over the port's ZooKeeper server
    with the topology phase's config; once its walk serves the last host
    and it has gone idle, the churn's 500 writes/s for
    ``CHURN_COST_S``.  Prints, per size, the server's busy share and its
    CPU milliseconds per write beyond its idle rate."""
    import asyncio

    async def churn(zk_port: int) -> int:
        client = await zk_connect(zk_port)
        n = int(CHURN_COST_S / CHURN_INTERVAL_S)
        t_next = time.monotonic()
        for w in range(n):
            await client.set_data(f"/com/foo/churn/c{w % CHURN_NAMES:02d}",
                                  host_json(churn_addr(w)))
            t_next += CHURN_INTERVAL_S
            await asyncio.sleep(max(0.0, t_next - time.monotonic()))
        client.close()
        return n

    for hosts in sizes:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cost_") as tmp:
            procs = []
            try:
                zk = ZooKeeper(hosts, tmp)
                procs.append(zk.proc)
                zk_port = zk.port
                port = free_base(1)
                procs.append(spawn(["-m", "binder_torch.main", "-f",
                                    topology_config(tmp, zk_port),
                                    "-p", str(port)],
                                   os.path.join(tmp, "server.log")))
                pid = procs[1].pid
                t0 = time.monotonic()
                wait_host(port, hosts - 1, hosts,
                          t0 + TOPOLOGY_BOOT_DEADLINE_S)
                while True:     # the walk's zone pushes drain after it
                    c0, t1 = cpu_seconds(pid), time.monotonic()
                    time.sleep(1.0)
                    idle = (cpu_seconds(pid) - c0) / (time.monotonic() - t1)
                    if idle < 0.05 or t1 - t0 > TOPOLOGY_BOOT_DEADLINE_S:
                        break
                settle_s = time.monotonic() - t0
                c0, t1 = cpu_seconds(pid), time.monotonic()
                writes = asyncio.run(churn(zk_port))
                dt = time.monotonic() - t1
                used = cpu_seconds(pid) - c0
                print(json.dumps({"churn_cost": {
                    "zone_names": hosts, "writes": writes,
                    "writes_per_s": writes / dt, "settle_s": settle_s,
                    "idle_busy": idle, "busy": used / dt,
                    "ms_per_write": (used - idle * dt) / writes * 1e3}}),
                      flush=True)
            finally:
                for proc in procs:
                    reap(proc)
                    proc.wait(30)
    return 0

def cross_dc(port: int, dc1_port: int):
    """A dc1 name asked of dc0's group must come back as dc1 itself
    answers it, but for the ID and the RA bit."""
    errors = []
    for k, name in enumerate(sorted(DC1_HOSTS)):
        fqdn = f"{name}.dc1.{DOMAIN}"
        via = fresh_ask(port, fqdn, 0x100 + k, rd=True)
        direct = fresh_ask(dc1_port, fqdn, 0x200 + k, host="127.0.0.2",
                           rd=True)
        if a_addrs(via) != [DC1_HOSTS[name]]:
            errors.append(f"{fqdn} via dc0: {a_addrs(via)}")
        if not same_but_id_ra(via, direct):
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
                 shards: int = DEPLOY_SHARDS, native=None):
    """The production shape over the port: the deploy template, the
    port's ZooKeeper server at the serve phase's zone, a reuseport
    group of ``shards`` workers under churn and a worker crash, and a
    cross-DC forward.  Returns the stream's latencies (microseconds),
    and puts the workers' C-lane readings in ``native``."""
    import asyncio
    rng = random.Random(SEED + 1)
    procs = []
    report = {"zone_names": hosts, "shards": shards}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as tmp:
        zk = ZooKeeper(hosts, tmp)
        procs.append(zk.proc)
        try:
            report["zk_znodes"] = zk.znodes
            report["seed_s"] = zk.seed_s
            log(f"deploy: ZooKeeper server loaded {zk.znodes} znodes "
                f"and listening after {zk.seed_s}s")

            peer, dc1_port = boot_peer(tmp)
            procs.append(peer)
            config = deploy_config(tmp, zk.port, dc1_port, shards)

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
            # a readiness poll: while the owner's walk streams in, a
            # busy worker may leave a probe unanswered; the gate is the
            # boot deadline
            silent = 0
            while True:
                reply = fresh_ask(port, last, 1, required=False)
                if reply is not None and \
                        a_addrs(reply) == [host_addr(hosts - 1)]:
                    break
                silent += reply is None
                if time.monotonic() - t0 > DEPLOY_BOOT_DEADLINE_S:
                    raise PhaseError(f"deploy: {last} not served in "
                                     f"{DEPLOY_BOOT_DEADLINE_S:.0f}s")
                time.sleep(0.05)
            report["boot_first_answer_s"] = time.monotonic() - t0
            report["boot_probes_unanswered"] = silent
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
                 str(zk.port), str(port)], cwd=ROOT,
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

            c_lane0 = {w["shard"]: native_reading(w["metrics_port"])
                       for w in workers}
            cpu0 = {pid: cpu_seconds(pid) for pid in pids + [group.pid]}
            client_cpu0 = time.process_time()
            t0 = time.monotonic()
            lat, errors, retries = udp_flows(port, queries, FLOWS,
                                             CONCURRENCY, on_progress)
            udp_s = time.monotonic() - t0
            # the C lane of every worker that lived through the stream
            report["c_lane"] = {}
            for w in workers:
                if w["pid"] == killed.get("pid"):
                    continue
                after = native_reading(w["metrics_port"])
                errors += native_gate(f"deploy shard {w['shard']}",
                                      c_lane0[w["shard"]], after)
                report["c_lane"][w["shard"]] = native_delta(
                    c_lane0[w["shard"]], after)
            if native is not None:
                native["deploy"] = report["c_lane"]
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
            asyncio.run(zk_set(zk.port, "/com/foo/postkill",
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
            for path in (zk.log, os.path.join(tmp, "dc1.log"),
                         os.path.join(tmp, "group.log")):
                name = os.path.basename(path)
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
    report.update(udp_p50_us=float(pct[0]), udp_p99_us=float(pct[1]),
                  python_lane_before=PYTHON_LANE_READINGS["deploy"])
    log(json.dumps({"deploy": report}))
    check_phase("deploy", errors, left)
    return lat


# -- phase 5: balancer ------------------------------------------------

BALANCER_BACKENDS = 4
BALANCER_UDP = 20_000
#: one client address per flow: the balancer keeps each remote address
#: on one backend and assigns new ones round-robin, so 16 addresses
#: reach all 4 backends
BALANCER_CLIENTS = [f"127.0.1.{k + 1}" for k in range(FLOWS)]
BALANCER_DEADLINE_S = 60.0


def balancer_stats(sockdir: str):
    """The balancer's JSON state from its ``.balancer.stats`` socket."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(2)
        c.connect(os.path.join(sockdir, ".balancer.stats"))
        buf = b""
        while True:
            chunk = c.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)


def start_balancer(sockdir: str, log_path: str):
    """``mbalancer`` as the port builds it, on an ephemeral port; the
    process and the port it announced."""
    from binder_torch import fastio_build
    binary, _ = fastio_build.build("mbalancer")
    err = open(log_path, "wb")
    proc = subprocess.Popen([binary, "-d", sockdir, "-p", "0", "-b",
                             "127.0.0.1", "-s", "150"],
                            stdout=subprocess.PIPE, stderr=err)
    err.close()
    ready, _, _ = select.select([proc.stdout], [], [], 30)
    line = proc.stdout.readline() if ready else b""
    if not line.startswith(b"PORT "):
        proc.kill()
        proc.wait()
        raise PhaseError(f"balancer: mbalancer announced {line!r}")
    return proc, int(line.split()[1])


def balancer_phase(hosts: int = HOSTS, n_udp: int = BALANCER_UDP,
                   backends: int = BALANCER_BACKENDS, native=None):
    """``mbalancer`` in front of ``backends`` port servers on their
    balancer sockets (``python -m binder_torch.main -b``), the serve
    mix through it from ``FLOWS`` client addresses, direct return on
    the C lane; returns the stream's latencies (microseconds)."""
    rng = random.Random(SEED + 2)
    procs = []
    report = {"zone_names": hosts, "backends": backends}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_balancer_") as tmp:
        sockdir = os.path.join(tmp, "sockets")
        os.mkdir(sockdir)
        logs = [os.path.join(tmp, f"backend{k}.log")
                for k in range(backends)]
        try:
            config = write_config(tmp, hosts)
            t0 = time.monotonic()
            for k in range(backends):
                procs.append(spawn(["-m", "binder_torch.main", "-f", config,
                                    "-p", "0", "-b",
                                    os.path.join(sockdir, str(k))],
                                   logs[k]))
            for k in range(backends):
                wait_line(procs[k], logs[k], rb"UDP DNS service started",
                          f"balancer: backend {k}", BOOT_DEADLINE_S)
            report["backends_boot_s"] = time.monotonic() - t0
            mports = [metrics_port(path) for path in logs]
            bal, port = start_balancer(sockdir,
                                       os.path.join(tmp, "mbalancer.log"))
            procs.append(bal)
            # direct return, both sides: the balancer passed its client
            # socket to every backend, and every backend adopted it
            deadline = time.monotonic() + BALANCER_DEADLINE_S
            while True:
                stats = balancer_stats(sockdir)
                up = [b for b in stats["backends"]
                      if b["healthy"] and b.get("direct")]
                adopted = sum(b"balancer passed its client socket" in
                              read_bytes(path) for path in logs)
                if len(up) == backends and adopted == backends:
                    break
                if time.monotonic() > deadline:
                    raise PhaseError(f"balancer: {len(up)} backend(s) "
                                     f"direct, {adopted} adopted the "
                                     "client socket")
                time.sleep(0.1)
            report["direct_negotiated"] = backends
            c_lane0 = [native_reading(m) for m in mports]
            queries = query_mix(rng, n_udp, hosts)
            client_cpu0 = time.process_time()
            t0 = time.monotonic()
            lat, errors, retries = udp_flows(port, queries, FLOWS,
                                             CONCURRENCY,
                                             sources=BALANCER_CLIENTS)
            udp_s = time.monotonic() - t0
            report.update(udp_queries=n_udp, udp_answered=len(lat),
                          udp_retries=retries, udp_qps=len(lat) / udp_s,
                          client_cpu_busy=(time.process_time()
                                           - client_cpu0) / udp_s)
            errors += tcp_checks(port, query_mix(rng, N_TCP, hosts))
            stats = balancer_stats(sockdir)
            report["c_lane"] = []
            for k in range(backends):
                after = native_reading(mports[k])
                errors += native_gate(f"balancer backend {k}", c_lane0[k],
                                      after)
                report["c_lane"].append(native_delta(c_lane0[k], after))
            if native is not None:
                native["balancer"] = report["c_lane"]
            report["forwarded"] = [b["forwarded"] for b in stats["backends"]]
            report["mbalancer"] = {k: stats.get(k) for k in (
                "udp_queries", "tcp_queries", "cache_hits", "fd_passes",
                "direct_forwards")}
            if len(report["forwarded"]) != backends or \
                    min(report["forwarded"]) <= 0:
                errors.append(f"a backend served nothing: "
                              f"{report['forwarded']}")
            if stats["fd_passes"] < backends or \
                    stats["direct_forwards"] <= 0:
                errors.append("direct return not used: fd_passes "
                              f"{stats['fd_passes']}, direct_forwards "
                              f"{stats['direct_forwards']}")
            # SIGTERM to each process: backends unlink their sockets
            # and exit 0, the balancer goes with the signal
            for proc in procs:
                proc.send_signal(signal.SIGTERM)
            report["sigterm_rc"] = []
            for proc in procs:
                try:
                    report["sigterm_rc"].append(
                        proc.wait(timeout=DRAIN_DEADLINE_S))
                except subprocess.TimeoutExpired:
                    raise PhaseError("balancer: a process outlived "
                                     "SIGTERM")
            if report["sigterm_rc"] != [0] * backends + [-signal.SIGTERM]:
                errors.append(f"exit codes on SIGTERM "
                              f"{report['sigterm_rc']}")
            left_sockets = sorted(set(os.listdir(sockdir))
                                  - {".balancer.stats"})
            if left_sockets:
                errors.append(f"backend sockets left: {left_sockets}")
            report["errors"] = len(errors)
        except PhaseError:
            for path in logs + [os.path.join(tmp, "mbalancer.log")]:
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        tail = f.read()[-3000:].decode(errors="replace")
                    log(f"--- {os.path.basename(path)} (last 3000 bytes) "
                        f"---\n{tail}")
            raise
        finally:
            for proc in reversed(procs):
                reap(proc)
        left = descendants(os.getpid())
        report["left_after_sigterm"] = left
    pct = np.percentile(np.asarray(lat, np.float64), [50, 99]) \
        if lat else [float("nan")] * 2
    report.update(udp_p50_us=float(pct[0]), udp_p99_us=float(pct[1]))
    log(json.dumps({"balancer": report}))
    check_phase("balancer", errors, left)
    return lat


# -- phase 6: topology ------------------------------------------------

TOPOLOGY_BACKENDS = 4
#: the 16-address stream (``STREAM_CUTS``)
TOPOLOGY_UDP = 30_000
TOPOLOGY_BOOT_DEADLINE_S = 300.0
#: one ``python -m binder_torch.topology`` command (``instance_adjust
#: -w`` waits up to 60 s for each instance)
TOPOLOGY_CALL_S = 300.0
#: the churn process's probe addresses: the balancer deals each new
#: client address to one backend, so 16 reach all of them
CHURN_CLIENTS = [f"127.0.2.{k + 1}" for k in range(FLOWS)]
#: addresses first seen after the re-converge, dealt round-robin over
#: every backend, the restored one too
FRESH_CLIENTS = [f"127.0.3.{k + 1}" for k in range(FLOWS)]
#: hosts each backend is asked directly before the stream, and after
#: its restore
TOPOLOGY_SAMPLE = 1_000
TOPOLOGY_FRESH_UDP = 2_000
#: the write the restored backend must serve
POSTKILL_ADDR = "10.203.0.1"


def port_free(port: int) -> bool:
    """True when nothing holds ``port`` over UDP or TCP."""
    for kind in (socket.SOCK_DGRAM, socket.SOCK_STREAM):
        with socket.socket(socket.AF_INET, kind) as s:
            try:
                s.bind(("0.0.0.0", port))
            except OSError:
                return False
    return True


def free_base(n: int) -> int:
    """A base port ``B`` with ``B .. B+n-1`` and their metrics ports
    (each + 1000) free, below the kernel's ephemeral range."""
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20_000, 29_000)
        if all(port_free(p) for k in range(n)
               for p in (base + k, base + 1000 + k)):
            return base
    raise PhaseError("topology: no free range of ports")


def topology(*args: str, env=None):
    """``python -m binder_torch.topology <args>``: its exit code and
    what it printed."""
    proc = subprocess.run(
        [sys.executable, "-m", "binder_torch.topology", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=TOPOLOGY_CALL_S, env=env)
    return proc.returncode, proc.stdout + proc.stderr


def topology_config(tmp: str, zk_port: int) -> str:
    """The shipped ``etc/config.json`` over the port's ZooKeeper
    server, plus only what loopback needs; each override is printed.
    ``queryLog`` stays unset: the query log is on, as shipped."""
    with open(os.path.join(ROOT, "etc", "config.json")) as f:
        options = json.load(f)
    if "queryLog" in options:
        raise PhaseError("topology: etc/config.json sets queryLog")
    overrides = {
        "store": {"backend": "zookeeper", "host": "127.0.0.1",
                  "port": zk_port},
        "host": "127.0.0.1", "rrl.allowlist": ["127.0.0.0/8"],
        "logLevel": "info",
    }
    return write_overridden(options, overrides,
                            os.path.join(tmp, "topology.json"), "topology")


def pid_running(pid: int) -> bool:
    """True while ``pid`` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(") ", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def read_int(path: str) -> int:
    with open(path) as f:
        return int(f.read().strip())


def wait_balancer(sockdir: str, backends: int, direct: int,
                  deadline: float):
    """The balancer's stats once ``backends`` backends are healthy and
    ``direct`` of them answer over the passed socket."""
    while True:
        try:
            stats = balancer_stats(sockdir)
            up = [b for b in stats["backends"] if b["healthy"]]
            if len(up) == backends and \
                    sum(bool(b.get("direct")) for b in up) == direct:
                return stats
        except (OSError, ValueError):
            up = []
        if time.monotonic() > deadline:
            raise PhaseError(f"topology: {len(up)} healthy backend(s), "
                             f"expected {backends} ({direct} direct)")
        time.sleep(0.1)


def forwarded_by(stats, base: int):
    """``{instance index: forwarded}`` from the balancer's stats."""
    return {int(os.path.basename(b["path"])) - base: b["forwarded"]
            for b in stats["backends"]}


def wait_host(port: int, i: int, hosts: int, deadline: float) -> None:
    """Ask host ``i`` of port ``port`` until it answers right."""
    name = host_name(i, max(1, min(1024, hosts // 512)))
    while True:
        reply = fresh_ask(port, name, 1, required=False)
        if reply is not None and a_addrs(reply) == [host_addr(i)]:
            return
        if time.monotonic() > deadline:
            raise PhaseError(f"topology: {name} not served on :{port}")
        time.sleep(0.05)


def replies_from(port: int, name: str, sources):
    """The reply to one A query for ``name`` from each address of
    ``sources`` (asked up to three times; None when none came)."""
    from binder_torch.dns import Type, make_query
    out = []
    for k, src in enumerate(sources):
        q = make_query(name, Type.A, qid=0x300 + k).encode()
        got = None
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.bind((src, 0))
            s.settimeout(REPLY_STALL_S / 5)
            for _ in range(3):
                s.sendto(q, ("127.0.0.1", port))
                try:
                    got = s.recv(65535)
                    break
                except socket.timeout:
                    continue
        out.append(got)
    return out


def absent_checks(ports):
    """A name the zone lacks, asked three times of each server on its
    own port (so no balancer cache answers the repeats): REFUSED every
    time.  It is the shape of the C answer cache (the serve mix is all
    zone-table shapes), so the repeats are that cache's hits; returns
    the errors."""
    from binder_torch.dns import Message, Rcode
    errors = []
    for port in ports:
        for k in range(3):
            data = fresh_ask(port, f"nope.{DOMAIN}", 0x400 + k,
                             required=False)
            rcode = None if data is None else Message.decode(data).rcode
            if rcode != Rcode.REFUSED:
                errors.append(f"nope.{DOMAIN} on :{port}: rcode {rcode}")
    return errors


def query_lines(log_path: str, offset: int = 0) -> int:
    """``DNS query`` lines of an instance log from byte ``offset``."""
    n = 0
    with open(log_path, "rb") as f:
        f.seek(offset)
        for line in f:
            if line.startswith(b"{"):
                try:
                    n += json.loads(line).get("msg") == "DNS query"
                except ValueError:
                    continue
    return n


def exposition_sums(text: str, families):
    """:func:`metric_sum` of each of ``families`` in one pass; a name
    ``family@le`` is the cumulative count of histogram ``family`` at
    bucket ``le``."""
    want = {}
    for name in families:
        fam, _, le = name.partition("@")
        want.setdefault(fam + "_bucket" if le else fam, []).append(
            (name, f'le="{le}"' if le else None))
    out = dict.fromkeys(families, 0.0)
    for line in text.splitlines():
        for name, le in want.get(line.split("{", 1)[0].split(" ", 1)[0],
                                 ()):
            if le is None or le in line:
                out[name] += float(line.rsplit(" ", 1)[1])
    return out


#: what the topology series reads of each backend's ``/metrics``
TOPOLOGY_FAMILIES = {
    "completed": "binder_requests_completed",
    "zk_connected": "binder_zk_connected",
    "zk_sessions": "binder_zk_sessions_established",
    "rebuilds": "binder_store_session_rebuilds",
    "zk_outstanding": "binder_zk_outstanding_requests",
    "degraded": "binder_degraded_state",
    "lag_samples": "binder_loop_lag_seconds_count",
    "lag_under": "binder_loop_lag_seconds@0.25",
    "lag_max": "binder_loop_lag_max_seconds"}


def topology_reading(base: int, backends: int, sockdir: str, pids, live):
    """One reading of the topology under its stream: the client's
    counts (``live``, :func:`udp_flows`), each backend's completed
    queries, ZooKeeper session gauges, session rebuilds and loop-lag
    samples over the watchdog's 250 ms from its ``/metrics`` (left out
    while it does not answer), the balancer's per-backend forwards and
    health and its drops, the CPU seconds of each process of
    ``pids()`` (name: pid; this process's own by name ``smoke``)."""
    cpu = {"smoke": time.process_time()}
    for name, pid in pids().items():
        try:
            cpu[name] = cpu_seconds(pid)
        except (OSError, IndexError, ValueError):
            continue
    out = {"client": dict(live), "cpu": cpu, "backends": {},
           "balancer": None}
    for k in range(backends):
        try:
            got = exposition_sums(metrics_text(base + 1000 + k),
                                  TOPOLOGY_FAMILIES.values())
        except OSError:
            continue
        row = {key: got[fam] for key, fam in TOPOLOGY_FAMILIES.items()}
        row["stalls"] = row.pop("lag_samples") - row.pop("lag_under")
        out["backends"][k] = row
    try:
        stats = balancer_stats(sockdir)
    except (OSError, ValueError):
        return out
    out["balancer"] = {
        "forwarded": forwarded_by(stats, base),
        "healthy": {int(os.path.basename(b["path"])) - base: b["healthy"]
                    for b in stats["backends"]},
        **{k: stats.get(k) for k in ("udp_queries", "drops", "wq_overflows",
                                     "backend_stalls")}}
    return out


def topology_series(points, backends: int, t_start: float, kill_at=None,
                    restored_at=None, acks=(), victim_forwarded_at_kill=None):
    """The 1 Hz series of :func:`topology_reading` as rows of what
    changed since the reading before, each with its second since
    ``t_start`` (unix); the churn's ``set_data`` acknowledgements
    (:func:`per_second`) beside them; and a summary: the client's
    answers a second, each process's busy share and those at a full
    core, new sessions, loop stalls, the forwards the balancer dealt
    the killed backend (the last instance) after its kill and before
    it was healthy again, the acknowledgement latencies."""
    acks = {int(t): (n, p50, mx) for t, n, p50, mx in acks}
    rows = []
    for (t0, a), (t1, b) in zip(points, points[1:]):
        dt = t1 - t0
        row = {"t": round(t1 - t_start, 2),
               "answered_per_s": (b["client"].get("answered", 0)
                                  - a["client"].get("answered", 0)) / dt,
               "retries": b["client"].get("retries", 0)
               - a["client"].get("retries", 0),
               "lost": b["client"].get("lost", 0)
               - a["client"].get("lost", 0),
               "busy": {k: round((b["cpu"][k] - a["cpu"][k]) / dt, 3)
                        for k in b["cpu"] if k in a["cpu"]
                        and b["cpu"][k] >= a["cpu"][k]}}
        # counters: what each backend added (a restarted backend's
        # counters start again from zero)
        for key in ("completed", "stalls", "zk_sessions", "rebuilds"):
            row[key] = [None if k not in a["backends"]
                        or k not in b["backends"] else
                        counter_delta(a["backends"][k][key],
                                      b["backends"][k][key])
                        for k in range(backends)]
        for key in ("zk_connected", "zk_outstanding", "degraded",
                    "lag_max"):
            row[key] = [b["backends"].get(k, {}).get(key)
                        for k in range(backends)]
        if a["balancer"] and b["balancer"]:
            row["forwarded"] = [b["balancer"]["forwarded"].get(k, 0)
                                - a["balancer"]["forwarded"].get(k, 0)
                                for k in range(backends)]
            row["healthy"] = [b["balancer"]["healthy"].get(k)
                              for k in range(backends)]
            row["balancer_queries"] = (b["balancer"]["udp_queries"] or 0) \
                - (a["balancer"]["udp_queries"] or 0)
            row["balancer_drops"] = b["balancer"]["drops"]
        n, p50, mx = acks.get(int(t1), (0, None, None))
        row.update(acks=n, ack_p50_ms=p50, ack_max_ms=mx)
        rows.append(row)
    streaming = [r for r in rows if r["answered_per_s"] > 0]
    rates = [r["answered_per_s"] for r in streaming]
    victim = backends - 1
    names = sorted({k for r in rows for k in r["busy"]})
    median_busy = {k: float(np.median([r["busy"].get(k, 0.0)
                                       for r in streaming]))
                   for k in names} if streaming else {}
    summary = {
        "answered_per_s": [min(rates), float(np.median(rates)), max(rates)]
        if rates else None,
        "busy_max": {k: max(r["busy"].get(k, 0.0) for r in rows)
                     for k in names},
        "busy_median": median_busy,
        # a process at a full core for most of the stream bounds it
        "saturated": [k for k, v in median_busy.items()
                      if v >= SATURATED_BUSY],
        "zk_sessions_new": sum(x or 0 for r in rows
                               for x in r["zk_sessions"]),
        "rebuilds_new": sum(x or 0 for r in rows for x in r["rebuilds"]),
        "stalls": sum(x or 0 for r in rows for x in r["stalls"]),
        "lag_max_s": max((x or 0 for r in rows for x in r["lag_max"]),
                         default=None),
        "ack_max_ms": max((r["ack_max_ms"] for r in rows
                           if r["ack_max_ms"] is not None), default=None),
        "ack_p50_max_ms": max((r["ack_p50_ms"] for r in rows
                               if r["ack_p50_ms"] is not None),
                              default=None),
        "retries": sum(r["retries"] for r in rows),
        "lost": sum(r["lost"] for r in rows)}
    if kill_at is not None:
        summary["kill_s"] = kill_at - t_start
        # what the balancer dealt the killed backend from the kill
        # until it was healthy again
        down = [p["balancer"]["forwarded"].get(victim, 0)
                for t, p in points if t > kill_at and p["balancer"]
                and not p["balancer"]["healthy"].get(victim)]
        if down and victim_forwarded_at_kill is not None:
            summary["victim_forwarded_while_down"] = \
                max(down) - victim_forwarded_at_kill
        summary["victim_down_readings"] = len(down)
    if restored_at is not None:
        summary["restored_s"] = restored_at - t_start
    return rows, summary


#: a process whose median busy share over the stream's seconds reaches
#: this runs at a full core: what the stream can go no faster than
SATURATED_BUSY = 0.9


def counter_delta(a: float, b: float) -> float:
    """What a counter added from reading ``a`` to reading ``b``; a
    process that restarted counts again from zero."""
    return b - a if b >= a else b


def topology_phase(hosts: int = HOSTS, n_udp: int = TOPOLOGY_UDP,
                   backends: int = TOPOLOGY_BACKENDS, native=None):
    """The shipped topology with its production posture: ``backends``
    ``python -m binder_torch.main -b`` servers, each with its own
    ZooKeeper session and mirror, supervised by ``instance_adjust``
    behind ``mbalancer`` with its answer cache on, the query log on,
    under the serve mix and churn, with a backend SIGKILLed and
    restored by ``topology start``.  Returns the stream's latencies
    (microseconds).

    ``mbalancer`` answers from its cache only for backends that relay
    their replies through it; a backend on direct return answers the
    client itself and the cache never sees its answers
    (docs/balancer-protocol.md).  So the first half of the instances
    start without direct return (``BINDER_NO_DIRECT_RETURN=1``, the
    mixed-version posture), and ``topology start`` then scales to
    ``backends`` with it: the cache is in the path of half the clients
    and the freshness probes, direct return in that of the others."""
    import asyncio
    import threading
    rng = random.Random(SEED + 5)
    relay = backends // 2
    victim = backends - 1            # a direct-return instance
    procs = []
    pids = set()                     # every instance and balancer pid
    # the cores this process may run on: what the balancer, the
    # backends, the stand-in, the churn and the client share
    report = {"zone_names": hosts, "backends": backends,
              "relay_backends": relay,
              "host_cpus": len(os.sched_getaffinity(0))}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_topology_") as tmp:
        rundir = os.path.join(tmp, "run")
        state = os.path.join(rundir, "state")
        sockdir = os.path.join(rundir, "sockets")
        started = False
        watch, live, killed, restored, t_series = None, {}, {}, {}, None
        zk = ZooKeeper(hosts, tmp)
        procs.append(zk.proc)
        try:
            report["zk_znodes"] = zk.znodes
            report["seed_s"] = zk.seed_s
            config = topology_config(tmp, zk.port)
            base = free_base(backends)
            report["base_port"] = base
            start = ["start", "-c", config, "-D", rundir, "-p", "0",
                     "--bind", "127.0.0.1", "-B", str(base)]

            def instance_pid(k: int) -> int:
                return read_int(os.path.join(state,
                                             f"binder-{base + k}.pid"))

            def mport(k: int) -> int:
                return base + 1000 + k

            t0 = time.monotonic()
            started = True
            for n, env in ((relay, dict(os.environ,
                                        BINDER_NO_DIRECT_RETURN="1")),
                           (backends, None)):
                rc, out = topology(*start, "-n", str(n), env=env)
                log(f"topology start -n {n}: rc {rc}; "
                    + out.strip().replace("\n", "; "))
                if rc != 0:
                    raise PhaseError(f"topology: start -n {n} exited {rc}")
            report["start_s"] = time.monotonic() - t0
            port = read_int(os.path.join(rundir, "balancer.port"))
            pids.add(read_int(os.path.join(rundir, "balancer.pid")))
            inst = {k: instance_pid(k) for k in range(backends)}
            pids.update(inst.values())
            wait_balancer(sockdir, backends, backends - relay,
                          t0 + TOPOLOGY_BOOT_DEADLINE_S)
            # boot: every backend's own walk reaches the last host, every
            # host answers through the balancer, and a sample answers on
            # every backend's own port
            boot_deadline = t0 + TOPOLOGY_BOOT_DEADLINE_S
            for k in range(backends):
                wait_host(base + k, hosts - 1, hosts, boot_deadline)
            zone_sweep(port, hosts, boot_deadline, what="topology",
                       sources=BALANCER_CLIENTS)
            sample = rng.sample(range(hosts), min(TOPOLOGY_SAMPLE, hosts))
            for k in range(backends):
                zone_sweep(base + k, hosts, boot_deadline, indices=sample,
                           what=f"topology backend {k}")
            report["boot_s"] = time.monotonic() - t0
            log(f"topology: {backends} backends served every host after "
                f"{report['boot_s']}s")

            errors = []
            with open(os.path.join(rundir, "metric_ports")) as f:
                report["metric_ports"] = [int(p) for p in f.read().split()]
            if report["metric_ports"] != [mport(k) for k in range(backends)]:
                errors.append(f"metric_ports {report['metric_ports']}")
            rc, out = topology("status", "-D", rundir)
            report["status_online"] = out.count("online")
            if rc != 0 or out.count("online") != backends + 1:
                errors.append(f"status: {out.strip()!r}")
            for k, pid in inst.items():
                line = cmdline(pid)
                if "-m binder_torch.main" not in line or \
                        "binder_tpu" in line:
                    raise PhaseError(f"topology: instance {k} runs "
                                     f"{line!r}")

            churn = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--churn",
                 str(zk.port), str(port), "--spread"], cwd=ROOT,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            procs.append(churn)
            if churn.stdout.readline().strip() != b"churn: ready":
                raise PhaseError("topology: churn process did not start")

            victim_log = os.path.join(state, f"binder-{base + victim}.log")

            def reconverge():
                restored["rc"], restored["out"] = topology(
                    *start, "-n", str(backends))
                restored["s"] = time.monotonic() - killed["at"]
                restored["unix"] = time.time()

            thread = threading.Thread(target=reconverge)

            def on_progress(done):
                if killed or done < n_udp * KILL_AT:
                    return
                pid = inst[victim]
                cpu = cpu_seconds(pid)
                os.kill(pid, signal.SIGKILL)
                killed.update(pid=pid, cpu=cpu, at=time.monotonic(),
                              unix=time.time())
                try:
                    killed["forwarded"] = forwarded_by(
                        balancer_stats(sockdir), base).get(victim)
                except (OSError, ValueError):
                    killed["forwarded"] = None
                report["kill_after_s"] = killed["at"] - t0
                while pid_running(pid):
                    time.sleep(0.001)
                # what the killed process wrote ends here; its
                # successor appends to the same file
                killed["log_offset"] = os.path.getsize(victim_log)
                thread.start()

            queries = query_mix(rng, n_udp, hosts)
            c_lane0 = {k: native_reading(mport(k)) for k in range(backends)}
            cpu0 = {k: cpu_seconds(pid) for k, pid in inst.items()}
            client_cpu0 = time.process_time()
            # the 1 Hz series, from the stream's start to the restored
            # backend serving
            balancer_pid = read_int(os.path.join(rundir, "balancer.pid"))

            def series_pids():
                out = {"zk": zk.proc.pid, "churn": churn.pid,
                       "balancer": balancer_pid}
                for k in range(backends):
                    try:
                        out[f"backend{k}"] = instance_pid(k)
                    except (OSError, ValueError):
                        continue
                return out

            watch = Series(lambda: topology_reading(
                base, backends, sockdir, series_pids, live)).__enter__()
            t_series = time.time()
            t0 = time.monotonic()
            lat, stream_errors, retries = udp_flows(
                port, queries, FLOWS, CONCURRENCY, on_progress,
                sources=BALANCER_CLIENTS, live=live)
            udp_s = time.monotonic() - t0
            errors += stream_errors
            report.update(udp_queries=n_udp, udp_answered=len(lat),
                          udp_retries=retries, udp_qps=len(lat) / udp_s,
                          client_cpu_busy=(time.process_time()
                                           - client_cpu0) / udp_s)
            if not killed:
                raise PhaseError("topology: no backend was killed")
            errors += absent_checks([base + k for k in range(backends)
                                     if k != victim])
            per = {k: {"instance": base + k, "pid": [inst[k]],
                       "direct": k >= relay} for k in range(backends)}
            now = time.monotonic()
            for k in range(backends):
                if k == victim:
                    per[k]["busy"] = ((killed["cpu"] - cpu0[k])
                                      / (killed["at"] - t0))
                    continue
                per[k]["busy"] = (cpu_seconds(inst[k]) - cpu0[k]) / (now - t0)
                after = native_reading(mport(k))
                errors += native_gate(f"topology backend {k}", c_lane0[k],
                                      after)
                per[k].update(native_delta(c_lane0[k], after))

            churn.stdin.close()
            out = churn.stdout.read().decode().strip().splitlines()
            if churn.wait(timeout=60) != 0 or not out:
                raise PhaseError("topology: churn process failed")
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

            # the re-converge: a new pid running the port, whose own
            # walk serves the zone, serving a write made after the crash
            thread.join(TOPOLOGY_CALL_S)
            if thread.is_alive() or restored.get("rc") != 0:
                raise PhaseError(f"topology: re-converge failed: "
                                 f"{restored.get('out', '')[-2000:]}")
            new_pid = instance_pid(victim)
            pids.add(new_pid)
            line = cmdline(new_pid)
            if new_pid == killed["pid"] or \
                    "-m binder_torch.main" not in line or \
                    "binder_tpu" in line:
                raise PhaseError(f"topology: restored instance {new_pid} "
                                 f"runs {line!r}")
            per[victim]["pid"].append(new_pid)
            wait_host(base + victim, hosts - 1, hosts,
                      time.monotonic() + TOPOLOGY_BOOT_DEADLINE_S)
            zone_sweep(base + victim, hosts,
                       time.monotonic() + TOPOLOGY_BOOT_DEADLINE_S,
                       indices=sample, what="topology restored backend")
            report["restore"] = {"start_s": restored["s"],
                                 "serving_s": time.monotonic()
                                 - killed["at"]}
            report["series"], report["series_summary"] = topology_series(
                watch.stop(), backends, t_series, killed["unix"],
                restored["unix"], churned["acks"], killed["forwarded"])
            log(json.dumps({"topology_series_summary":
                            report["series_summary"]}))
            wait_balancer(sockdir, backends, backends - relay,
                          time.monotonic() + BALANCER_DEADLINE_S)
            errors += tcp_checks(port, query_mix(rng, N_TCP, hosts))

            stats0 = balancer_stats(sockdir)
            before = native_reading(mport(victim))
            asyncio.run(zk_set(zk.port, "/com/foo/churn/c00",
                               host_json(POSTKILL_ADDR)))
            deadline = time.monotonic() + FRESH_LIMIT_S
            while True:
                got = [a_addrs(data) if data else None for data in
                       replies_from(port, churn_name(0), FRESH_CLIENTS)]
                if all(a == [POSTKILL_ADDR] for a in got):
                    break
                if time.monotonic() > deadline:
                    errors.append(f"post-kill write not served on every "
                                  f"fresh address: {got}")
                    break
                time.sleep(0.05)
            _, fresh_errors, _ = udp_flows(
                port, query_mix(rng, TOPOLOGY_FRESH_UDP, hosts), FLOWS,
                CONCURRENCY, sources=FRESH_CLIENTS)
            errors += fresh_errors + absent_checks([base + victim])
            after = native_reading(mport(victim))
            errors += native_gate("topology restored backend", before,
                                  after)
            per[victim].update(native_delta(before, after))
            stats = balancer_stats(sockdir)
            moved = {k: forwarded_by(stats, base)[k]
                     - forwarded_by(stats0, base)[k]
                     for k in range(backends)}
            report["forwarded_after_restore"] = moved
            if min(moved.values()) <= 0:
                errors.append(f"a backend got no fresh address: {moved}")
            report["mbalancer"] = {k: stats.get(k) for k in (
                "udp_queries", "tcp_queries", "cache_hits", "cache_misses",
                "cache_invalidations", "fd_passes", "direct_forwards",
                "drops", "wq_overflows")}
            report["forwarded"] = forwarded_by(stats, base)
            if sorted(report["forwarded"]) != list(range(backends)) or \
                    min(report["forwarded"].values()) <= 0:
                errors.append(f"a backend served nothing: "
                              f"{report['forwarded']}")
            if stats["cache_invalidations"] <= 0:
                errors.append("the balancer's cache dropped no entry")
            if stats["direct_forwards"] <= 0:
                errors.append("no query went to a direct-return backend")

            # every query a backend completed is one line of its log:
            # read the counters with the streams done and the rings
            # drained, stop, then count (the logs are block-buffered)
            time.sleep(0.5)
            completed = {k: metric_sum(http_json(mport(k), "/metrics"),
                                       "binder_requests_completed")
                         for k in range(backends)}
            rc, out = topology("stop", "-D", rundir)
            report["stop_rc"] = rc
            if rc == 0:
                started = False        # nothing left for the cleanup
            else:
                errors.append(f"stop exited {rc}: {out.strip()!r}")
            deadline = time.monotonic() + DRAIN_DEADLINE_S
            while any(pid_running(p) for p in pids):
                if time.monotonic() > deadline:
                    errors.append(f"running after stop: "
                                  f"{[p for p in pids if pid_running(p)]}")
                    break
                time.sleep(0.05)
            rc, out = topology("status", "-D", rundir)
            if "online" in out or "balancer: down" not in out:
                errors.append(f"status after stop: {out.strip()!r}")
            for k in range(backends):
                lines = query_lines(
                    os.path.join(state, f"binder-{base + k}.log"),
                    killed["log_offset"] if k == victim else 0)
                per[k].update(log_lines=lines, completed=completed[k])
                if lines != completed[k]:
                    errors.append(f"backend {k}: {lines} query log "
                                  f"line(s) for {completed[k]} "
                                  "completed queries")
            report["per_backend"] = [per[k] for k in range(backends)]
            if native is not None:
                native["topology"] = [
                    {f: per[k].get(f) for f in NATIVE_COUNTERS}
                    for k in range(backends)]
            report["errors"] = len(errors)
        except PhaseError:
            if watch is not None and watch.points:
                rows, summary = topology_series(
                    watch.stop(), backends, t_series, killed.get("unix"),
                    restored.get("unix"),
                    victim_forwarded_at_kill=killed.get("forwarded"))
                log(json.dumps({"topology_series": rows,
                                "topology_series_summary": summary}))
            logs = [zk.log, os.path.join(rundir, "balancer.log")]
            if os.path.isdir(state):
                logs += sorted(os.path.join(state, f)
                               for f in os.listdir(state)
                               if f.endswith(".log"))
            for path in logs:
                if os.path.exists(path):
                    tail = read_bytes(path)[-3000:].decode(errors="replace")
                    log(f"--- {os.path.basename(path)} (last 3000 bytes) "
                        f"---\n{tail}")
            raise
        finally:
            if watch is not None:
                watch.stop()
            if started:
                topology("stop", "-D", rundir)
            if os.path.isdir(state):
                for f in os.listdir(state):
                    if f.endswith(".pid"):
                        pids.add(read_int(os.path.join(state, f)))
            for pid in pids:
                if pid_running(pid):
                    os.kill(pid, signal.SIGKILL)
            for proc in reversed(procs):
                reap(proc)
        left = descendants(os.getpid()) + [p for p in pids
                                           if pid_running(p)]
        report["left_after_stop"] = left
    pct = np.percentile(np.asarray(lat, np.float64), [50, 99]) \
        if lat else [float("nan")] * 2
    report.update(udp_p50_us=float(pct[0]), udp_p99_us=float(pct[1]))
    log(json.dumps({"topology": report}))
    check_phase("topology", errors, left)
    return lat


# -- phase 7: systemd -------------------------------------------------

SYSTEMD_INSTANCES = 4
SYSTEMD_BLAST = 60_000
#: dnsblast's client addresses (127.20.0.1-16) and queries in flight
SYSTEMD_BLAST_SOURCES = 16
SYSTEMD_BLAST_WINDOW = 64
SYSTEMD_BLAST_TEMPLATES = 4096
#: the Python client's queries, every reply checked: half as many as
#: dnsblast sends (``STREAM_CUTS``)
SYSTEMD_UDP = SYSTEMD_BLAST // 2
#: the fresh client addresses' stream after the restore, as topology's
#: (``STREAM_CUTS``)
SYSTEMD_FRESH_UDP = TOPOLOGY_FRESH_UDP
SYSTEMD_CALL_S = 300.0
#: the Python client's addresses on the installed stack, and those of
#: each later check, so every check meets the balancer's client
#: affinity afresh
SYSTEMD_CLIENTS = [f"127.0.4.{k + 1}" for k in range(FLOWS)]
SCALE_CLIENTS = [f"127.0.5.{k + 1}" for k in range(FLOWS)]
RESTORE_CLIENTS = [f"127.0.6.{k + 1}" for k in range(FLOWS)]
ZKPUT_PATH = "/com/foo/zkput"
ZKPUT_ADDR = "10.204.0.1"
UNITS_DIR = os.path.join("binder_torch", "deploy", "systemd")


def systemd_install(tmp: str):
    """The install sketch of ``binder_torch/deploy/README.md`` under
    ``tmp``: an install root (``/opt/binder``) linking the checkout's
    ``binder_torch``, ``native`` and ``deploy`` with its own ``etc/``,
    the units copied where systemd would read them, a run directory
    (``/run/binder``) and the ``systemctl`` stand-in's state; returns
    their paths."""
    import shutil
    paths = {k: os.path.join(tmp, k)
             for k in ("opt", "units", "run", "shim")}
    os.makedirs(os.path.join(paths["opt"], "etc"))
    for name in ("binder_torch", "native", "deploy"):
        os.symlink(os.path.join(ROOT, name),
                   os.path.join(paths["opt"], name))
    shutil.copytree(os.path.join(ROOT, UNITS_DIR), paths["units"])
    return paths


def shim_log(paths, since: int = 0):
    """The ``systemctl`` invocations the stand-in logged, from line
    ``since``."""
    try:
        with open(os.path.join(paths["shim"], "log")) as f:
            return f.read().splitlines()[since:]
    except FileNotFoundError:
        return []


def shim_pid(paths, unit: str):
    """The pid the stand-in recorded for ``unit``'s process."""
    with open(os.path.join(paths["shim"], "units", unit + ".json")) as f:
        return json.load(f).get("pid")


def shim_pids(paths):
    """Every unit process and watcher the stand-in started."""
    out = []
    try:
        with open(os.path.join(paths["shim"], "pids")) as f:
            for line in f:
                out += [int(p) for p in line.split()[1:]]
    except FileNotFoundError:
        pass
    return out


def verb_errors(what: str, lines, expect, forbid=()):
    """Errors unless every line of ``expect`` was issued (a tuple: in
    that order) and no line starts with one of ``forbid``."""
    errors = []
    for want in expect:
        seq = (want,) if isinstance(want, str) else want
        at = -1
        for line in seq:
            try:
                at = lines.index(line, at + 1)
            except ValueError:
                errors.append(f"{what}: no `systemctl {line}` in order "
                              f"{list(seq)}")
                break
    for line in lines:
        if line.startswith(tuple(forbid)):
            errors.append(f"{what}: unexpected `systemctl {line}`")
    return errors


def systemd_phase(hosts: int = HOSTS, n_blast: int = SYSTEMD_BLAST,
                  n_udp: int = SYSTEMD_UDP,
                  instances: int = SYSTEMD_INSTANCES, native=None):
    """The port installed as on a systemd host: ``binder_torch/deploy/
    systemd/`` run by the ``systemctl`` stand-in, ``instance_adjust -m
    systemd`` converging ``binder@.service`` instances behind
    ``binder-balancer.service`` over the port's ZooKeeper server;
    ``dnsblast`` (built by the port) and the Python client through the
    balancer, ``bdig`` and ``zkput`` through the port's CLIs, a scale
    down and up, a SIGKILL restored by a converge, and a teardown that
    leaves nothing."""
    import threading
    from binder_torch import fastio_build
    from binder_torch.config.render import render_manifest
    from binder_torch.deploy import systemctl_shim
    rng = random.Random(SEED + 6)
    report = {"zone_names": hosts, "instances": instances}
    errors = []
    procs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_systemd_") as tmp:
        paths = systemd_install(tmp)
        sockdir = os.path.join(paths["run"], "sockets")
        zk_log = os.path.join(tmp, "zk.log")     # ZooKeeper's log
        metadata = os.path.join(paths["opt"], "etc", "metadata.json")
        config_path = os.path.join(paths["opt"], "etc", "config.json")
        # the stand-in's watchers outlive the ``systemctl`` that started
        # them: they are reaped here, not left to pid 1
        child_subreaper(True)
        try:
            # 1. the port's ``make -C native``
            t0 = time.monotonic()
            built = subprocess.run(
                [sys.executable, "-m", "binder_torch.fastio_build",
                 "install"], cwd=paths["opt"], capture_output=True,
                text=True, timeout=SYSTEMD_CALL_S)
            report["install_s"] = time.monotonic() - t0
            if built.returncode != 0:
                raise PhaseError(f"systemd: fastio_build install exited "
                                 f"{built.returncode}: {built.stderr}")
            report["build_s"] = {}
            for line in built.stdout.splitlines():
                m = re.match(r"\S+/bin/(\S+) -> .*\(built in (\S+) s\)",
                             line)
                if m:
                    report["build_s"][m.group(1)] = float(m.group(2))
            log("systemd: fastio_build install: "
                + built.stdout.strip().replace("\n", "; "))
            binaries = {name: fastio_build.bin_path(name)
                        for name in fastio_build.ARTIFACTS}
            for name, link in binaries.items():
                if os.path.realpath(link) != os.path.realpath(
                        fastio_build.artifact_path(name)):
                    raise PhaseError(f"systemd: {link} is not {name}")
            adjust = binaries["instance_adjust"]

            # the store: the deploy phase's zone in the port's server
            zk = ZooKeeper(hosts, tmp)
            procs.append(zk.proc)
            report["zk_znodes"] = zk.znodes
            report["seed_s"] = zk.seed_s

            # the stand-in on PATH, its rewrites printed
            dns_port = free_base(1)
            bindir = systemctl_shim.setup(paths["shim"], paths["units"],
                                          paths["opt"], paths["run"],
                                          dns_port)
            env = dict(os.environ, PATH=bindir + os.pathsep
                       + os.environ.get("PATH", ""))

            def systemctl(*args):
                proc = subprocess.run(["systemctl", *args], env=env,
                                      capture_output=True, text=True,
                                      timeout=SYSTEMD_CALL_S)
                return proc.returncode, proc.stdout.strip()

            def converge(count: int, what: str):
                """``instance_adjust -m systemd -i count -w``; returns
                the stand-in's log lines of this converge and what
                instance_adjust printed."""
                since = len(shim_log(paths))
                t0 = time.monotonic()
                proc = subprocess.run(
                    [adjust, "-m", "systemd", "-D", paths["units"],
                     "-d", sockdir, "-B", str(base), "-i", str(count),
                     "-w", "-r",
                     "systemctl restart binder-metric-ports.service"],
                    env=env, capture_output=True, text=True,
                    timeout=SYSTEMD_CALL_S)
                seconds = time.monotonic() - t0
                out = proc.stdout.strip().replace("\n", "; ")
                log(f"systemd: {what}: instance_adjust -i {count} exited "
                    f"{proc.returncode} in {seconds}s: {out}")
                if proc.returncode != 0:
                    raise PhaseError(f"systemd: {what}: instance_adjust "
                                     f"exited {proc.returncode}: "
                                     f"{proc.stderr.strip()}")
                report.setdefault("converge_s", {})[what] = seconds
                return shim_log(paths, since), proc.stdout.splitlines()

            # 2. the config, rendered by binder-config.service
            with open(metadata, "w") as f:
                json.dump(TRITON_METADATA, f)
            rc, out = systemctl("start", "binder-config.service")
            if rc != 0:
                raise PhaseError(f"systemd: binder-config.service: rc {rc}")
            with open(config_path) as f:
                rendered = json.load(f)
            want = json.loads(render_manifest(
                os.path.join(ROOT, MANIFEST), TRITON_METADATA,
                output_path=None))
            if rendered != want:
                errors.append("binder-config.service rendered another "
                              "config than the template gives")
            write_overridden(rendered, {
                "store.port": zk.port,
                "rrl": {"allowlist": ["127.0.0.0/8"]}}, config_path,
                "systemd")
            # a hand-edited config: binder-config.service's condition
            # skips the render every instance start pulls in
            os.replace(metadata, metadata + ".rendered")
            log("systemd: etc/metadata.json set aside: the instances' "
                "Wants=binder-config.service now skips on its condition")

            # 3. the balancer, then the instances
            base = free_base(instances)
            report["base_port"] = base
            report["dns_port"] = dns_port
            rc, out = systemctl("start", "binder-balancer.service")
            if rc != 0:
                raise PhaseError(f"systemd: binder-balancer.service: "
                                 f"rc {rc}")
            bal_pid = shim_pid(paths, "binder-balancer.service")
            deadline = time.monotonic() + BALANCER_DEADLINE_S
            while not os.path.exists(os.path.join(sockdir,
                                                  ".balancer.stats")):
                if time.monotonic() > deadline:
                    raise PhaseError("systemd: the balancer has no stats "
                                     "socket")
                time.sleep(0.05)
            units = [f"binder@{base + k}.service" for k in range(instances)]

            def mport(k: int) -> int:
                return base + 1000 + k

            t0 = time.monotonic()
            lines, out = converge(instances, "create")
            errors += verb_errors("create", lines, [
                ("daemon-reload", f"start {units[0]}")]
                + [(f"enable {u}", f"start {u}") for u in units]
                + ["restart binder-metric-ports.service"])
            if lines.count("daemon-reload") != 1:
                errors.append(f"create: {lines.count('daemon-reload')} "
                              "daemon-reload(s)")
            boot_deadline = t0 + TOPOLOGY_BOOT_DEADLINE_S
            wait_balancer(sockdir, instances, instances, boot_deadline)
            for k in range(instances):
                wait_host(base + k, hosts - 1, hosts, boot_deadline)
            # 4. every host through the balancer, a sample on each
            # instance's own port
            zone_sweep(dns_port, hosts, boot_deadline, what="systemd",
                       sources=BALANCER_CLIENTS)
            sample = rng.sample(range(hosts), min(TOPOLOGY_SAMPLE, hosts))
            for k in range(instances):
                zone_sweep(base + k, hosts, boot_deadline, indices=sample,
                           what=f"systemd instance {k}")
            report["boot_s"] = time.monotonic() - t0
            log(f"systemd: {instances} instances served every host after "
                f"{report['boot_s']}s")
            inst = {k: shim_pid(paths, units[k]) for k in range(instances)}
            for k, pid in inst.items():
                line = cmdline(pid)
                if "-m binder_torch.main" not in line or \
                        "binder_tpu" in line:
                    raise PhaseError(f"systemd: instance {k} runs "
                                     f"{line!r}")
            errors += bdig_checks(dns_port, hosts)

            # 5. dnsblast through the balancer
            c_lane0 = {k: native_reading(mport(k))
                       for k in range(instances)}
            report["dnsblast"] = dnsblast_run(
                binaries["dnsblast"], dns_port, n_blast, hosts, rng, tmp,
                {"mbalancer": bal_pid,
                 **{f"instance {k}": inst[k] for k in range(instances)}})
            if report["dnsblast"]["errors"]:
                errors.append(f"dnsblast: {report['dnsblast']}")
            for k in range(instances):
                after = native_reading(mport(k))
                errors += native_gate(f"systemd instance {k}", c_lane0[k],
                                      after)

            # 6. the Python client on the same stack, every reply checked
            cpu0 = {k: cpu_seconds(pid) for k, pid in inst.items()}
            bal_cpu0 = cpu_seconds(bal_pid)
            client_cpu0 = time.process_time()
            t0 = time.monotonic()
            lat, stream_errors, retries = udp_flows(
                dns_port, query_mix(rng, n_udp, hosts), FLOWS, CONCURRENCY,
                sources=SYSTEMD_CLIENTS)
            udp_s = time.monotonic() - t0
            errors += stream_errors
            pct = np.percentile(np.asarray(lat, np.float64), [50, 99]) \
                if lat else [float("nan")] * 2
            report["python_client"] = {
                "queries": n_udp, "answered": len(lat), "retries": retries,
                "qps": len(lat) / udp_s, "p50_us": float(pct[0]),
                "p99_us": float(pct[1]),
                "busy": {"client": (time.process_time() - client_cpu0)
                         / udp_s,
                         "mbalancer": (cpu_seconds(bal_pid) - bal_cpu0)
                         / udp_s,
                         **{f"instance {k}": (cpu_seconds(inst[k])
                                              - cpu0[k]) / udp_s
                            for k in range(instances)}}}
            errors += tcp_checks(dns_port, query_mix(rng, N_TCP, hosts))

            # 7. a fixture through the port's zkput, read back through
            # the balancer from every client address
            fixture = os.path.join(tmp, "zkput.json")
            with open(fixture, "w") as f:
                json.dump({ZKPUT_PATH: {"type": "host",
                                        "host": {"address": ZKPUT_ADDR}}},
                          f)
            put = subprocess.run(
                [sys.executable, "-m", "binder_torch.cli.zkput", "-z",
                 f"127.0.0.1:{zk.port}", fixture], cwd=ROOT,
                capture_output=True, text=True, timeout=60)
            t0 = time.monotonic()
            if put.returncode != 0 or f"put {ZKPUT_PATH}" not in put.stdout:
                errors.append(f"zkput exited {put.returncode}: "
                              f"{put.stdout} {put.stderr}")
            name = f"zkput.{DOMAIN}"
            while True:
                got = [a_addrs(data) if data else None for data in
                       replies_from(dns_port, name, FRESH_CLIENTS)]
                if all(a == [ZKPUT_ADDR] for a in got):
                    report["zkput_read_back_s"] = time.monotonic() - t0
                    break
                if time.monotonic() - t0 > FRESH_LIMIT_S:
                    errors.append(f"zkput write not read back on every "
                                  f"address: {got}")
                    break
                time.sleep(0.05)

            # 8. scale 4 -> 2 under a stream, then back to 4
            keep = instances // 2
            gone = units[keep:]
            stats0 = balancer_stats(sockdir)
            done = {}

            def scale_down():
                try:
                    done["lines"], _ = converge(keep, "scale down")
                finally:
                    done["at"] = time.monotonic()

            thread = threading.Thread(target=scale_down)
            thread.start()
            _, down_errors, down_retries = udp_flows(
                dns_port, query_mix(rng, 1 << 16, hosts), FLOWS,
                CONCURRENCY, sources=SCALE_CLIENTS,
                stop=lambda: "at" in done
                and time.monotonic() - done["at"] > 1.0)
            thread.join(SYSTEMD_CALL_S)
            errors += down_errors
            if "lines" not in done:
                raise PhaseError("systemd: the scale down failed")
            errors += verb_errors(
                "scale down", done["lines"],
                [(f"disable --now {u}", f"reset-failed {u}") for u in gone]
                + ["daemon-reload", "restart binder-metric-ports.service"],
                forbid=("start binder@", "restart binder@"))
            stats = balancer_stats(sockdir)
            moved = {k: forwarded_by(stats, base).get(k, 0)
                     - forwarded_by(stats0, base).get(k, 0)
                     for k in range(keep)}
            report["scale_down"] = {"forwarded_on_survivors": moved,
                                    "retries": down_retries}
            if min(moved.values()) <= 0:
                errors.append(f"scale down: a survivor forwarded nothing: "
                              f"{moved}")
            listed = systemctl("list-units", "--all", "--plain",
                               "--no-legend", "binder@*.service")[1]
            for k, u in enumerate(units[keep:], keep):
                if u in listed or os.path.exists(os.path.join(
                        paths["units"], u + ".d")) or \
                        pid_running(inst[k]):
                    errors.append(f"scale down: {u} left behind")

            t_up = time.monotonic()
            lines, _ = converge(instances, "scale up")
            errors += verb_errors(
                "scale up", lines, [("daemon-reload", f"start {gone[0]}")]
                + [(f"enable {u}", f"start {u}") for u in gone]
                + ["restart binder-metric-ports.service"],
                forbid=[f"{v} {u}" for u in units[:keep]
                        for v in ("start", "restart", "stop")])
            for k in range(keep, instances):
                inst[k] = shim_pid(paths, units[k])

            # 9. SIGKILL one instance while the re-added ones walk the
            # zone, restore it by a converge; then all three must serve
            victim = 1
            old = inst[victim]
            os.kill(old, signal.SIGKILL)
            t0 = time.monotonic()
            while systemctl("show", "-p", "ActiveState", "--value",
                            units[victim])[1] != "failed":
                if time.monotonic() - t0 > 30:
                    raise PhaseError(f"systemd: {units[victim]} not "
                                     "failed after SIGKILL")
                time.sleep(0.05)
            lines, out = converge(instances, "restore")
            errors += verb_errors(
                "restore", lines, [(f"reset-failed {units[victim]}",
                                    f"start {units[victim]}")])
            if f"restore binder-{base + victim}" not in out:
                errors.append(f"restore: instance_adjust printed {out}")
            new = inst[victim] = shim_pid(paths, units[victim])
            line = cmdline(new) if new else ""
            if new == old or "-m binder_torch.main" not in line or \
                    "binder_tpu" in line:
                raise PhaseError(f"systemd: restored instance {new} runs "
                                 f"{line!r}")
            deadline = time.monotonic() + TOPOLOGY_BOOT_DEADLINE_S
            for k in range(keep, instances):
                wait_host(base + k, hosts - 1, hosts, deadline)
                zone_sweep(base + k, hosts, deadline, indices=sample,
                           what=f"systemd re-added instance {k}")
            report["scale_up_serving_s"] = time.monotonic() - t_up
            wait_host(base + victim, hosts - 1, hosts, deadline)
            zone_sweep(base + victim, hosts, deadline, indices=sample,
                       what="systemd restored instance")
            wait_balancer(sockdir, instances, instances, deadline)
            report["restore"] = {"pid": [old, new],
                                 "serving_s": time.monotonic() - t0}
            stats0 = balancer_stats(sockdir)
            _, fresh_errors, _ = udp_flows(
                dns_port, query_mix(rng, min(n_udp, SYSTEMD_FRESH_UDP),
                                    hosts), FLOWS,
                CONCURRENCY, sources=RESTORE_CLIENTS)
            errors += fresh_errors
            stats = balancer_stats(sockdir)
            moved = {k: forwarded_by(stats, base)[k]
                     - forwarded_by(stats0, base)[k]
                     for k in range(instances)}
            report["forwarded_after_restore"] = moved
            if min(moved.values()) <= 0:
                errors.append(f"an instance got no fresh address: {moved}")

            # 10. the metric ports of the live instances
            with open(os.path.join(paths["run"], "metric_ports")) as f:
                report["metric_ports"] = [int(p) for p in f.read().split()]
            if report["metric_ports"] != [mport(k)
                                          for k in range(instances)]:
                errors.append(f"metric_ports {report['metric_ports']}")
            # a name the zone lacks, thrice on each instance's own port:
            # REFUSED, the C answer cache's shape (the serve mix is all
            # zone-table shapes)
            errors += absent_checks([base + k for k in range(instances)])
            report["c_lane"] = {k: native_reading(mport(k))
                                for k in range(instances)}
            for k, reading in report["c_lane"].items():
                if not reading["binder_fastpath_entries"] > 0:
                    errors.append(f"instance {k}: no C lane: {reading}")
            report["rewrites"] = open(os.path.join(
                paths["shim"], "rewrites")).read().splitlines()

            # 11. the teardown
            lines, _ = converge(0, "teardown")
            errors += verb_errors("teardown", lines,
                                  [f"disable --now {u}" for u in units])
            rc, _ = systemctl("stop", "binder-balancer.service")
            if rc != 0:
                errors.append(f"stop binder-balancer.service: rc {rc}")
            report["errors"] = len(errors)
        except PhaseError:
            logs = [zk_log]
            logdir = os.path.join(paths["shim"], "logs")
            if os.path.isdir(logdir):
                logs += sorted(os.path.join(logdir, f)
                               for f in os.listdir(logdir))
            for path in logs:
                if os.path.exists(path):
                    tail = read_bytes(path)[-3000:].decode(errors="replace")
                    log(f"--- {os.path.basename(path)} (last 3000 bytes) "
                        f"---\n{tail}")
            raise
        finally:
            # after the teardown every watcher exits once it has
            # recorded its unit's end; after a failure nothing stops them
            deadline = time.monotonic() + (5.0 if "errors" in report
                                           else 0.0)
            while any(pid_running(p) for p in shim_pids(paths)) and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            for p in shim_pids(paths):
                if pid_running(p):
                    os.kill(p, signal.SIGKILL)
            reap_orphans(shim_pids(paths))
            child_subreaper(False)
            for proc in reversed(procs):
                reap(proc)
        left = descendants(os.getpid()) + [p for p in shim_pids(paths)
                                           if pid_running(p)]
        report["left_after_stop"] = left
    log(json.dumps({"systemd": report}))
    if native is not None:
        native["systemd"] = report.get("c_lane")
    check_phase("systemd", errors, left)
    return report


def child_subreaper(on: bool) -> bool:
    """Make this process (or stop it being) the reaper of orphaned
    processes below it (Linux ``PR_SET_CHILD_SUBREAPER``)."""
    import ctypes
    try:
        return ctypes.CDLL(None, use_errno=True).prctl(
            36, int(on), 0, 0, 0) == 0
    except (OSError, AttributeError):
        return False


def reap_orphans(pids) -> None:
    """Collect the exit status of those of ``pids`` that ended as this
    process's children (orphans reparented to it)."""
    deadline = time.monotonic() + 5.0
    for pid in pids:
        while True:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                break                  # not ours, or already collected
            if done or time.monotonic() > deadline:
                break
            time.sleep(0.01)


def bdig_checks(port: int, hosts: int):
    """``python -m binder_torch.cli.bdig`` on a few names through the
    balancer: host A, its PTR, the service SRV over TCP and ``+short``;
    returns the errors."""
    from binder_torch.dns import reverse_name_for_ip
    racks = max(1, min(1024, hosts // 512))
    i = hosts // 2
    errors = []
    for args, want in (
            ([host_name(i, racks), "A"], host_addr(i)),
            ([reverse_name_for_ip(host_addr(i)), "PTR"],
             host_name(i, racks) + "."),
            ([f"_http._tcp.svc.{DOMAIN}", "SRV", "+tcp"], "8080"),
            ([f"svc.{DOMAIN}", "+short"], "10.0.1.1")):
        proc = subprocess.run(
            [sys.executable, "-m", "binder_torch.cli.bdig", "@127.0.0.1",
             "-p", str(port), *args], cwd=ROOT, capture_output=True,
            text=True, timeout=60)
        if proc.returncode != 0 or want not in proc.stdout or \
                ("+tcp" in args and "(TCP)" not in proc.stdout):
            errors.append(f"bdig {' '.join(args)}: rc {proc.returncode}, "
                          f"{proc.stdout!r}")
    return errors


def dnsblast_run(binary: str, port: int, n: int, hosts: int, rng, tmp: str,
                 pids):
    """``dnsblast`` with ``n`` UDP queries of the serve mix through
    ``port`` from ``SYSTEMD_BLAST_SOURCES`` addresses; its JSON line
    plus each process's busy share over the run."""
    import resource
    from binder_torch.dns import make_query
    path = os.path.join(tmp, "templates.bin")
    with open(path, "wb") as f:
        for name, qtype, _ in query_mix(rng, SYSTEMD_BLAST_TEMPLATES, hosts):
            wire = make_query(name, qtype, qid=0).encode()
            f.write(struct.pack(">H", len(wire)) + wire)
    cpu0 = {k: cpu_seconds(p) for k, p in pids.items()}
    child0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.monotonic()
    proc = subprocess.run(
        [binary, "-H", "127.0.0.1", "-p", str(port), "-n", str(n),
         "-w", str(SYSTEMD_BLAST_WINDOW), "-S", str(SYSTEMD_BLAST_SOURCES),
         "-t", path], capture_output=True, text=True,
        timeout=UDP_DEADLINE_S + 30)
    wall = time.monotonic() - t0
    child = resource.getrusage(resource.RUSAGE_CHILDREN)
    if proc.returncode != 0:
        raise PhaseError(f"systemd: dnsblast exited {proc.returncode}: "
                         f"{proc.stderr.strip()}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    out["queries"] = n          # it exits 0 only once all are answered
    busy = {k: (cpu_seconds(p) - cpu0[k]) / wall for k, p in pids.items()}
    busy["dnsblast"] = (child.ru_utime + child.ru_stime - child0.ru_utime
                        - child0.ru_stime) / wall
    out["busy"] = busy
    log(f"systemd: dnsblast: {json.dumps(out)}")
    return out


# -- phase 8: chaos ---------------------------------------------------

CHAOS_SHARDS = 4
#: every supervisor-side action of the chaos DSL (binder_torch/chaos/
#: plan.py), on the clock the supervisor starts once its group serves.
#: The skew goes first so the storm's deltas carry it to the digest
#: check; the respawn and the roll each get time to take a snapshot of
#: the zone; the session loss is held past the staleness cap before
#: the restore, so both the stale and the exhausted window show.
CHAOS_PLAN = ("at 3 skew-replica shard=1; at 3.5 watch-storm n=600; "
              "at 5 tcp-slow-reader conns=2 queries=512; "
              "at 5.5 tcp-half-close queries=3; at 6 tcp-rst conns=2; "
              "at 6.5 rrl-flood n=400; at 7 shard-kill shard=0; "
              "at 12 worker-roll shard=2; at 20 lose-session; "
              "at 21 loop-stall ms=120; at 26 restore-session")
CHAOS_MAX_STALE_S = 3.0
CHAOS_TTL_CLAMP_S = 5
#: a worker learns of the owner's session loss from its next session
#: frame (every 0.5 s), and a reply is judged when it arrives: the cap
#: and the clamp are held from this long after the injection
CHAOS_SLACK_S = 1.0
#: the stream runs on this long after the last action
CHAOS_AFTER_S = 3.0
#: the measurement client's /24 is allowlisted; the spoofed flood's
#: prefixes (127.66/16, 127.99/16) meet a low limit
CHAOS_RRL = {"responsesPerSecond": 20, "burst": 40,
             "allowlist": ["127.0.0.0/24"]}
CHAOS_SAMPLE = 2048
CHAOS_DEADLINE_S = 120.0
#: the watch-storm's last write to each ``chaos<k>`` name (main.py's
#: mutator writes 10.254.<i % 8>.<i % 250 + 1> for i in range(n))
CHAOS_NAMES = {f"chaos{k}.{DOMAIN}": f"10.254.{k}.{(592 + k) % 250 + 1}"
               for k in range(8)}


#: each worker's own response-rate limiter counters
#: (``binder_torch/server.py``), read on the worker's metrics port
RRL_FAMILIES = {"responses": "binder_rrl_responses_total",
                "dropped": "binder_rrl_dropped_total",
                "slipped": "binder_rrl_slipped_total",
                "allowlisted": "binder_rrl_allowlisted_total",
                "buckets": "binder_rrl_buckets"}
#: the chaos leg reads every worker's limiter once a second, and this
#: often from half a second before the flood to a second after the
#: kill, so that the killed worker's last reading follows its share of
#: the flood (its 1 Hz stats frame may not)
RRL_WATCH_FAST_S = 0.05


def rrl_reading(mport: int):
    """Per shard of a group: its pid, the age of its last stats frame
    at the supervisor, and its own limiter counters (left out when its
    metrics port does not answer)."""
    out = {}
    for w in json.loads(metrics_text(mport, "/status"))["shards"]["workers"]:
        entry = {"pid": w["pid"], "report_age": w["last_report_age_seconds"]}
        if w["alive"] and w["metrics_port"]:
            try:
                text = metrics_text(w["metrics_port"])
            except OSError:
                text = None
            if text is not None:
                got = exposition_sums(text, RRL_FAMILIES.values())
                entry.update({k: got[f] for k, f in RRL_FAMILIES.items()})
        out[w["shard"]] = entry
    return out


def rrl_incarnations(points):
    """The last counters read of each worker process (shard, pid) in a
    series of :func:`rrl_reading`, with the unix time of that reading;
    and per shard the unix times of the stats frames the supervisor
    had from each of its processes."""
    last, frames = {}, {}
    for t, reading in points:
        for shard, w in reading.items():
            key = (shard, w["pid"])
            if "dropped" in w:
                last[key] = dict({k: w[k] for k in RRL_FAMILIES},
                                 shard=shard, pid=w["pid"], read_at=t)
            if w["report_age"] is not None:
                frames.setdefault(key, set()).add(
                    round(t - w["report_age"], 2))
    return ([last[k] for k in sorted(last)],
            {k: sorted(v) for k, v in frames.items()})


def rrl_flood_gate(incarnations):
    """The chaos leg's ``rrl-flood`` gate on each worker process's last
    reading of its own limiter (:func:`rrl_incarnations`; a worker
    killed before its next stats frame counts what it limited all the
    same).  It holds what the reference's does
    (``tools/chaos_smoke.py``): the spoofed burst was rate-limited,
    dropped or slipped (with ``slipRatio`` 2 every second limited
    response slips), and the allowlisted measurement client bypassed
    the limiter; and that the limiting happened on the workers the
    flood reached: those tracking a flood prefix (the measurement
    client's prefix never makes a bucket).  Returns the summary and
    the errors."""
    rows = [dict(w, limited=w["dropped"] + w["slipped"],
                 judged=w["responses"] + w["dropped"] + w["slipped"])
            for w in incarnations]
    summary = {k: sum(w[k] for w in rows) for k in (
        "limited", "dropped", "slipped", "judged", "allowlisted")}
    summary["received_by"] = [[w["shard"], w["pid"]] for w in rows
                              if w["buckets"] > 0]
    summary["limited_by"] = [[w["shard"], w["pid"]] for w in rows
                             if w["limited"] > 0]
    summary["workers"] = rows
    errors = []
    if summary["limited"] <= 0:
        errors.append("rrl-flood: never rate-limited (dropped + slipped "
                      "0 on every worker process)")
    if summary["allowlisted"] <= 0:
        errors.append("rrl-flood: the allowlisted measurement prefix "
                      "never bypassed the limiter")
    stray = [x for x in summary["limited_by"]
             if x not in summary["received_by"]]
    if stray:
        errors.append(f"rrl-flood: limited on worker(s) {stray} that "
                      "track no flood prefix")
    return summary, errors


def log_events(log_path: str):
    """``(unix time, message)`` of every JSON line of a process log."""
    from datetime import datetime, timezone
    out = []
    for line in read_bytes(log_path).decode(errors="replace").splitlines():
        if not line.startswith("{"):
            continue
        try:
            rec = json.loads(line)
            t = datetime.strptime(rec["time"], "%Y-%m-%dT%H:%M:%S.%fZ")
        except (ValueError, KeyError):
            continue
        out.append((t.replace(tzinfo=timezone.utc).timestamp(),
                    str(rec.get("msg", ""))))
    return out


def chaos_judge(seen):
    """Check one reply of the chaos stream and note when it came:
    right data, or a refusal (SERVFAIL, REFUSED)."""
    from binder_torch.dns import Rcode

    def check(msg, expect) -> str:
        t = time.time()
        if msg.rcode == Rcode.NOERROR:
            seen.append((t, 0, min((r.ttl for r in msg.answers),
                                   default=None)))
            return check_reply(msg, expect)
        if msg.rcode in (Rcode.SERVFAIL, Rcode.REFUSED):
            seen.append((t, msg.rcode, None))
            return ""
        return f"rcode {msg.rcode}"
    return check


def stale_windows(seen, t_lose: float, t_restore: float):
    """Replies by window of the session loss: data while stale (TTL
    clamped), refusals past the cap, and the violations: data served
    past the cap, or unclamped after the loss."""
    cap_end = t_lose + CHAOS_MAX_STALE_S + CHAOS_SLACK_S
    out = {"stale_answers": 0, "refusals_past_cap": 0,
           "data_past_cap": 0, "unclamped_while_stale": 0,
           "violations_s_after_loss": None}
    bad = []
    for t, rcode, ttl in seen:
        if not t_lose + CHAOS_SLACK_S < t < t_restore:
            continue
        if rcode == 0:
            if t > cap_end:
                out["data_past_cap"] += 1
                bad.append(t - t_lose)
            elif ttl is not None and ttl > CHAOS_TTL_CLAMP_S:
                out["unclamped_while_stale"] += 1
                bad.append(t - t_lose)
            else:
                out["stale_answers"] += 1
        elif t > cap_end:
            out["refusals_past_cap"] += 1
    if bad:
        out["violations_s_after_loss"] = [min(bad), max(bad)]
    return out


class LogWatch:
    """True once ``pattern`` is in the log and ``after_s`` more have
    passed; reads the log at most every quarter second."""

    def __init__(self, log_path: str, pattern: bytes, after_s: float):
        self.log_path, self.pattern, self.after_s = log_path, pattern, after_s
        self.seen_at = None
        self.read_at = 0.0

    def __call__(self) -> bool:
        now = time.monotonic()
        if self.seen_at is None and now - self.read_at > 0.25:
            self.read_at = now
            if self.pattern in read_bytes(self.log_path):
                self.seen_at = now
        return self.seen_at is not None and now - self.seen_at > self.after_s


def chaos_group_leg(hosts: int = HOSTS, shards: int = CHAOS_SHARDS):
    """Leg (a): a ``shards``-worker group over the fake store with the
    chaos plan, under the 16-socket stream; returns its report."""
    from binder_torch.chaos import FaultPlan
    rng = random.Random(SEED + 4)
    timeline = FaultPlan.parse(CHAOS_PLAN).timeline
    scheduled = [a for _, a, _ in timeline]
    at = {a: t for t, a, _ in timeline}
    kill_shard = next(int(kw["shard"]) for _, a, kw in timeline
                      if a == "shard-kill")
    procs = []
    report = {"zone_names": hosts, "shards": shards, "plan": CHAOS_PLAN}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as tmp:
        group_log = os.path.join(tmp, "group.log")
        try:
            config = write_config(
                tmp, hosts, shards=shards, logLevel="info", rrl=CHAOS_RRL,
                degradation={"maxStalenessSeconds": CHAOS_MAX_STALE_S,
                             "staleTtlClampSeconds": CHAOS_TTL_CLAMP_S},
                chaos={"plan": CHAOS_PLAN, "seed": SEED})
            t0 = time.monotonic()
            group = spawn(["-m", "binder_torch.main", "-f", config, "-p",
                           "0"], group_log)
            procs.append(group)
            wait_line(group, group_log, rb"chaos: FaultPlan armed",
                      "chaos: shard group", DEPLOY_BOOT_DEADLINE_S)
            armed = time.monotonic()
            report["boot_s"] = armed - t0
            text = read_bytes(group_log)
            port = int(re.search(rb"UDP DNS service started on "
                                 rb"[\d.]+:(\d+)", text).group(1))
            mport = int(re.search(rb"metrics server started on port "
                                  rb"(\d+)", text).group(1))
            first = http_json(mport, "/status")["shards"]["workers"]
            seen = []
            queries = query_mix(rng, 1 << 16, hosts)
            window = (armed + at["rrl-flood"] - 0.5,
                      armed + at["shard-kill"] + 1.0)
            t0 = time.monotonic()
            with Series(lambda: rrl_reading(mport), fast=RRL_WATCH_FAST_S,
                        fast_while=lambda: window[0] < time.monotonic()
                        < window[1]) as watch:
                lat, errors, retries = udp_flows(
                    port, queries, FLOWS, CONCURRENCY,
                    check=chaos_judge(seen),
                    stop=LogWatch(group_log,
                                  b"chaos: injected restore-session",
                                  CHAOS_AFTER_S))
            udp_s = time.monotonic() - t0
            report.update(udp_answered=len(lat), udp_retries=retries,
                          udp_qps=len(lat) / udp_s, stream_s=udp_s)
            events = log_events(group_log)
            injected = {}
            for t, msg in events:
                m = re.match(r"chaos: injected (\S+)", msg)
                if m:
                    injected.setdefault(m.group(1), []).append(t)
            report["injected"] = sorted(injected)
            missing = [a for a in scheduled if a not in injected]
            if missing:
                errors.append(f"not injected: {missing}")
            faults = [msg for _, msg in events if re.search(
                r"chaos.*(skipped|has no hook|found no target state|"
                r"failed)", msg)]
            if faults:
                errors.append(f"chaos warnings: {faults[:5]}")
            if "lose-session" in injected and \
                    "restore-session" in injected:
                report["stale"] = stale_windows(
                    seen, injected["lose-session"][0],
                    injected["restore-session"][0])
                w = report["stale"]
                if w["data_past_cap"] or w["unclamped_while_stale"]:
                    errors.append(f"stale past the cap or unclamped: {w}")
                if not w["stale_answers"] or not w["refusals_past_cap"]:
                    errors.append(f"a degraded window did not show: {w}")
            report["replies"] = {
                "data": sum(1 for x in seen if x[1] == 0),
                "refused": sum(1 for x in seen if x[1] != 0)}

            # the roll finished; the respawned and rolled workers are
            # the port's
            deadline = time.monotonic() + CHAOS_DEADLINE_S
            while True:
                snap = http_json(mport, "/status")["shards"]
                if snap["rolls_total"] >= 1 and \
                        snap["rolling_shard"] is None and \
                        snap["up"] == shards:
                    break
                if time.monotonic() > deadline:
                    raise PhaseError(
                        f"chaos: group did not settle: up {snap['up']}, "
                        f"rolls {snap['rolls_total']}, rolling "
                        f"{snap['rolling_shard']}")
                time.sleep(0.2)
            report.update({k: snap[k] for k in (
                "respawns_total", "rolls_total", "roll_aborts",
                "digest_checks", "digest_violations")})
            if snap["respawns_total"] < 1 or snap["roll_aborts"]:
                errors.append(f"respawns {snap['respawns_total']}, "
                              f"roll aborts {snap['roll_aborts']}")
            if snap["digest_violations"] < 1:
                errors.append("the replica skew was not caught")
            report["workers"] = []
            for old, new in zip(first, snap["workers"]):
                line = cmdline(new["pid"])
                report["workers"].append({"shard": new["shard"],
                                          "pid": [old["pid"], new["pid"]],
                                          "respawns": new["respawns"],
                                          "rolls": new["rolls"]})
                if "-m binder_torch.main" not in line or \
                        "binder_tpu" in line:
                    errors.append(f"worker {new['pid']} runs {line!r}")
            for shard in (0, 2):
                if snap["workers"][shard]["pid"] == first[shard]["pid"]:
                    errors.append(f"shard {shard} kept pid "
                                  f"{first[shard]['pid']}")
            # the flood against each worker process's own limiter, the
            # killed one's as last read before the kill
            incarnations, frames = rrl_incarnations(watch.points)
            flood, rrl_errors = rrl_flood_gate(incarnations)
            errors += rrl_errors
            report["rrl_flood"] = flood
            t_flood = injected.get("rrl-flood", [0.0])[0]
            t_kill = injected.get("shard-kill", [0.0])[0]
            flood["kill_s_after_flood"] = t_kill - t_flood
            for w in flood["workers"]:
                w["read_s_after_flood"] = w.pop("read_at") - t_flood
            victim = (kill_shard, first[kill_shard]["pid"])
            flood["killed_frames_s_after_flood"] = [
                round(t - t_flood, 2) for t in frames.get(victim, ())
                if t > t_flood - 2.0]
            # what the supervisor folded from the stats frames, for the
            # record: a worker killed before its next frame is missing
            flood["supervisor_folded_dropped"] = shard_series(
                mport, "binder_shard_rrl_dropped")

            # after the restore every sampled name answers right again
            t0 = time.monotonic()
            zone_sweep(port, hosts, t0 + CHAOS_DEADLINE_S,
                       indices=rng.sample(range(hosts),
                                          min(CHAOS_SAMPLE, hosts)),
                       what="chaos")
            for name, addr in CHAOS_NAMES.items():
                while a_addrs(fresh_ask(port, name, 7)) != [addr]:
                    if time.monotonic() - t0 > CHAOS_DEADLINE_S:
                        raise PhaseError(f"chaos: {name} not {addr}")
                    time.sleep(0.1)
            report["recovered_s"] = time.monotonic() - t0
            report["c_lane"] = [native_reading(w["metrics_port"])
                                for w in snap["workers"]]

            live = [w["pid"] for w in snap["workers"]]
            group.send_signal(signal.SIGTERM)
            try:
                report["drain_rc"] = group.wait(timeout=DRAIN_DEADLINE_S)
            except subprocess.TimeoutExpired:
                raise PhaseError("chaos: supervisor did not drain")
            if report["drain_rc"] != 0:
                errors.append(f"supervisor exited {report['drain_rc']}")
            deadline = time.monotonic() + 10
            while any(os.path.exists(f"/proc/{p}") for p in live):
                if time.monotonic() > deadline:
                    errors.append(f"workers {live} outlived the drain")
                    break
                time.sleep(0.05)
            report["errors"] = len(errors)
        except PhaseError:
            if os.path.exists(group_log):
                tail = read_bytes(group_log)[-4000:].decode(
                    errors="replace")
                log(f"--- group.log (last 4000 bytes) ---\n{tail}")
            raise
        finally:
            for proc in reversed(procs):
                reap(proc)
        left = descendants(os.getpid())
        report["left_after_drain"] = left
    log(json.dumps({"chaos_group": report}))
    check_phase("chaos", errors, left)
    return report


CHAOS_UPSTREAM_S = 10.0


async def chaos_upstream_run(duration: float):
    """Leg (b), in process: a server with recursion to a remote DC
    through a ``ChaosUpstream`` (loss, then dead, then clear) while the
    store's session is lost and restored; the invariants of the
    degradation policy under continuous queries."""
    from binder_torch.chaos import ChaosDriver, ChaosUpstream, FaultPlan
    from binder_torch.dns import Message, Rcode, Type, make_query
    from binder_torch.introspect import FlightRecorder
    from binder_torch.metrics.collector import MetricsCollector
    from binder_torch.recursion import Recursion, StaticResolverSource
    from binder_torch.recursion.client import DnsClient
    from binder_torch.server import BinderServer
    from binder_torch.store import FakeStore, MirrorCache
    domain = "chaos.test"
    collector = MetricsCollector()
    recorder = FlightRecorder(capacity=1024)
    store = FakeStore(recorder=recorder)
    cache = MirrorCache(store, domain, collector=collector,
                        recorder=recorder)
    for i in range(8):
        store.put_json(f"/test/chaos/w{i}",
                       {"type": "host",
                        "host": {"address": f"10.0.2.{i + 1}"}})
    store.start_session()
    up_plan = FaultPlan(seed=11)
    upstream = ChaosUpstream(up_plan,
                             hosts={f"w.remote.{domain}": "10.9.9.9"})
    up_port = await upstream.start()
    recursion = Recursion(
        zk_cache=cache, dns_domain=domain, datacenter_name="dc0",
        source=StaticResolverSource({"remote": [f"127.0.0.1:{up_port}"]}),
        nic_provider=lambda: [], client=DnsClient(timeout=0.25),
        collector=collector, recorder=recorder)
    await recursion.wait_ready()
    max_staleness = max(0.6, duration * 0.08)
    clamp = 5
    server = BinderServer(
        zk_cache=cache, dns_domain=domain, datacenter_name="dc0",
        host="127.0.0.1", port=0, collector=collector, query_log=False,
        flight_recorder=recorder, recursion=recursion,
        degradation={"maxStalenessSeconds": max_staleness,
                     "staleTtlClampSeconds": clamp},
        admission={"maxInflight": 128})
    await server.start()
    plan = FaultPlan(seed=7) \
        .at(duration * 0.10, "upstream", loss=0.4) \
        .at(duration * 0.20, "lose-session") \
        .at(duration * 0.25, "watch-storm", n=100) \
        .at(duration * 0.35, "upstream", dead=1) \
        .at(duration * 0.45, "loop-stall", ms=120) \
        .at(duration * 0.65, "restore-session") \
        .at(duration * 0.70, "upstream", clear=True)
    plan.upstream = up_plan.upstream    # faults act on the live upstream

    def mutate(i):
        store.put_json(f"/test/chaos/churn{i % 4}",
                       {"type": "host",
                        "host": {"address": f"10.7.0.{i % 200 + 1}"}})

    driver = ChaosDriver(plan, store=store, mutate=mutate,
                         recorder=recorder)
    chaos_task = driver.start()
    loop = asyncio.get_running_loop()

    async def ask(name, qid, rd, timeout=1.0):
        fut = loop.create_future()

        class Proto(asyncio.DatagramProtocol):
            def connection_made(self, transport):
                transport.sendto(make_query(name, Type.A, qid=qid,
                                            rd=rd).encode())

            def datagram_received(self, data, addr):
                if not fut.done():
                    fut.set_result(data)

        transport, _ = await loop.create_datagram_endpoint(
            Proto, remote_addr=("127.0.0.1", server.udp_port))
        try:
            return Message.decode(await asyncio.wait_for(fut, timeout))
        finally:
            transport.close()

    pol = server._policy
    stats = {"queries": 0, "ok": 0, "stale": 0, "refused": 0,
             "servfail": 0, "rd_timeouts": 0,
             "asked_across_a_transition": 0, "transitions": 0,
             "c_lane": server._fastpath is not None}

    def count_transition(old, new):
        stats["transitions"] += 1

    pol.on_transition(count_transition)
    violations = []
    t_end = loop.time() + duration
    i = 0
    try:
        while loop.time() < t_end:
            i += 1
            rd = i % 5 == 0
            name = f"w.remote.{domain}" if rd else f"w{i % 8}.{domain}"
            stats["queries"] += 1
            # the state at the ask and at the answer: an answer may be
            # rendered on either side of a transition between the two
            # (the restore landing while the ask is in flight), and is
            # held to the rule of one of the two states
            mode = pol.mode()
            try:
                msg = await ask(name, (i % 0xFFFF) + 1, rd)
            except asyncio.TimeoutError:
                if not rd:
                    violations.append(f"local query for {name} hung")
                stats["rd_timeouts"] += 1
                continue
            modes = {mode, pol.mode()}
            if len(modes) > 1:
                stats["asked_across_a_transition"] += 1
            if msg.rcode == Rcode.NOERROR and msg.answers:
                ds = store.disconnected_seconds()
                clamped = all(a.ttl <= clamp for a in msg.answers)
                if not rd and "fresh" not in modes:
                    if "stale-serving" not in modes:
                        violations.append("data served while "
                                          "stale-exhausted")
                    elif not clamped:
                        violations.append("stale answer TTL not clamped")
                if ds is not None and not rd \
                        and ds > max_staleness + CHAOS_SLACK_S:
                    violations.append(f"answer {ds:.2f}s stale")
                if modes == {"stale-serving"} and not rd:
                    stats["stale"] += 1
                stats["ok"] += 1
            elif msg.rcode == Rcode.REFUSED:
                stats["refused"] += 1
            elif msg.rcode == Rcode.SERVFAIL:
                stats["servfail"] += 1
            else:
                violations.append(f"unexpected rcode {msg.rcode}")
            await asyncio.sleep(duration / 600.0)
        await asyncio.wait_for(chaos_task, duration)
        # one query at a time: each crossing spans its own transition
        if stats["asked_across_a_transition"] > stats["transitions"]:
            violations.append(f"{stats['asked_across_a_transition']} "
                              f"answers crossed {stats['transitions']} "
                              "transitions")
        if not stats["stale"]:
            violations.append("stale-serving window never observed")
        if not stats["servfail"]:
            violations.append("stale-exhausted window never observed")
        # re-convergence: the mirror advances, the policy is fresh,
        # the dead peer's breaker closes once it answers again
        gen_before = cache.gen
        store.put_json("/test/chaos/w0",
                       {"type": "host", "host": {"address": "10.0.2.99"}})
        if cache.gen <= gen_before:
            violations.append("mirror generation did not advance")
        deadline = loop.time() + 10.0
        while loop.time() < deadline and (
                pol.mode() != "fresh"
                or recursion.breakers.open_count()):
            try:
                await ask(f"w.remote.{domain}", 9000, True)
            except asyncio.TimeoutError:
                pass
            await asyncio.sleep(0.1)
        stats["degraded_state"] = collector.get(
            "binder_degraded_state").value()
        stats["breakers_open"] = recursion.breakers.open_count()
        if pol.mode() != "fresh" or stats["degraded_state"] != 0.0:
            violations.append("degraded state did not return to fresh")
        if stats["breakers_open"]:
            violations.append("breakers still open after recovery")
        msg = await ask(f"w0.{domain}", 9999, False)
        if msg.rcode != Rcode.NOERROR or \
                [a.address for a in msg.answers] != ["10.0.2.99"]:
            violations.append("post-recovery answer wrong")
        stats["upstream"] = upstream.stats()
        stats["flight_events"] = dict(recorder.by_type)
        stats["violations"] = violations
        return stats
    finally:
        await server.stop()
        await recursion.close()
        await upstream.stop()


def chaos_phase(hosts: int = HOSTS, shards: int = CHAOS_SHARDS,
                upstream_s: float = CHAOS_UPSTREAM_S, native=None):
    report = chaos_group_leg(hosts, shards)
    if native is not None:
        native["chaos"] = report["c_lane"]
    stats = asyncio.run(chaos_upstream_run(upstream_s))
    log(json.dumps({"chaos_upstream": stats}))
    if stats["violations"] or not stats["c_lane"]:
        raise PhaseError(f"chaos (upstream): {stats['violations'][:5]}, "
                         f"C lane {stats['c_lane']}")


# -- phase 9: hostile -------------------------------------------------

#: ``tools/hostile_smoke.py``'s settings, at ``make ci``'s trim
#: (``BINDER_HOSTILE_SECONDS=10``): the RRL limit, the paced legit
#: probe under it, the flood's flows and pacing, and the floors
HOSTILE_SECONDS = 10.0
HOSTILE_LEGIT_QPS = 100
HOSTILE_RRL = {"responsesPerSecond": 150, "burst": 300, "slipRatio": 2,
               "maxBuckets": 512}
HOSTILE_FLOOD_QPS = 6000
HOSTILE_FLOWS = 64
HOSTILE_MAX_RSS_GROWTH_KB = 64 * 1024
HOSTILE_GOODPUT_FLOOR = 0.5
#: the scale departure from the reference smokes, printed by both phases
NAMES_DEPARTURE = ("names: the zone's {n} host names, where the "
                   "reference smokes ask 8 (hostile) or 16 (population)")
SETTLE_DEADLINE_S = 300.0
SETTLE_EVERY_S = 1.0


def rss_kb(pid: int):
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return None


def series_value(text: str, family: str, label: str) -> float:
    """The sum of the series of ``family`` whose labels hold ``label``
    (for example ``reason="response-ratelimit"``)."""
    total = 0.0
    for line in text.splitlines():
        if line.split("{", 1)[0] == family and label in line:
            total += float(line.rsplit(" ", 1)[1])
    return total


def settle_zone(mport: int, what: str) -> dict:
    """Wait until the zone fill has settled (``binder_zone_entries`` the
    same two readings in a row), so that a control measured now and a
    stream measured later read one server state."""
    t0 = time.monotonic()
    last = None
    while True:
        entries = metric_sum(http_json(mport, "/metrics"),
                             "binder_zone_entries")
        if entries > 0 and entries == last:
            return {"zone_entries": entries,
                    "settle_s": time.monotonic() - t0}
        if time.monotonic() - t0 > SETTLE_DEADLINE_S:
            raise PhaseError(f"{what}: the zone fill did not settle in "
                             f"{SETTLE_DEADLINE_S:.0f}s ({entries} "
                             "entries)")
        last = entries
        time.sleep(SETTLE_EVERY_S)


def zone_names(hosts: int, seed: int):
    """Every host name of the zone, in a seeded order."""
    racks = max(1, min(1024, hosts // 512))
    names = [host_name(i, racks) for i in range(hosts)]
    random.Random(seed).shuffle(names)
    return names


def rrl_readings(text: str) -> dict:
    return {name: metric_sum(text, f"binder_rrl_{name}")
            for name in ("responses_total", "slipped_total",
                         "dropped_total", "buckets", "allowlisted_total",
                         "adaptations_total", "adapted_buckets",
                         "false_positives_total")}


def hostile_phase(hosts: int = HOSTS, duration: float = HOSTILE_SECONDS,
                  native=None):
    """Port of ``tools/hostile_smoke.py`` at the serve phase's zone: a
    paced legit control, then the adversarial flood in its own process
    with the same probe under it; returns the report."""
    from binder_torch.loadgen.hostile import legit_probe
    from tools.lint import validate_rrl_metrics, validate_status_snapshot
    t_phase = time.monotonic()
    names = zone_names(hosts, SEED + 5)
    report = {"zone_names": hosts, "duration_s": duration,
              "departure": NAMES_DEPARTURE.format(n=hosts)}
    errors = []
    proc = flood = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hostile_") as tmp:
        log_path = os.path.join(tmp, "server.log")
        try:
            t0 = time.monotonic()
            proc, port = boot_server(
                write_config(tmp, hosts, rrl=HOSTILE_RRL), log_path,
                "hostile: server")
            report["boot_s"] = time.monotonic() - t0
            mport = metrics_port(log_path)
            report.update(settle_zone(mport, "hostile"))
            names_path = os.path.join(tmp, "names.txt")
            with open(names_path, "w") as f:
                f.write("\n".join(names) + "\n")
            before = native_reading(mport)

            # 1. the no-flood control, paced under the per-prefix limit
            control = legit_probe("127.0.0.1", port,
                                  duration=max(2.0, duration * 0.1),
                                  names=names, domain=DOMAIN,
                                  qps=HOSTILE_LEGIT_QPS)
            report["control"] = control
            if not control["answered"]:
                raise PhaseError(f"hostile: the control got no answers "
                                 f"({control})")
            # the zone at 100k names is most of the footprint: growth
            # counts from here
            rss_before = rss_kb(proc.pid)

            # 2. the flood in its own process, the same probe under it
            out_path = os.path.join(tmp, "flood.json")
            err_path = os.path.join(tmp, "flood.err")
            with open(out_path, "wb") as out, open(err_path, "wb") as err:
                flood = subprocess.Popen(
                    [sys.executable, "-m", "binder_torch.loadgen.hostile",
                     "--port", str(port), "--duration", str(duration),
                     "--flows", str(HOSTILE_FLOWS),
                     "--qps", str(HOSTILE_FLOOD_QPS), "--domain", DOMAIN,
                     "--names-file", names_path],
                    cwd=ROOT, stdout=out, stderr=err)
            time.sleep(0.5)     # let the flood trip the limiter first
            under = legit_probe("127.0.0.1", port,
                                duration=max(1.0, duration - 1.5),
                                names=names, domain=DOMAIN,
                                qps=HOSTILE_LEGIT_QPS)
            report["under_flood"] = under
            try:
                rc = flood.wait(timeout=duration + 30)
            except subprocess.TimeoutExpired:
                raise PhaseError("hostile: the flood did not end")
            if rc != 0:
                raise PhaseError(
                    f"hostile: the flood exited {rc}: "
                    + read_bytes(err_path)[-600:].decode(errors="replace"))
            flood_report = json.loads(read_bytes(out_path))
            report["flood"] = {k: flood_report[k] for k in (
                "duration_s", "flows", "hostile_qps", "sent", "mix")}
            report["categories"] = flood_report["categories"]
            if proc.poll() is not None:
                raise PhaseError(f"hostile: the server exited "
                                 f"{proc.returncode} under the flood")
            rss_after = rss_kb(proc.pid)
            report["rss_kb"] = [rss_before, rss_after]
            report["rss_growth_kb"] = rss_after - rss_before

            # 3. RRL engaged: the spoof prefixes were slipped and dropped
            spoof = flood_report["categories"]["spoof"]
            if not (spoof["slipped"] or spoof["dropped"]):
                errors.append(f"spoof flood never rate-limited ({spoof})")
            if not spoof["slipped"]:
                errors.append(f"no TC=1 slips seen (slipRatio 2): {spoof}")
            # 4. malformed frames: FORMERR or no reply, never an answer
            # (the reference's allowance for a reply attributed to the
            # wrong category of a flow that shares query IDs)
            bad = flood_report["categories"]["malformed"]
            if bad["sent"] and bad["answered"] > 0.02 * bad["sent"] + 3:
                errors.append(f"malformed frames got answers ({bad})")
            # 5. goodput under the flood against the control
            ratio = under["qps"] / control["qps"]
            report["goodput_ratio"] = ratio
            if ratio < HOSTILE_GOODPUT_FLOOR:
                errors.append(f"goodput under the flood {under['qps']} "
                              f"qps, control {control['qps']}: ratio "
                              f"{ratio} < {HOSTILE_GOODPUT_FLOOR}")
            # 6. bounded state
            if report["rss_growth_kb"] > HOSTILE_MAX_RSS_GROWTH_KB:
                errors.append(f"RSS grew {report['rss_growth_kb']} kB "
                              f"(cap {HOSTILE_MAX_RSS_GROWTH_KB})")
            text = http_json(mport, "/metrics")
            report["rrl"] = rrl_readings(text)
            report["shed_response_ratelimit"] = series_value(
                text, "binder_shed_total", 'reason="response-ratelimit"')
            if report["rrl"]["buckets"] > HOSTILE_RRL["maxBuckets"]:
                errors.append(f"binder_rrl_buckets "
                              f"{report['rrl']['buckets']} > maxBuckets")
            # 7. observability
            errors += [f"rrl metrics: {e}"
                       for e in validate_rrl_metrics(text)[:3]]
            if report["rrl"]["dropped_total"] <= 0:
                errors.append("binder_rrl_dropped_total never moved")
            if report["shed_response_ratelimit"] <= 0:
                errors.append('binder_shed_total{reason="response-'
                              'ratelimit"} never moved')
            status = http_json(mport, "/status")
            errors += [f"status: {e}"
                       for e in validate_status_snapshot(status)[:3]]
            rrl_status = (status.get("policy") or {}).get("rrl")
            if not rrl_status or not rrl_status.get("dropped"):
                errors.append(f"/status policy.rrl missing or idle "
                              f"({rrl_status})")
            # 8. the C lane stayed resident and served
            after = native_reading(mport)
            report["c_lane"] = native_delta(before, after)
            errors += native_gate("hostile", before, after)
            # 9. the server answers normally after the flood
            report["after"] = legit_probe("127.0.0.1", port, duration=1.0,
                                          names=names, domain=DOMAIN,
                                          qps=50)
            if not report["after"]["answered"]:
                errors.append("server unhealthy after the flood")
        except PhaseError:
            if os.path.exists(log_path):
                tail = read_bytes(log_path)[-3000:].decode(errors="replace")
                log(f"--- hostile server.log (last 3000 bytes) ---\n{tail}")
            raise
        finally:
            reap(flood)
            reap(proc)
    left = descendants(os.getpid())
    report["phase_s"] = time.monotonic() - t_phase
    report["errors"] = len(errors)
    log(json.dumps({"hostile": report}))
    if native is not None:
        native["hostile"] = report["c_lane"]
    check_phase("hostile", errors, left)
    return report


# -- phase 10: population ---------------------------------------------

#: ``tools/population_smoke.py``'s settings: the RRL limit (leg A with
#: the direct cohort's /16 allowlisted, leg B with the probe's /24),
#: the floors, and ``make ci``'s 10 s stream (``Makefile:64``); leg A
#: runs ``run_population``'s own defaults
POP_RRL = {"responsesPerSecond": 60, "burst": 120, "slipRatio": 2,
           "maxBuckets": 512, "adaptive": True, "adaptEvidence": 3}
POP_SECONDS = 10.0
POP_GOODPUT_FLOOR = 0.5
POP_FP_CEILING = 0.10
ROLL_SHARDS = 2
#: leg B's chaos block at ``make ci``'s trim (flood at 15% and the
#: roll at 25% of its 6 s budget).  The reference's flood is n=400:
#: 100 packets to each of the 4 flood /24s, under their burst of 120
#: on an exact limiter, so its gate held only where a sampler charged
#: a burst more than its size (a whole sampled readiness event at 8
#: tokens a packet).  n=1600 sends 200 from each of the flood's 8
#: sockets: past the burst on either worker the socket hashes to.
ROLL_FLOOD = 1600
ROLL_PLAN = f"at 1.0 rrl-flood n={ROLL_FLOOD}; at 1.5 worker-roll"
ROLL_RETRY_TOLERANCE = 3
#: the probe runs until both rolls are done; at 100,000 names each
#: replacement catches up from a snapshot of the whole zone
ROLL_WAIT_S = 300.0
ROLL_PROBE_TIMEOUT_S = 1.5


def population_leg(hosts: int, duration: float) -> dict:
    """Leg A: ``run_population`` against one server with RRL v2."""
    from binder_torch.loadgen.population import run_population
    from tools.lint import validate_rrl_metrics, validate_status_snapshot
    names = zone_names(hosts, SEED + 6)
    report = {"zone_names": hosts, "duration_s": duration}
    errors = []
    proc = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pop_") as tmp:
        log_path = os.path.join(tmp, "server.log")
        try:
            t0 = time.monotonic()
            proc, port = boot_server(
                write_config(tmp, hosts, rrl=dict(
                    POP_RRL, allowlist=["127.10.0.0/16"])),
                log_path, "population: server")
            report["boot_s"] = time.monotonic() - t0
            mport = metrics_port(log_path)
            report.update(settle_zone(mport, "population"))
            before = native_reading(mport)
            pop = run_population("127.0.0.1", port, duration=duration,
                                 names=names, domain=DOMAIN)
            report.update({k: pop[k] for k in (
                "population", "offered", "cohorts", "identity_outcomes",
                "farm_goodput_ratio", "rrl_false_positive_rate",
                "ttl_observed")})
            if proc.poll() is not None:
                raise PhaseError(f"population: the server exited "
                                 f"{proc.returncode} under load")
            if pop["farm_goodput_ratio"] < POP_GOODPUT_FLOOR:
                errors.append(f"farm goodput {pop['farm_goodput_ratio']}"
                              f" < {POP_GOODPUT_FLOOR}")
            if pop["rrl_false_positive_rate"] > POP_FP_CEILING:
                errors.append(f"RRL false-positive rate "
                              f"{pop['rrl_false_positive_rate']} > "
                              f"{POP_FP_CEILING}")
            text = http_json(mport, "/metrics")
            report["rrl"] = rrl = rrl_readings(text)
            errors += [f"rrl metrics: {e}"
                       for e in validate_rrl_metrics(text)[:3]]
            if rrl["dropped_total"] <= 0:
                errors.append("the spoofed overlay was never dropped")
            if rrl["adaptations_total"] < 1:
                errors.append("adaptive buckets never engaged (no TCP "
                              f"retry evidence consumed): {rrl}")
            if rrl["allowlisted_total"] <= 0:
                errors.append("the allowlisted direct cohort was never "
                              "counted")
            status = http_json(mport, "/status")
            errors += [f"status: {e}"
                       for e in validate_status_snapshot(status)[:3]]
            report["status_rrl"] = (status.get("policy") or {}).get("rrl")
            after = native_reading(mport)
            report["c_lane"] = native_delta(before, after)
            errors += native_gate("population", before, after)
        except PhaseError:
            if os.path.exists(log_path):
                tail = read_bytes(log_path)[-3000:].decode(errors="replace")
                log(f"--- population server.log (last 3000 bytes) ---\n"
                    f"{tail}")
            raise
        finally:
            reap(proc)
    report["errors"] = errors
    return report


def roll_probe(port: int, name: str, qid: int) -> int:
    """One closed-loop query from the allowlisted probe address: the
    try it was answered NOERROR on (1 to 3), or 0 when none was."""
    from binder_torch.dns import Type, make_query
    wire = make_query(name, Type.A, qid=(qid % 65535) + 1).encode()
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        s.connect(("127.0.0.1", port))
        s.settimeout(ROLL_PROBE_TIMEOUT_S)
        for attempt in range(1, 4):
            s.send(wire)
            try:
                reply = s.recv(65535)
            except socket.timeout:
                continue
            if len(reply) >= 12 and (reply[3] & 0xF) == 0:
                return attempt
    return 0


def rolling_leg(hosts: int, duration: float = 6.0) -> dict:
    """Leg B: a 2-shard group under the chaos block's flood and
    ``worker-roll``, then SIGHUP, with a closed-loop probe throughout."""
    from tools.lint import validate_shard_metrics
    names = zone_names(hosts, SEED + 7)
    report = {"zone_names": hosts, "shards": ROLL_SHARDS,
              "plan": ROLL_PLAN,
              "departure": f"rrl-flood n={ROLL_FLOOD}, where the "
                           "reference smoke's n=400 leaves each flood "
                           "/24 under its burst"}
    errors = []
    group = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_roll_") as tmp:
        group_log = os.path.join(tmp, "group.log")
        try:
            config = write_config(
                tmp, hosts, shards=ROLL_SHARDS,
                rrl=dict(POP_RRL, allowlist=["127.0.0.0/24"]),
                chaos={"plan": ROLL_PLAN})
            t0 = time.monotonic()
            group = spawn(["-m", "binder_torch.main", "-f", config, "-p",
                           "0"], group_log)
            wait_line(group, group_log, rb"chaos: FaultPlan armed",
                      "population: shard group", DEPLOY_BOOT_DEADLINE_S)
            report["boot_s"] = time.monotonic() - t0
            text = read_bytes(group_log)
            port = int(re.search(rb"UDP DNS service started on "
                                 rb"[\d.]+:(\d+)", text).group(1))
            mport = int(re.search(rb"metrics server started on port "
                                  rb"(\d+)", text).group(1))
            pids0 = [w["pid"] for w in
                     http_json(mport, "/status")["shards"]["workers"]]
            if len(set(pids0)) != ROLL_SHARDS:
                raise PhaseError(f"population: expected {ROLL_SHARDS} "
                                 f"worker pids, got {pids0}")
            probe = {"queries": 0, "retried": 0, "lost": 0}
            pids1, lines1 = [], []
            sighup_at = None
            t0 = time.monotonic()
            deadline = t0 + ROLL_WAIT_S
            i = 0
            rolls = 0
            while time.monotonic() < deadline:
                i += 1
                tries = roll_probe(port, names[i % len(names)], i)
                probe["queries"] += 1
                if tries == 0:
                    probe["lost"] += 1
                elif tries > 1:
                    probe["retried"] += 1
                if i % 10 == 0:
                    rolls = http_json(mport, "/status")["shards"][
                        "rolls_total"]
                    if rolls >= ROLL_SHARDS and sighup_at is None:
                        # the chaos roll is done: the config-reload
                        # entry point rolls the same live group again
                        pids1 = [w["pid"] for w in http_json(
                            mport, "/status")["shards"]["workers"]]
                        lines1 = [cmdline(p) for p in pids1]
                        group.send_signal(signal.SIGHUP)
                        sighup_at = time.monotonic() - t0
                    elif rolls >= 2 * ROLL_SHARDS:
                        break
                time.sleep(max(0.005, duration / 400.0))
            report["rolls_s"] = time.monotonic() - t0
            report["sighup_at_s"] = sighup_at
            report["probe"] = probe
            snap = http_json(mport, "/status")["shards"]
            pids2 = [w["pid"] for w in snap["workers"]]
            report.update(rolls_total=snap["rolls_total"],
                          roll_aborts=snap["roll_aborts"],
                          pids={"boot": pids0, "after_chaos_roll": pids1,
                                "after_sighup_roll": pids2})
            if snap["rolls_total"] < 2 * ROLL_SHARDS:
                errors.append(f"{snap['rolls_total']} rolls in "
                              f"{ROLL_WAIT_S:.0f}s (want "
                              f"{2 * ROLL_SHARDS}: chaos and SIGHUP)")
            if snap["roll_aborts"]:
                errors.append(f"{snap['roll_aborts']} roll(s) aborted")
            if (not pids1 or set(pids1) & set(pids0)
                    or set(pids2) & set(pids1) or set(pids2) & set(pids0)):
                errors.append(f"worker pids survived a roll: {pids0} -> "
                              f"{pids1} -> {pids2}")
            for line in lines1 + [cmdline(p) for p in pids2]:
                if "-m binder_torch.main" not in line or \
                        "binder_tpu" in line:
                    errors.append(f"a new worker runs {line!r}")
            if probe["lost"]:
                errors.append(f"{probe['lost']} probe quer(ies) lost "
                              f"across {snap['rolls_total']} rolls")
            if probe["retried"] > ROLL_RETRY_TOLERANCE:
                errors.append(f"{probe['retried']} probe retries "
                              f"(tolerance {ROLL_RETRY_TOLERANCE})")
            text = read_bytes(group_log)
            report["quiesced_clean"] = quiesced = text.count(
                b"quiesced clean")
            if quiesced < 2 * ROLL_SHARDS:
                errors.append(f"{quiesced} clean quiesces logged (want "
                              f"{2 * ROLL_SHARDS})")
            first_done = text.find(b"shard 0 rolled: pid")
            second_spawn = text.find(b"shard 1 replacement spawned")
            if first_done == -1 or second_spawn < first_done:
                errors.append("rolls not sequential: shard 1's "
                              "replacement spawned before shard 0 was "
                              "promoted")
            metrics = http_json(mport, "/metrics")
            errors += [f"shard metrics: {e}"
                       for e in validate_shard_metrics(metrics)[:3]]
            report["shard_rolls"] = shard_series(
                mport, "binder_shard_rolls_total")
            report["shard_roll_aborts"] = metric_sum(
                metrics, "binder_shard_roll_aborts_total")
            if report["shard_rolls"] != {k: 2.0
                                         for k in range(ROLL_SHARDS)}:
                errors.append(f"binder_shard_rolls_total "
                              f"{report['shard_rolls']}, want 2 a shard")
            if report["shard_roll_aborts"]:
                errors.append(f"binder_shard_roll_aborts_total "
                              f"{report['shard_roll_aborts']}")
            report["rrl_dropped"] = metric_sum(metrics,
                                               "binder_shard_rrl_dropped")
            if report["rrl_dropped"] <= 0:
                errors.append("the rrl-flood never engaged the workers' "
                              "RRL")
            group.send_signal(signal.SIGTERM)
            try:
                report["drain_rc"] = group.wait(timeout=DRAIN_DEADLINE_S)
            except subprocess.TimeoutExpired:
                raise PhaseError("population: supervisor did not drain")
            if report["drain_rc"] != 0:
                errors.append(f"supervisor exited {report['drain_rc']}")
            deadline = time.monotonic() + 10
            while any(os.path.exists(f"/proc/{p}") for p in pids2):
                if time.monotonic() > deadline:
                    errors.append(f"workers {pids2} outlived the drain")
                    break
                time.sleep(0.05)
        except PhaseError:
            if os.path.exists(group_log):
                tail = read_bytes(group_log)[-4000:].decode(
                    errors="replace")
                log(f"--- population group.log (last 4000 bytes) ---\n"
                    f"{tail}")
            raise
        finally:
            reap(group)
    report["errors"] = errors
    return report


def population_phase(hosts: int = HOSTS, duration: float = POP_SECONDS,
                     native=None):
    """Port of ``tools/population_smoke.py`` at the serve phase's zone:
    leg A, the population against RRL v2; leg B, rolls under a flood."""
    t_phase = time.monotonic()
    a = population_leg(hosts, duration)
    b = rolling_leg(hosts)
    left = descendants(os.getpid())
    errors = [f"leg A: {e}" for e in a.pop("errors")] + \
        [f"leg B: {e}" for e in b.pop("errors")]
    log(json.dumps({"population": {
        "departure": NAMES_DEPARTURE.format(n=hosts), "leg_a": a,
        "leg_b": b, "phase_s": time.monotonic() - t_phase,
        "errors": len(errors)}}))
    if native is not None:
        native["population"] = a["c_lane"]
    check_phase("population", errors, left)
    return a, b


# -- phase 11: federation ---------------------------------------------

#: ``tools/federation_smoke.py``'s settings at ``make ci``'s trim
#: (``BINDER_FEDERATION_SECONDS=10``, ``Makefile:59``): the stream, the
#: TTL clamp on stale answers, the west group's size, the incident at
#: 55% of the stream, the client's deadline and the latency and
#: failover bounds (``federation_smoke.py:150-300``)
FED_SECONDS = 10.0
FED_TTL_CLAMP_S = 15
FED_WEST_PEERS = 2
FED_DARK_AT = 0.55
FED_CLIENT_TIMEOUT_S = 2.5
FED_LOCAL_P99_S = 0.25
FED_FIRST_STALE_S = 5.0
#: the foreign names the stream asks: each once before dark, within the
#: shipped foreign-answer cache (``cacheSize`` 4,096), so none is evicted
FED_WORKING_SET = 2_000
FED_PARITY_SAMPLE = 256
FED_SWEEP_THREADS = 16
FED_REGION = "home"
FED_UFDS_DEADLINE_S = 60.0
#: the reference smoke builds its binders without admission control;
#: the production default holds one client to 50 forwards a second,
#: which the working set's first pass from one address would trip
FED_ADMISSION = {"recursionRate": 1000000, "recursionBurst": 1000000}
FED_DEPARTURES = (
    "names: {hosts} synthetic hosts a datacenter, where the reference "
    "smoke serves 8",
    "processes: every binder is its own python -m binder_torch.main, "
    "where the reference smoke runs all of them in one process; west's "
    "two each hold their own mirror of one zone",
    "admission: recursionRate and recursionBurst lifted (the reference "
    "smoke's servers have no admission control)",
    "working set: {working} foreign names, each asked once before the "
    "stream and all of them again after it",
    "ufds: ldaps://ufds.foo.com:<port>, the LDAP test server's "
    "ephemeral port in place of 636")
#: the UFDS service east resolves ``ufds.foo.com`` through (its mirror)
UFDS_FIXTURE = {
    "/com/foo/ufds": {"type": "service",
                      "service": {"srvce": "_ldap", "proto": "_tcp",
                                  "port": 636}},
    "/com/foo/ufds/lb0": {"type": "load_balancer",
                          "load_balancer": {"address": "127.0.0.1"}}}


def ask_once(port: int, wire: bytes, host: str = "127.0.0.1",
             timeout: float = FED_CLIENT_TIMEOUT_S):
    """One query on a fresh socket, never retried: the reply, or None
    past ``timeout`` (a client-visible timeout)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        s.sendto(wire, (host, port))
        try:
            return s.recv(65535)
        except socket.timeout:
            return None


def make_pki(tmp: str):
    """A CA and a certificate for ``ufds.foo.com`` and 127.0.0.1 signed
    by it, made with the ``openssl`` command line; returns the paths
    ``(ca, cert, key)``."""
    openssl = shutil.which("openssl")
    if openssl is None:
        raise PhaseError("federation: no openssl on this host; the UFDS "
                         "leg needs it for its certificates")
    ca, ca_key = os.path.join(tmp, "ca.pem"), os.path.join(tmp, "ca.key")
    cert, key = os.path.join(tmp, "ufds.pem"), os.path.join(tmp, "ufds.key")
    csr, ext = os.path.join(tmp, "ufds.csr"), os.path.join(tmp, "ufds.ext")
    with open(ext, "w") as f:
        f.write(f"subjectAltName=DNS:ufds.{DOMAIN},IP:127.0.0.1\n"
                "basicConstraints=critical,CA:FALSE\n"
                "keyUsage=critical,digitalSignature\n"
                "extendedKeyUsage=serverAuth\n"
                "authorityKeyIdentifier=keyid\n")
    ec = ["-newkey", "ec", "-pkeyopt", "ec_paramgen_curve:prime256v1",
          "-nodes"]
    for args in (
            ["req", "-x509", *ec, "-keyout", ca_key, "-out", ca,
             "-days", "2", "-subj", "/CN=binder-smoke-ca",
             "-addext", "basicConstraints=critical,CA:TRUE",
             "-addext", "keyUsage=critical,keyCertSign,cRLSign"],
            ["req", *ec, "-keyout", key, "-out", csr,
             "-subj", f"/CN=ufds.{DOMAIN}"],
            ["x509", "-req", "-in", csr, "-CA", ca, "-CAkey", ca_key,
             "-set_serial", "2", "-days", "2", "-out", cert,
             "-extfile", ext]):
        out = subprocess.run([openssl, *args], capture_output=True,
                             timeout=60)
        if out.returncode != 0:
            raise PhaseError(f"federation: openssl {args[0]} exited "
                             f"{out.returncode}: "
                             + out.stderr.decode(errors="replace")[-400:])
    return ca, cert, key


class LdapThread:
    """The port's ``LdapTestServer`` serving ldaps from its own event
    loop, in a thread of this process."""

    def __init__(self, entries, cert: str, key: str):
        import ssl
        import threading
        from binder_torch.recursion.ldap_server import LdapTestServer
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key)
        self.server = LdapTestServer(entries=entries, ssl_context=ctx)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="ldaps", daemon=True)

    def __enter__(self):
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.server.start(),
                                         self.loop).result(10)
        return self.server

    def __exit__(self, *exc) -> None:
        try:
            asyncio.run_coroutine_threadsafe(self.server.stop(),
                                             self.loop).result(10)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            self.loop.close()


def boot_all(specs, started):
    """Start ``python -m binder_torch.main`` for every ``(config, log,
    what)`` at once, each added to ``started`` (the caller reaps them);
    return the processes and, once each serves, their UDP ports."""
    procs = [spawn(["-m", "binder_torch.main", "-f", config, "-p", "0"],
                   log_path) for config, log_path, _ in specs]
    started += procs
    ports = []
    for proc, (_, log_path, what) in zip(procs, specs):
        m = wait_line(proc, log_path,
                      rb"UDP DNS service started on [\d.]+:(\d+)", what,
                      BOOT_DEADLINE_S)
        ports.append(int(m.group(1)))
    return procs, ports


def ask_all(port: int, wires):
    """Every wire asked once (``ask_once``) from ``FED_SWEEP_THREADS``
    threads; the replies (None for a timeout) in order."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(FED_SWEEP_THREADS) as pool:
        return list(pool.map(lambda w: ask_once(port, w), wires))


def answer_errors(what: str, name: str, data, addr: str, clamp=None):
    """Why ``data`` is not a NOERROR answer of ``addr`` (with a TTL of
    at most ``clamp`` when given); empty when it is."""
    from binder_torch.dns import Message, Rcode
    if data is None:
        return [f"{what}: client-visible timeout for {name}"]
    msg = Message.decode(data)
    if msg.rcode != Rcode.NOERROR or not msg.answers:
        return [f"{what}: {name} got rcode {msg.rcode} with "
                f"{len(msg.answers)} answer(s)"]
    if msg.answers[0].address != addr:
        return [f"{what}: {name} served {msg.answers[0].address}, "
                f"want {addr}"]
    if clamp is not None and msg.answers[0].ttl > clamp:
        return [f"{what}: {name} TTL {msg.answers[0].ttl} > clamp "
                f"{clamp} (not stale-served?)"]
    return []


def ufds_leg(port: int, mport: int, west_port: int, name: str) -> dict:
    """Discovery over LDAPS routed ``west``, and a west name asked with
    RD=1 comes back byte-identical to west's own answer."""
    from binder_torch.dns import Type, make_query
    t0 = time.monotonic()
    while True:
        rec = http_json(mport, "/status").get("recursion") or {}
        dcs = rec.get("datacenters") or {}
        if dcs.get("west"):
            break
        if time.monotonic() - t0 > FED_UFDS_DEADLINE_S:
            raise PhaseError(f"federation: UFDS discovery did not route "
                             f"west in {FED_UFDS_DEADLINE_S:.0f}s ({rec})")
        time.sleep(0.25)
    wire = make_query(name, Type.A, qid=4242, rd=True).encode()
    got = ask_once(port, wire)
    want = ask_once(west_port, wire, host="127.0.0.2")
    errors = []
    if got is None or want is None:
        errors.append(f"ufds: no answer for {name} (through east: "
                      f"{got is not None}, from west: {want is not None})")
    elif not same_but_id_ra(got, want):
        errors.append(f"ufds: the forwarded answer for {name} differs "
                      "from west's own")
    return {"routed_s": time.monotonic() - t0, "datacenters": dcs,
            "errors": errors}


def dark_stream(port: int, west, local, foreign, duration: float):
    """``tools/federation_smoke.py``'s stream: local and foreign names in
    turn, one at a time, each on a fresh socket with no retry, and both
    west processes SIGKILLed at ``FED_DARK_AT`` of it."""
    from binder_torch.dns import Type, make_query
    lat = {"local_pre": [], "local_post": [], "foreign_pre": [],
           "foreign_post": []}
    counts = {"queries": 0, "local_ok": 0, "foreign_ok": 0,
              "foreign_stale": 0, "timeouts": 0}
    errors = []
    dark_at = first_stale = None
    t0 = time.monotonic()
    t_dark, t_end = t0 + duration * FED_DARK_AT, t0 + duration
    i = 0
    while time.monotonic() < t_end:
        if dark_at is None and time.monotonic() >= t_dark:
            # the incident: the whole west group at once
            for proc in west:
                proc.kill()
            for proc in west:
                proc.wait(timeout=10)
            dark_at = time.monotonic()
        i += 1
        is_foreign = i % 2 == 0
        names = foreign if is_foreign else local
        name, addr = names[(i // 2) % len(names)]
        wire = make_query(name, Type.A, qid=(i % 0xFFFF) + 1,
                          rd=True).encode()
        counts["queries"] += 1
        start = time.perf_counter()
        data = ask_once(port, wire)
        elapsed = time.perf_counter() - start
        when = "pre" if dark_at is None else "post"
        why = answer_errors(
            f"{'foreign' if is_foreign else 'local'} {when}-dark", name,
            data, addr,
            FED_TTL_CLAMP_S if is_foreign and dark_at is not None
            else None)
        if data is None:
            counts["timeouts"] += 1
        if why:
            errors += why
        elif is_foreign:
            counts["foreign_ok"] += 1
            if dark_at is not None:
                counts["foreign_stale"] += 1
                if first_stale is None:
                    first_stale = time.monotonic() - dark_at
            lat[f"foreign_{when}"].append(elapsed)
        else:
            counts["local_ok"] += 1
            lat[f"local_{when}"].append(elapsed)
        time.sleep(duration / 1500.0)
    return lat, counts, errors, dark_at, first_stale


def percentile_s(xs, p: float) -> float:
    """``federation_smoke._percentile``: the sample at rank ``n * p``."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * p))]


def render_bstat(snapshot) -> str:
    """``bin/bstat``'s rendering of a ``/status`` snapshot."""
    import importlib.machinery
    import importlib.util
    loader = importlib.machinery.SourceFileLoader(
        "bstat", os.path.join(ROOT, "bin", "bstat"))
    spec = importlib.util.spec_from_loader("bstat", loader)
    bstat = importlib.util.module_from_spec(spec)
    loader.exec_module(bstat)
    return bstat.render(snapshot)


def federation_phase(hosts: int = HOSTS, duration: float = FED_SECONDS,
                     working: int = FED_WORKING_SET, native=None) -> dict:
    """Port of ``tools/federation_smoke.py`` in processes at the serve
    phase's zone: (b) east discovering west over LDAPS, then (a) west
    going dark under east's stream; returns the report."""
    from binder_torch.dns import Message, Rcode, Type, make_query
    from tools.lint import validate_federation_metrics
    t_phase = time.monotonic()
    rng = random.Random(SEED + 7)
    racks = max(1, min(1024, hosts // 512))
    picks = rng.sample(range(hosts), working + 1)
    never = host_name(picks.pop(), racks, "west")
    foreign = [(host_name(i, racks, "west"), host_addr(i)) for i in picks]
    local = [(host_name(i, racks, "east"), host_addr(i))
             for i in rng.sample(range(hosts), working)]
    departures = [d.format(hosts=hosts, working=working)
                  for d in FED_DEPARTURES]
    report = {"zone_names_a_dc": hosts, "duration_s": duration,
              "departures": departures}
    for d in departures:
        log("federation departure: " + d)
    errors = []
    procs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fed_") as tmp:
        logs = {k: os.path.join(tmp, f"{k}.log")
                for k in ("west0", "west1", "east", "ufds")}
        try:
            ca, cert, key = make_pki(tmp)
            t0 = time.monotonic()
            west_cfg = write_config(tmp, hosts, name="west", dc="west",
                                    host="127.0.0.2", subtree="west")
            west, west_ports = boot_all(
                [(west_cfg, logs[f"west{k}"], f"federation: west{k}")
                 for k in range(FED_WEST_PEERS)], procs)
            peers = [f"127.0.0.2:{p}" for p in west_ports]
            entries = {
                f"uuid=w{k}, datacenter=west, region={FED_REGION}, "
                "o=smartdc": {"objectclass": ["resolver"],
                              "datacenter": ["west"], "ip": [peer]}
                for k, peer in enumerate(peers)}
            with LdapThread(entries, cert, key) as ldap:
                east_cfg = write_config(
                    tmp, hosts, name="east", dc="east", subtree="east",
                    fixture={
                        "/dcs/east": {"zones": ["east"], "peers": []},
                        "/dcs/west": {"zones": ["west"], "peers": peers}},
                    federation={"staleTtlClampSeconds": FED_TTL_CLAMP_S,
                                "cacheSize": 4096},
                    admission=FED_ADMISSION)
                ufds_cfg = write_config(
                    tmp, hosts, name="ufds", dc="east", subtree="east",
                    fixture=UFDS_FIXTURE,
                    recursion={"regionName": FED_REGION, "ufds": {
                        "url": f"ldaps://ufds.{DOMAIN}:{ldap.port}",
                        "bindDN": "cn=root", "bindPassword": "secret",
                        "ca": ca}},
                    admission=FED_ADMISSION)
                booted = []
                try:
                    _, (port, uport) = boot_all(
                        [(east_cfg, logs["east"], "federation: east"),
                         (ufds_cfg, logs["ufds"],
                          "federation: east (ufds)")], booted)
                    report["boot_s"] = time.monotonic() - t0
                    # (b) UFDS over LDAPS
                    leg_b = ufds_leg(uport, metrics_port(logs["ufds"]),
                                     west_ports[0], foreign[0][0])
                finally:
                    procs += booted
                    # the binder goes before the LDAP server does (one
                    # retrying TLS connects can hang the server's close)
                    if len(booted) > 1:
                        reap(booted[1])
            report["ufds"] = leg_b
            report["ufds"]["ldap_binds"] = ldap.bind_count
            report["ufds"]["ldap_searches"] = ldap.search_count
            errors += leg_b.pop("errors")

            # (a) the dark DC
            mport = metrics_port(logs["east"])
            report.update(settle_zone(mport, "federation"))
            sample = rng.sample(foreign, min(FED_PARITY_SAMPLE, working))
            differ = []
            for k, (name, _) in enumerate(sample):
                wire = make_query(name, Type.A, qid=700 + k,
                                  rd=True).encode()
                a = ask_once(port, wire)
                b = ask_once(west_ports[k % FED_WEST_PEERS], wire,
                             host="127.0.0.2")
                if a is None or b is None or not same_but_id_ra(a, b):
                    differ.append(name)
            report["parity"] = {"sampled": len(sample),
                                "differ": len(differ)}
            if differ:
                errors.append(f"{len(differ)} forwarded answer(s) differ "
                              f"from west's own, e.g. {differ[:3]}")
            t0 = time.monotonic()
            warm = ask_all(port, [
                make_query(name, Type.A, qid=(k % 0xFFFF) + 1,
                           rd=True).encode()
                for k, (name, _) in enumerate(foreign)])
            report["warm_s"] = time.monotonic() - t0
            for (name, addr), data in zip(foreign, warm):
                errors += answer_errors("warm", name, data, addr)
            before = native_reading(mport)
            lat, counts, stream_errors, dark_at, first_stale = \
                dark_stream(port, west, local, foreign, duration)
            errors += stream_errors
            report["stream"] = counts
            if dark_at is None or first_stale is None:
                errors.append("the incident never ran, or no stale "
                              "answer followed it")
            t0 = time.monotonic()
            after_dark = ask_all(port, [
                make_query(name, Type.A, qid=(k % 0xFFFF) + 1,
                           rd=True).encode()
                for k, (name, _) in enumerate(foreign)])
            report["sweep_s"] = time.monotonic() - t0
            swept = 0
            for (name, addr), data in zip(foreign, after_dark):
                why = answer_errors("post-dark sweep", name, data, addr,
                                    FED_TTL_CLAMP_S)
                errors += why
                swept += not why
            report["post_dark_sweep_ok"] = swept
            miss = ask_once(port, make_query(never, Type.A, qid=9999,
                                             rd=True).encode())
            miss_rcode = None if miss is None else \
                Message.decode(miss).rcode
            report["never_seen_rcode"] = miss_rcode
            if miss_rcode != Rcode.REFUSED:
                errors.append(f"never-seen {never} got rcode "
                              f"{miss_rcode}, want REFUSED")
            pre50 = percentile_s(lat["local_pre"], 0.50)
            post50 = percentile_s(lat["local_post"], 0.50)
            post99 = percentile_s(lat["local_post"], 0.99)
            report.update({
                "local_p50_ms": {"pre": pre50 * 1e3,
                                 "post_dark": post50 * 1e3},
                "local_p99_ms": {"pre": percentile_s(
                    lat["local_pre"], 0.99) * 1e3,
                    "post_dark": post99 * 1e3},
                "foreign_p50_ms": {
                    "pre": percentile_s(lat["foreign_pre"], 0.5) * 1e3,
                    "post_dark": percentile_s(lat["foreign_post"],
                                              0.5) * 1e3},
                "first_stale_ms": (None if first_stale is None
                                   else first_stale * 1e3)})
            if post50 > max(4 * pre50, pre50 + 0.005):
                errors.append(f"local p50 {pre50 * 1e3}ms -> "
                              f"{post50 * 1e3}ms while west was dark")
            if post99 > FED_LOCAL_P99_S:
                errors.append(f"local p99 {post99 * 1e3}ms post-dark")
            if first_stale is not None and first_stale > FED_FIRST_STALE_S:
                errors.append(f"first stale answer {first_stale}s after "
                              "dark")

            text = http_json(mport, "/metrics")
            errors += [f"federation metrics: {e}"
                       for e in validate_federation_metrics(text)[:3]]
            report["stale_served_total"] = metric_sum(
                text, "binder_federation_foreign_stale_served_total")
            status = http_json(mport, "/status")
            fed = status.get("federation") or {}
            report["dark"] = fed.get("dark")
            report["convergence_ms"] = (
                None if fed.get("last_convergence_seconds") is None
                else fed["last_convergence_seconds"] * 1e3)
            if fed.get("dark") != ["west"]:
                errors.append(f"/status federation.dark is "
                              f"{fed.get('dark')}, want ['west']")
            if report["convergence_ms"] is None:
                errors.append("/status federation has no "
                              "last_convergence_seconds")
            rendered = render_bstat(status)
            if "federation:" not in rendered or "(DARK)" not in rendered:
                errors.append("bstat does not render the federation "
                              "line with (DARK)")
            kinds = (status.get("flight_recorder") or {}).get(
                "by_type") or {}
            report["flight_events"] = {
                k: kinds.get(k, 0)
                for k in ("dc-join", "dc-dark", "federation-failover")}
            errors += [f"missing flight event {k}"
                       for k, n in report["flight_events"].items() if not n]
            after = native_reading(mport)
            report["c_lane"] = native_delta(before, after)
            errors += native_gate("federation", before, after)
        except PhaseError:
            for name, path in logs.items():
                if os.path.exists(path):
                    tail = read_bytes(path)[-2000:].decode(
                        errors="replace")
                    log(f"--- federation {name}.log (last 2000 bytes) "
                        f"---\n{tail}")
            raise
        finally:
            for proc in procs:
                reap(proc)
    left = descendants(os.getpid())
    report["phase_s"] = time.monotonic() - t_phase
    report["errors"] = len(errors)
    log(json.dumps({"federation": report}))
    if native is not None:
        native["federation"] = report["c_lane"]
    check_phase("federation", errors, left)
    return report


# -- phase 12: verify -------------------------------------------------

#: the in-process half of ``tools/verify_smoke.py``: the audit interval,
#: the soak and the RSS bound (``verify_smoke.py:65``); the subprocess
#: half (``skew-replica`` against the replica digest) runs in chaos (a)
VERIFY_SECONDS = 10.0
VERIFY_AUDIT_INTERVAL_S = 0.05
VERIFY_RSS_GROWTH_KB = 96 * 1024
#: churn names: each owns a /24, so address moves never collide across
#: names (ptr-coherence stays clean)
VERIFY_CHURN = 4
VERIFY_INVARIANTS = ("ptr-coherence", "compiled-bytes", "dangling-srv",
                     "stale-epoch")
VERIFY_STAGES = ("mirror-apply", "precompile-render", "compiled-install")
VERIFY_DEPARTURES = (
    "zone: the serve phase's {hosts} hosts, where the reference smoke "
    "serves 15 names",
    "lanes: the C lane resident and serving (the reference smoke stands "
    "it down with query_log=True)",
    "soak: {duration} s after the zone fill and the precompile seed "
    "settled (make ci's trim gives the reference smoke 5 s)")


def verify_churn(i: int):
    """Churn write ``i``: its path and its record."""
    return (f"/com/foo/vchurn/c{i % VERIFY_CHURN}",
            {"type": "host", "host": {
                "address": f"10.60.{i % VERIFY_CHURN + 1}.{i % 250 + 1}"}})


async def ask_async(port: int, wire: bytes, timeout: float = 2.0):
    """One UDP query from this process's event loop; the reply."""
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


def inproc_reading(server) -> dict:
    """``native_reading`` for a server in this process."""
    from binder_torch import _binderfastio
    text = server.collector.expose()
    stats = _binderfastio.fastpath_stats(server._fastpath)
    out = {f: metric_sum(text, f) for f in NATIVE_GAUGES}
    out["c_zone_hits"] = stats["zone_hits"]
    out["c_cache_hits"] = stats["hits"]
    return out


async def verify_settle(server, what: str = "verify",
                        deadline_s: float = SETTLE_DEADLINE_S):
    """Wait until the zone fill and the precompile seed are done."""
    t0 = time.monotonic()
    last = None
    while True:
        entries = inproc_reading(server)["binder_zone_entries"]
        pc = server._precompiler
        seed = None if pc is None else pc._seed_task
        if (entries > 0 and entries == last
                and (seed is None or seed.done())):
            return {"zone_entries": entries,
                    "settle_s": time.monotonic() - t0}
        if time.monotonic() - t0 > deadline_s:
            raise PhaseError(f"{what}: the zone fill and seed did not "
                             f"settle in {deadline_s:.0f}s")
        last = entries
        await asyncio.sleep(SETTLE_EVERY_S)


async def verify_run(hosts: int, duration: float) -> dict:
    """The clean soak, then the scripted corruption and one audit cycle,
    against an in-process server at ``hosts`` names."""
    from binder_torch.chaos import ChaosDriver, FaultPlan
    from binder_torch.dns import Message, Rcode, Type, make_query
    from binder_torch.dns.wire import WireError
    from binder_torch.introspect import FlightRecorder, Introspector
    from binder_torch.metrics.collector import MetricsCollector
    from binder_torch.server import BinderServer
    from binder_torch.store import FakeStore, MirrorCache
    from binder_torch.store.fake import load_state, populate_synthetic
    from tools.lint import validate_status_snapshot, validate_verify_metrics
    errors = []
    report = {"zone_names": hosts, "duration_s": duration,
              "departures": [d.format(hosts=hosts, duration=duration)
                             for d in VERIFY_DEPARTURES]}
    collector = MetricsCollector()
    recorder = FlightRecorder(capacity=1024)
    store = FakeStore(recorder=recorder)
    fixture = zone_fixture()
    fixture.update(dict(verify_churn(i) for i in range(VERIFY_CHURN)))
    load_state(store, fixture)
    populate_synthetic(store, DOMAIN, hosts=hosts)
    cache = MirrorCache(store, DOMAIN, collector=collector,
                        recorder=recorder)
    store.start_session()
    server = BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        host="127.0.0.1", port=0, collector=collector, query_log=False,
        flight_recorder=recorder, answer_precompile=True,
        verify={"auditIntervalSeconds": VERIFY_AUDIT_INTERVAL_S},
        rrl={"allowlist": ["127.0.0.0/8"]})
    t0 = time.monotonic()
    await server.start()
    try:
        if server._fastpath is None:
            raise PhaseError("verify: the server has no C lane")
        intro = Introspector(server=server, recorder=recorder,
                             name="chip-smoke-verify")
        intro.set_loop(asyncio.get_running_loop())
        vf = server._verify
        report.update(await verify_settle(server))
        report["boot_s"] = time.monotonic() - t0
        racks = max(1, min(1024, hosts // 512))
        rng = random.Random(SEED + 8)
        before = inproc_reading(server)
        rss0 = rss_kb(os.getpid())
        checks0 = sum(vf.checks.values())

        # 1. the clean soak: churn and queries, no violation
        loop = asyncio.get_running_loop()
        t_end = loop.time() + duration
        snapshot_errs = []
        i = queries = 0
        while loop.time() < t_end:
            i += 1
            path, rec = verify_churn(i)
            store.put_json(path, rec)
            h = rng.randrange(hosts)
            asks = [(host_name(h, racks), Type.A, host_addr(h))]
            if i % 5 == 0:
                asks.append((f"c{i % VERIFY_CHURN}.vchurn.{DOMAIN}",
                             Type.A, None))
            if i % 7 == 0:
                asks.append((f"svc.{DOMAIN}", Type.A, None))
            for k, (name, qtype, addr) in enumerate(asks):
                msg = Message.decode(await ask_async(
                    server.udp_port, make_query(
                        name, qtype, qid=(i * 4 + k) & 0xFFFF).encode()))
                queries += 1
                if msg.rcode != Rcode.NOERROR or not msg.answers or (
                        addr and msg.answers[0].address != addr):
                    errors.append(f"soak: bad answer for {name}: rcode "
                                  f"{msg.rcode}")
            if i % 31 == 0:
                snapshot_errs += validate_status_snapshot(intro.snapshot())
            await asyncio.sleep(duration / 400.0)
        report["soak"] = {"mutations": i, "queries": queries}
        errors += [f"status snapshot: {e}" for e in snapshot_errs[:3]]
        # finish the pass in flight: at 100,000 names the background
        # audit does not complete one inside the soak
        t1 = time.perf_counter()
        vf.audit_cycle()
        report["soak_audit_cycle_s"] = time.perf_counter() - t1
        report["audit_passes_after_soak"] = vf.audit_passes
        fired = {k: v for k, v in vf.violations.items() if v}
        if fired:
            errors.append(f"the clean soak fired violations: {fired}")
        if vf._audit_work or vf.audit_passes < 1:
            errors.append(f"no full audit pass ({vf.audit_passes} "
                          f"started, {len(vf._audit_work)} item(s) left)")
        for inv in VERIFY_INVARIANTS:
            if not vf.checks[inv]:
                errors.append(f"invariant {inv} never checked")
        prop = vf.tracer.introspect()
        report["propagation"] = {
            "observed": prop["observed"],
            "stages": {s: prop["stages"][s]["count"]
                       for s in prop["stages"]}}
        for stage in VERIFY_STAGES:
            if not prop["stages"][stage]["count"]:
                errors.append(f"propagation stage {stage} never observed "
                              "under churn")
        errors += [f"verify metrics: {e}"
                   for e in validate_verify_metrics(collector.expose())[:3]]

        # 2. the scripted corruption, detected within one audit cycle
        ckey = next(iter(server.answer_cache._compiled), None)
        if ckey is None:
            raise PhaseError("verify: no compiled entries to corrupt")
        # corrupt-answer flips a byte of the entry's classic (no EDNS)
        # wire; ask in both postures before and after
        probes = {posture: make_query(ckey[1], ckey[0], qid=4321,
                                      edns_payload=payload).encode()
                  for posture, payload in (("classic", None),
                                           ("edns", 1232))}
        good = {p: await ask_async(server.udp_port, w)
                for p, w in probes.items()}
        plan = FaultPlan(seed=3).at(0.05, "corrupt-answer") \
            .at(0.15, "drop-reverse")
        await ChaosDriver(plan, store=store, verify_target=server,
                          recorder=recorder).run()
        # what went on serving the corrupted name: the C zone or answer
        # table, or Python; compared by record set, as the C lane
        # rotates
        report["corrupted"] = {"qname": ckey[1], "qtype": ckey[0]}
        for posture, wire in probes.items():
            mark = inproc_reading(server)
            served = await ask_async(server.udp_port, wire)
            seen = inproc_reading(server)
            try:
                after = ("the good records"
                         if record_sets(served) == record_sets(good[posture])
                         else "other records")
            except WireError:
                after = "an undecodable reply"
            report["corrupted"][posture] = {
                "served": after,
                "by_the_c_lane": (seen["c_zone_hits"] + seen["c_cache_hits"]
                                  > mark["c_zone_hits"]
                                  + mark["c_cache_hits"])}
        pending = len(vf._audit_work)
        checks1 = sum(vf.checks.values())
        t1 = time.perf_counter()
        vf.audit_cycle()
        cycle_s = time.perf_counter() - t1
        report["audit_cycle"] = {
            "seconds": cycle_s, "items_in_flight": pending,
            "items_left": len(vf._audit_work),
            "checks": sum(vf.checks.values()) - checks1,
            "checks_per_s": (sum(vf.checks.values()) - checks1) / cycle_s,
            "mirror_names": len(cache.nodes),
            "reverse_entries": len(cache.rev_lookup),
            "compiled_entries": len(server.answer_cache._compiled)}
        if vf._audit_work:
            errors.append(f"one audit cycle stopped at its slice cap with "
                          f"{len(vf._audit_work)} item(s) left")
        report["violations"] = {k: v for k, v in vf.violations.items() if v}
        for inv, action in (("compiled-bytes", "corrupt-answer"),
                            ("ptr-coherence", "drop-reverse")):
            if vf.violations[inv] < 1:
                errors.append(f"{action} not detected within one audit "
                              "cycle")
        # each violation shows three ways: the flight event, the
        # counter and /status
        if recorder.by_type.get("verify-violation", 0) < 2:
            errors.append("violations missing from the flight recorder")
        text = collector.expose()
        for inv in ("compiled-bytes", "ptr-coherence"):
            if series_value(text, "binder_verify_violations_total",
                            f'invariant="{inv}"') < 1:
                errors.append(f"binder_verify_violations_total for {inv} "
                              "did not advance")
        snap = intro.snapshot()
        recent = {v["invariant"]
                  for v in snap["verify"]["recent_violations"]}
        if not {"compiled-bytes", "ptr-coherence"} <= recent:
            errors.append(f"/status recent_violations has only "
                          f"{sorted(recent)}")
        errors += [f"status snapshot mid-violation: {e}"
                   for e in validate_status_snapshot(snap)[:3]]
        report["rss_growth_kb"] = rss_kb(os.getpid()) - rss0
        if report["rss_growth_kb"] > VERIFY_RSS_GROWTH_KB:
            errors.append(f"RSS grew {report['rss_growth_kb']} kB (limit "
                          f"{VERIFY_RSS_GROWTH_KB})")
        report["checks"] = dict(vf.checks)
        report["checks_total"] = sum(vf.checks.values()) - checks0
        report["c_lane"] = native_delta(before, inproc_reading(server))
        errors += native_gate("verify", before, inproc_reading(server))
    finally:
        await server.stop()
    report["errors"] = errors
    return report


def verify_phase(hosts: int = HOSTS, duration: float = VERIFY_SECONDS,
                 native=None) -> dict:
    """Port of the in-process half of ``tools/verify_smoke.py`` at the
    serve phase's zone; returns the report."""
    import gc
    t_phase = time.monotonic()
    report = asyncio.run(verify_run(hosts, duration))
    for d in report["departures"]:
        log("verify departure: " + d)
    gc.collect()
    errors = report.pop("errors")
    report["phase_s"] = time.monotonic() - t_phase
    report["errors"] = len(errors)
    log(json.dumps({"verify": report}))
    if native is not None:
        native["verify"] = report["c_lane"]
    check_phase("verify", errors, descendants(os.getpid()))
    return report


# -- phases 13 and 14: tcp, conformance -------------------------------

#: ``tools/tcp_smoke.py``'s write-buffer cap (``tcp_smoke.py:130``),
#: and how long a counter or the connection table may take to settle
TCP_WRITE_BUFFER = 4096
TCP_SETTLE_S = 5.0
TCP_PIPELINE = 8
TCP_SLOW_FRAMES = 20_000
TCP_DEPARTURES = (
    "server: python -m binder_torch.main at the serve phase's zone with "
    "its C lane resident, read through /metrics and /status, where the "
    "reference smoke reads an in-process server's counters",
    "slow reader: big.foo.com (64 addresses) where the reference pumps "
    "a 40-member service")
#: the RFC golden byte-vectors of ``tests/test_conformance.py``
#: (``TestGoldenVectors``), hand-assembled from RFC 1035, 2782 and 6891
GOLDEN = {
    "query_a": (  # RFC 1035 4.1: id 0x1234, RD, example.com A IN
        "1234" "0100" "0001" "0000" "0000" "0000"
        "07" "6578616d706c65" "03" "636f6d" "00" "0001" "0001"),
    "response_a": (  # answer name a pointer to the question (0xc00c)
        "1234" "8580" "0001" "0001" "0000" "0000"
        "07" "6578616d706c65" "03" "636f6d" "00" "0001" "0001"
        "c00c" "0001" "0001" "0000012c" "0004" "5db8d822"),
    "response_srv": (  # RFC 2782, target uncompressed
        "0007" "8400" "0001" "0001" "0000" "0000"
        "035f7067" "045f746370" "03737663" "03666f6f" "03636f6d" "00"
        "0021" "0001" "c00c" "0021" "0001" "0000001e" "0017"
        "000a" "0014" "1538"
        "036c6230" "03737663" "03666f6f" "03636f6d" "00"),
    "response_ptr": (  # RFC 1035 3.3.12: 3.2.1.10.in-addr.arpa
        "0009" "8400" "0001" "0001" "0000" "0000"
        "0133" "0132" "0131" "023130" "07696e2d61646472" "046172706100"
        "000c" "0001" "c00c" "000c" "0001" "0000001e" "000d"
        "0377656203666f6f03636f6d00"),
    "response_soa": (  # RFC 1035 3.3.13 in the authority section
        "000b" "8400" "0001" "0000" "0001" "0000"
        "03666f6f03636f6d00" "0001" "0001"
        "c00c" "0006" "0001" "00000e10" "0029"
        "026e7303666f6f03636f6d00" "07616461646d696e00"
        "78512ec6" "00000e10" "00000384" "00093a80" "0000003c"),
    "query_edns": (  # RFC 6891: OPT with payload 1232
        "0042" "0000" "0001" "0000" "0000" "0001"
        "0377656203666f6f03636f6d00" "0001" "0001"
        "00" "0029" "04d0" "00000000" "0000"),
}
CONFORMANCE_DEPARTURE = (
    "route: glibc's res_query through _res pointed at the server's "
    "ephemeral port (binder_torch.cli.libresolv_probe --server), where "
    "the reference rewrites /etc/resolv.conf and binds port 53 as root")
#: the shipped fixture's service (etc/fixture.json)
FIXTURE_SRV = (f"_http._tcp.svc.{DOMAIN}", 8080,
               {f"lb0.svc.{DOMAIN}": "10.0.1.1",
                f"lb1.svc.{DOMAIN}": "10.0.1.2"})
#: a host record without a ttl is served with this one (the reference's
#: ``TestLibresolvConformance`` reads it through glibc)
HOST_TTL = 30


def golden_errors():
    """``TestGoldenVectors``'s assertions through ``binder_torch.dns``."""
    from binder_torch.dns import (ARecord, Message, OPTRecord, PTRRecord,
                                  Rcode, SOARecord, SRVRecord, Type,
                                  make_query)
    g = {k: bytes.fromhex(v) for k, v in GOLDEN.items()}
    errors = []

    def expect(what, ok):
        if not ok:
            errors.append(f"golden {what}")

    expect("query encode", make_query("example.com", Type.A, qid=0x1234,
                                      rd=True, edns_payload=None).encode()
           == g["query_a"])
    expect("mixed-case query encode", make_query(
        "ExAmPlE.CoM", Type.A, qid=0x1234, rd=True,
        edns_payload=None).encode() == g["query_a"])
    m = Message.decode(g["query_a"])
    expect("query decode", (m.id, m.qr, m.rd, m.opcode) == (
        0x1234, False, True, 0) and [(q.name, q.qtype, q.qclass)
                                     for q in m.questions]
        == [("example.com", 1, 1)]
        and not (m.answers or m.authorities or m.additionals))
    m = Message.decode(g["response_a"])
    a = m.answers[0] if len(m.answers) == 1 else None
    expect("compressed A decode", m.qr and m.aa and m.ra
           and m.rcode == Rcode.NOERROR and isinstance(a, ARecord)
           and (a.name, a.ttl, a.address) == ("example.com", 300,
                                              "93.184.216.34"))
    again = Message.decode(m.encode())
    expect("A re-encode round trip", again.answers == m.answers
           and again.questions == m.questions
           and (again.id, again.rcode, again.aa) == (m.id, m.rcode, m.aa))
    m = Message.decode(g["response_srv"])
    srv = m.answers[0] if len(m.answers) == 1 else None
    expect("SRV decode", isinstance(srv, SRVRecord)
           and (srv.name, srv.priority, srv.weight, srv.port, srv.target,
                srv.ttl) == ("_pg._tcp.svc.foo.com", 10, 20, 5432,
                             "lb0.svc.foo.com", 30))
    out = Message(id=7, qr=True, aa=True)
    out.questions = list(m.questions)
    out.answers = [SRVRecord(name="_pg._tcp.svc.foo.com", ttl=30,
                             priority=10, weight=20, port=5432,
                             target="lb0.svc.foo.com")]
    expect("SRV target uncompressed", bytes.fromhex(
        "036c62300373766303666f6f03636f6d00") in out.encode())
    m = Message.decode(g["response_ptr"])
    ptr = m.answers[0] if len(m.answers) == 1 else None
    expect("PTR decode", isinstance(ptr, PTRRecord)
           and (ptr.name, ptr.target) == ("3.2.1.10.in-addr.arpa",
                                          "web.foo.com"))
    m = Message.decode(g["response_soa"])
    soa = m.authorities[0] if len(m.authorities) == 1 else None
    expect("SOA decode", isinstance(soa, SOARecord)
           and (soa.mname, soa.rname, soa.serial, soa.refresh, soa.retry,
                soa.expire, soa.minimum) == (
                    "ns.foo.com", "adadmin", 0x78512EC6, 3600, 900,
                    604800, 60))
    expect("EDNS query encode", make_query(
        "web.foo.com", Type.A, qid=0x42, edns_payload=1232).encode()
        == g["query_edns"])
    opt = Message.decode(g["query_edns"]).additionals
    expect("EDNS query decode", len(opt) == 1
           and isinstance(opt[0], OPTRecord)
           and opt[0].udp_payload_size == 1232 and opt[0].version == 0
           and not opt[0].dnssec_ok and not opt[0].has_options)
    return errors


def tcp_status(mport: int) -> dict:
    return http_json(mport, "/status")["tcp"]


def tcp_wait(mport: int, pred) -> dict:
    """The ``/status`` tcp section once ``pred`` holds of it, or the
    last one read after ``TCP_SETTLE_S``."""
    deadline = time.monotonic() + TCP_SETTLE_S
    while True:
        tcp = tcp_status(mport)
        if pred(tcp) or time.monotonic() > deadline:
            return tcp
        time.sleep(0.05)


def tcp_oneshot(port: int, wire: bytes):
    """Connect, one query, read the reply, close; the reply decoded."""
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=REPLY_STALL_S) as s:
        return tcp_ask(s, wire)


def tcp_leg(port: int, mport: int, name: str) -> dict:
    """``tools/tcp_smoke.py``'s five clients against a live server, each
    judged by the ``/status`` tcp section."""
    from binder_torch.dns import Message, Rcode, Type, make_query
    from tools.lint import validate_status_snapshot, validate_tcp_metrics
    errors = []
    wire = make_query(name, Type.A, qid=1).encode()
    s0 = tcp_status(mport)

    # 1. one-shot: the accept fast path serves it and counts the close
    r = tcp_oneshot(port, wire)
    if r.rcode != Rcode.NOERROR:
        errors.append(f"one-shot rcode {r.rcode}")
    s1 = tcp_wait(mport, lambda t: t["oneshot_closes"]
                  > s0["oneshot_closes"])
    if not (s1["fast_serves"] > s0["fast_serves"]
            and s1["oneshot_closes"] > s0["oneshot_closes"]):
        errors.append(f"the accept fast path did not serve and close "
                      f"({s1})")
    if s1["promotions"] != s0["promotions"]:
        errors.append("a one-shot connection was promoted")

    # 2. pipelined bursts: the second promotes, a burst coalesces
    got = 0
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=REPLY_STALL_S) as s:
        for b in range(2):
            block = b"".join(
                struct.pack(">H", len(w)) + w for w in (
                    make_query(name, Type.A,
                               qid=b * TCP_PIPELINE + k + 1).encode()
                    for k in range(TCP_PIPELINE)))
            s.sendall(block)
            for _ in range(TCP_PIPELINE):
                n = struct.unpack(">H", _recv_exact(s, 2))[0]
                got += Message.decode(_recv_exact(s, n)).rcode \
                    == Rcode.NOERROR
    if got != 2 * TCP_PIPELINE:
        errors.append(f"pipelined bursts: {got} of {2 * TCP_PIPELINE} "
                      "answered NOERROR")
    s2 = tcp_wait(mport, lambda t: t["promotions"] > s1["promotions"])
    if not s2["promotions"] > s1["promotions"]:
        errors.append("the second burst did not promote")
    if not s2["coalesced_writes"] > s1["coalesced_writes"]:
        errors.append("the burst's responses were not coalesced")

    # 3. a slow reader: disconnected at the cap while others are served
    big = make_query(f"big.{DOMAIN}", Type.A, qid=1,
                     edns_payload=4096).encode()
    frame = struct.pack(">H", len(big)) + big
    aborted = False
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as raw:
        raw.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        raw.settimeout(REPLY_STALL_S)
        raw.connect(("127.0.0.1", port))
        try:
            for k in range(TCP_SLOW_FRAMES):
                raw.sendall(frame)
                if k == 64:
                    # another client, served while this one is stuck
                    r = tcp_oneshot(port, wire)
                    if r.rcode != Rcode.NOERROR:
                        errors.append("a client beside the slow reader "
                                      f"got rcode {r.rcode}")
        except socket.timeout:
            errors.append("the slow reader's sends stalled and it was "
                          "never disconnected")
        except OSError:
            aborted = True
    s3 = tcp_wait(mport, lambda t: t["slow_reader_drops"]
                  > s2["slow_reader_drops"])
    if not aborted or not s3["slow_reader_drops"] > s2["slow_reader_drops"]:
        errors.append(f"the slow reader was not dropped at the cap "
                      f"(aborted {aborted}, {s3['slow_reader_drops']} "
                      "drops)")
    r = tcp_oneshot(port, wire)
    if r.rcode != Rcode.NOERROR:
        errors.append("unhealthy after the slow-reader abort")

    # 4. half-close: send, SHUT_WR, and the answer still comes
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=REPLY_STALL_S) as s:
        half = make_query(name, Type.A, qid=9).encode()
        s.sendall(struct.pack(">H", len(half)) + half)
        s.shutdown(socket.SHUT_WR)
        try:
            n = struct.unpack(">H", _recv_exact(s, 2))[0]
            r = Message.decode(_recv_exact(s, n))
            eof = s.recv(16)
        except (PhaseError, OSError) as e:
            r, eof = None, str(e)
    if r is None or r.id != 9 or r.rcode != Rcode.NOERROR or eof != b"":
        errors.append(f"half-close: reply {r}, then {eof!r}")

    # 5. a torn frame then RST: the table returns to empty
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=REPLY_STALL_S) as s:
        s.sendall(b"\x01\x00abc")
        time.sleep(0.1)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     struct.pack("ii", 1, 0))
    s5 = tcp_wait(mport, lambda t: t["open_conns"] == 0
                  and t["rst_drops"] > s3["rst_drops"])
    if s5["open_conns"] != 0:
        errors.append(f"the connection table did not return to empty "
                      f"({s5['open_conns']} open)")
    if not s5["rst_drops"] > s3["rst_drops"]:
        errors.append("the torn-frame RST was not counted")
    r = tcp_oneshot(port, wire)
    if r.rcode != Rcode.NOERROR:
        errors.append("unhealthy after the torn-frame RST")

    # 6. the exposition and the /status section
    errors += [f"tcp metrics: {e}" for e in validate_tcp_metrics(
        http_json(mport, "/metrics"))[:3]]
    status = http_json(mport, "/status")
    errors += [f"status: {e}"
               for e in validate_status_snapshot(status)[:3]]
    if status["tcp"]["max_write_buffer"] != TCP_WRITE_BUFFER:
        errors.append(f"/status tcp max_write_buffer is "
                      f"{status['tcp']['max_write_buffer']}")
    return {"tcp_before": s0, "tcp_after": status["tcp"], "errors": errors}


def probe(server, name: str, qtype: str):
    """``binder_torch.cli.libresolv_probe`` for one question: glibc's
    parse of the answer of ``server`` (``HOST:PORT``, through
    ``--server``), or of the resolver ``/etc/resolv.conf`` names where
    ``server`` is None."""
    route = ["--server", server] if server else []
    out = subprocess.run(
        [sys.executable, "-m", "binder_torch.cli.libresolv_probe", *route,
         name, qtype], cwd=ROOT, capture_output=True, timeout=30)
    if out.returncode != 0:
        raise PhaseError(f"libresolv_probe exited {out.returncode} for "
                         f"{name} {qtype}: "
                         + out.stderr.decode(errors="replace")[-300:])
    return json.loads(out.stdout)


def libresolv_leg(server, hosts: int) -> dict:
    """glibc's resolver against ``server`` (see ``probe``): a host's A
    and its TTL, its PTR, the fixture's SRV with its A additionals, and
    the OPT echo of each; ``right`` names the questions read right."""
    from binder_torch.dns import reverse_name_for_ip
    racks = max(1, min(1024, hosts // 512))
    i = random.Random(SEED + 9).randrange(hosts)
    name, addr = host_name(i, racks), host_addr(i)
    rev = reverse_name_for_ip(addr)
    got = {"a": probe(server, name, "A"), "ptr": probe(server, rev, "PTR"),
           "srv": probe(server, FIXTURE_SRV[0], "SRV")}
    bad = {k: [] for k in got}
    a = got["a"]["answers"]
    if [(r["name"], r["type"], r["address"], r["ttl"]) for r in a] != [
            (name, 1, addr, HOST_TTL)]:
        bad["a"].append(f"A {name}: glibc read {a}")
    p = got["ptr"]["answers"]
    if [(r["name"], r["type"], r["target"]) for r in p] != [
            (rev, 12, name)]:
        bad["ptr"].append(f"PTR {rev}: glibc read {p}")
    srv_name, srv_port, members = FIXTURE_SRV
    s = got["srv"]["answers"]
    if (sorted((r["type"], r["port"], r["priority"], r["target"])
               for r in s)
            != sorted((33, srv_port, 0, t) for t in members)
            or got["srv"]["ancount"] != len(members)):
        bad["srv"].append(f"SRV {srv_name}: glibc read {s}")
    adds = {r["name"]: r["address"] for r in got["srv"]["additional"]
            if r["type"] == 1}
    if adds != members:
        bad["srv"].append(f"SRV {srv_name} additionals: glibc read "
                          f"{got['srv']['additional']}")
    for k, r in got.items():
        if r["opt"] != {"payload": 1232}:
            bad[k].append(f"{k}: OPT echo {r['opt']}, want payload 1232")
    return {"probed": {"a": name, "ptr": rev, "srv": srv_name},
            "glibc": got, "right": [k for k, e in bad.items() if not e],
            "errors": [e for es in bad.values() for e in es]}


def conformance_leg(port: int, hosts: int) -> dict:
    """glibc's resolver against the server on ``port``
    (``libresolv_leg``), then the RFC golden vectors."""
    report = libresolv_leg(f"127.0.0.1:{port}", hosts)
    golden = golden_errors()
    report["errors"] += golden
    report.update(golden_vectors=len(GOLDEN), golden_errors=len(golden))
    return report


def tcp_phase(hosts: int = HOSTS, native=None) -> dict:
    """Port of ``tools/tcp_smoke.py`` against ``python -m
    binder_torch.main`` at the serve phase's zone, then the conformance
    phase against the same server; returns both reports."""
    t_phase = time.monotonic()
    racks = max(1, min(1024, hosts // 512))
    name = host_name(random.Random(SEED + 10).randrange(hosts), racks)
    for d in TCP_DEPARTURES:
        log("tcp departure: " + d)
    log("conformance departure: " + CONFORMANCE_DEPARTURE)
    proc = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tcp_") as tmp:
        log_path = os.path.join(tmp, "server.log")
        try:
            t0 = time.monotonic()
            proc, port = boot_server(
                write_config(tmp, hosts,
                             maxTcpWriteBuffer=TCP_WRITE_BUFFER),
                log_path, "tcp: server")
            boot_s = time.monotonic() - t0
            mport = metrics_port(log_path)
            settled = settle_zone(mport, "tcp")
            before = native_reading(mport)
            tcp = tcp_leg(port, mport, name)
            tcp.update(boot_s=boot_s, **settled)
            after = native_reading(mport)
            tcp["c_lane"] = native_delta(before, after)
            tcp["errors"] += native_gate("tcp", before, after)
            t1 = time.monotonic()
            conf = conformance_leg(port, hosts)
            conf["phase_s"] = time.monotonic() - t1
            conf["c_lane"] = native_delta(after, native_reading(mport))
            if proc.poll() is not None:
                tcp["errors"].append(f"server exited {proc.returncode}")
        except PhaseError:
            if os.path.exists(log_path):
                tail = read_bytes(log_path)[-3000:].decode(errors="replace")
                log(f"--- tcp server.log (last 3000 bytes) ---\n{tail}")
            raise
        finally:
            reap(proc)
    left = descendants(os.getpid())
    errors = tcp.pop("errors")
    tcp.update(phase_s=time.monotonic() - t_phase, errors=len(errors),
               departures=list(TCP_DEPARTURES))
    log(json.dumps({"tcp": tcp}))
    if native is not None:
        native["tcp"] = tcp["c_lane"]
    check_phase("tcp", errors, left)
    errors = conf.pop("errors")
    conf.update(errors=len(errors), departure=CONFORMANCE_DEPARTURE)
    log(json.dumps({"conformance": conf}))
    if native is not None:
        native["conformance"] = conf["c_lane"]
    check_phase("conformance", errors, [])
    return tcp, conf


# -- phase 15: zone ---------------------------------------------------

#: ``tools/zone_smoke.py``'s default sizes and gates
#: (``zone_smoke.py:39-47``): a control zone and the smoke zone, the
#: mutation p50 ratio between them, and the loop-lag watchdog's stall
#: threshold (``introspect/watchdog.py``) the chunked rebuild must stay
#: under
ZONE_CONTROL = 2_000
ZONE_SMOKE = 100_000
ZONE_LAT_RATIO_MAX = 4.0
ZONE_STALL_MS = 250.0
#: leg (b): the bench's ``zone_scale`` sizes around the smoke's
#: (``bench_impl.py:2113-2114``), each probe in its own process with the
#: bench's arguments (``bench_impl.py:2141-2147``), and the verify
#: probe's sizes and burst (``tools/verify_probe.py``)
ZONE_SCALE = (10_000, 1_000_000)
ZONE_SCALE_MUTATIONS = 150
VERIFY_PROBE_SIZES = (10_000, 100_000, 1_000_000)
VERIFY_PROBE_MUTATIONS = 400
#: the checker's per-slice budget (``verify/checker.py``): the audit's
#: worst slice is read against it, not gated
AUDIT_SLICE_BUDGET_MS = 2.0
#: a probe's deadline: a base plus a second for every 5,000 names
ZONE_PROBE_BASE_S = 120.0
#: leg (c): the seeded sample of the zone's hosts, the degradation
#: settings (chaos (b)'s clamp; a cap far beyond the few seconds the
#: leg stays stale, so every stale ask is stale-serving), how long to
#: wait for each state and for the C zone's share to come back
ZONE_LANE_SAMPLE = 2_000
ZONE_LANE_CLAMP_S = 5
ZONE_LANE_MAX_STALENESS_S = 10.0
ZONE_LANE_STATE_S = 10.0
ZONE_LANE_RECOVER_S = 10.0
ZONE_LANE_RECOVER_SAMPLE = 200
#: the address the leg moves its mutated host to (outside the zone's
#: 10.0.0.0/15 and every fixture's range)
ZONE_LANE_MOVED = "10.205.0.1"
ZONE_DEPARTURES = (
    "probes: python -m binder_torch.probe.{{zone,verify}}, each size in "
    "its own process as the bench runs them (zone_smoke.py runs both "
    "sizes in its own process)",
    "scale: leg (b) runs the zone probe at 10,000 and 1,000,000 names "
    "and the verify probe at 10,000, 100,000 and 1,000,000, with the "
    "bench's arguments; the reference smoke runs neither",
    "C lane: leg (c) holds a server at {lane} names with the C zone "
    "resident through a session rebuild and a degradation cycle; the "
    "reference probes have no C lane",
    "order: the two sizes of each latency ratio run back to back, the "
    "zone probe's chain of sizes beside the verify probe's and both "
    "beside leg (c) in the smoke's own process (the bench runs one probe "
    "at a time)")


def rss_peak_kb(pid: int):
    """The larger of ``pid``'s ``VmHWM`` (its peak so far, where the
    kernel reports one) and ``VmRSS`` (now), or None once it has
    exited."""
    seen = []
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(("VmHWM:", "VmRSS:")):
                    seen.append(int(line.split()[1]))
    except OSError:
        pass
    return max(seen, default=None)


def run_probe(kind: str, n: int, *args: int) -> dict:
    """``python -m binder_torch.probe.<kind> n args`` in a process of its
    own; its JSON line, with the process's wall seconds and peak RSS
    under ``"process"``.  The peak is the largest ``rss_peak_kb`` read
    while it ran, every 20 ms (a container's ``/proc`` may give ``VmRSS``
    alone): ``wait4``'s ``ru_maxrss`` would start from the smoke's own
    peak, which the child inherits at the fork."""
    deadline_s = ZONE_PROBE_BASE_S + n / 5000
    argv = [sys.executable, "-m", f"binder_torch.probe.{kind}",
            str(n), *map(str, args)]
    with tempfile.TemporaryFile() as out, tempfile.TemporaryFile() as err:
        t0 = time.monotonic()
        proc = subprocess.Popen(argv, cwd=ROOT, stdout=out, stderr=err)
        peak = 0
        try:
            while proc.poll() is None:
                peak = max(peak, rss_peak_kb(proc.pid) or 0)
                if time.monotonic() - t0 > deadline_s:
                    raise PhaseError(f"zone: probe {kind} at {n} names "
                                     f"ran past {deadline_s:.0f}s")
                time.sleep(0.02)
        finally:
            reap(proc)
        wall_s = time.monotonic() - t0
        out.seek(0)
        err.seek(0)
        lines = out.read().decode().splitlines()
        if proc.returncode != 0 or not lines:
            raise PhaseError(f"zone: probe {kind} at {n} names exited "
                             f"{proc.returncode}: "
                             f"{err.read().decode()[-2000:]}")
    report = json.loads(lines[-1])
    report["process"] = {"wall_s": wall_s, "peak_rss_kb": peak}
    log(json.dumps({"zone_probe": {"kind": kind, **report}}))
    return report


def scrape_mirror_metrics() -> list:
    """``zone_smoke.py``'s exposition check: a collector-wired port
    server over a small mirror, held to ``validate_mirror_metrics``."""
    from binder_torch.metrics.collector import MetricsCollector
    from binder_torch.server import BinderServer
    from binder_torch.store import FakeStore, MirrorCache
    from tools.lint import validate_mirror_metrics
    collector = MetricsCollector()
    store = FakeStore()
    store.put_json("/com/smoke/web",
                   {"type": "host", "host": {"address": "10.0.0.1"}})
    cache = MirrorCache(store, "smoke.com", collector=collector)
    store.start_session()
    BinderServer(zk_cache=cache, dns_domain="smoke.com",
                 collector=collector, cache_size=16)
    return validate_mirror_metrics(collector.expose())


def zone_smoke_leg(ctl: dict, big: dict) -> dict:
    """Leg (a): the port of ``tools/zone_smoke.py``'s gates
    (``zone_smoke.py:69-108``) over the control's and the smoke size's
    probe runs."""
    errors = []
    smoke = big["names"]
    ratio = big["mutation_p50_us"] / max(1e-9, ctl["mutation_p50_us"])
    if ratio > ZONE_LAT_RATIO_MAX:
        errors.append(f"mutation latency scales with zone size: p50 "
                      f"{big['mutation_p50_us']}us at {smoke} names vs "
                      f"{ctl['mutation_p50_us']}us at {ctl['names']} "
                      f"(ratio {ratio:.2f} > {ZONE_LAT_RATIO_MAX})")
    parity = ctl["parity_failures"] + big["parity_failures"]
    if parity:
        errors.append(f"{parity} re-rendered answer(s) diverged from a "
                      "fresh engine render")
    if big["rebuild_max_loop_lag_ms"] > ZONE_STALL_MS:
        errors.append(f"chunked rebuild stalled the loop "
                      f"{big['rebuild_max_loop_lag_ms']}ms at {smoke} "
                      f"names (threshold {ZONE_STALL_MS}ms)")
    if big["rebuild_miss_mid"]:
        errors.append(f"{big['rebuild_miss_mid']} lookup(s) went dark "
                      "during the chunked rebuild")
    if big["rebuild_chunks"] < 2:
        errors.append(f"the rebuild at {smoke} names did not chunk")
    lint = scrape_mirror_metrics()
    if lint:
        errors.append("mirror metrics exposition: " + "; ".join(lint[:5]))
    return {"control_names": ctl["names"], "smoke_names": smoke,
            "mutation_p50_ratio": ratio, "mirror_metrics_errors": lint,
            "errors": errors}


def zone_scale_leg(zone: dict, verify: dict) -> dict:
    """Leg (b): the scale gates over the zone probe's runs (``zone``,
    by size, leg (a)'s smoke size among them) and the verify probe's
    (``verify``), and the readings per size."""
    errors = []
    for n, r in sorted(zone.items()):
        if r["parity_failures"]:
            errors.append(f"zone probe at {n}: {r['parity_failures']} "
                          "parity failure(s)")
        if r["rebuild_miss_mid"]:
            errors.append(f"zone probe at {n}: {r['rebuild_miss_mid']} "
                          "lookup(s) missed mid-rebuild")
    for n, r in sorted(verify.items()):
        if r["violations"]:
            errors.append(f"verify probe at {n}: {r['violations']} "
                          "violation(s) on an uncorrupted zone")
    ratios = {}
    for kind, runs in (("zone", zone), ("verify", verify)):
        lo, hi = min(runs), max(runs)
        ratios[kind] = (runs[hi]["mutation_p50_us"]
                        / max(1e-9, runs[lo]["mutation_p50_us"]))
        if ratios[kind] > ZONE_LAT_RATIO_MAX:
            errors.append(f"{kind} probe: mutation p50 "
                          f"{runs[hi]['mutation_p50_us']}us at {hi} names "
                          f"vs {runs[lo]['mutation_p50_us']}us at {lo} "
                          f"(ratio {ratios[kind]:.2f} > "
                          f"{ZONE_LAT_RATIO_MAX})")
    top = zone[max(zone)]
    if top["rebuild_max_loop_lag_ms"] > ZONE_STALL_MS:
        errors.append(f"the rebuild at {max(zone)} names stalled the loop "
                      f"{top['rebuild_max_loop_lag_ms']}ms (threshold "
                      f"{ZONE_STALL_MS}ms)")
    readings = {"zone": {n: {
        "mirror_bytes_per_name": r["mirror_rss_per_name_bytes"],
        "mirror_build_s": r["mirror_build_s"],
        "mutation_p50_us": r["mutation_p50_us"],
        "mutation_p99_us": r["mutation_p99_us"],
        "storm_burst": r["storm_burst"],
        "storm_recovery_s": r["storm_recovery_s"],
        "storm_shed": r["storm_shed"], "rebuild_s": r["rebuild_s"],
        "rebuild_chunks": r["rebuild_chunks"],
        "rebuild_max_loop_lag_ms": r["rebuild_max_loop_lag_ms"],
        "rebuild_served_mid": r["rebuild_served_mid"],
        **r["process"]} for n, r in sorted(zone.items())},
        "verify": {n: {
            "mutation_p50_us": r["mutation_p50_us"],
            "mutation_checked_p50_us": r["mutation_checked_p50_us"],
            "propagation": r["propagation"],
            "audit_sample": r["audit_sample"],
            "audit_wall_s": r["audit_wall_s"],
            "audit_slices": r["audit_slices"],
            "audit_worst_slice_ms": r["audit_worst_slice_ms"],
            "audit_worst_slice_over_budget":
                r["audit_worst_slice_ms"] > AUDIT_SLICE_BUDGET_MS,
            "violations": r["violations"], **r["process"]}
            for n, r in sorted(verify.items())},
        "mutation_p50_ratio": ratios}
    return {"readings": readings, "errors": errors}


async def lane_ask(server, name: str, qid: int):
    """One A query for ``name``: the reply and whether the C zone
    served it."""
    from binder_torch import _binderfastio
    from binder_torch.dns import Message, Type, make_query
    before = _binderfastio.fastpath_stats(server._fastpath)["zone_hits"]
    data = await ask_async(server.udp_port,
                           make_query(name, Type.A, qid=qid).encode())
    after = _binderfastio.fastpath_stats(server._fastpath)["zone_hits"]
    return Message.decode(data), after > before


async def lane_round(server, sample, expect, what: str, errors,
                     ttl=None, clamp=None, during=None) -> dict:
    """Ask every name of ``sample`` once, one at a time; every reply
    must be NOERROR with the expected address, and with the TTL
    ``ttl[name]`` or at most ``clamp`` where given.  ``during()``, while
    above 0, marks the asks made in it (the rebuild in flight)."""
    from binder_torch.dns import Rcode
    names = {v: k for k, v in vars(Rcode).items() if k.isupper()}
    out = {"rcodes": {}, "ttls": {}, "zone": {}, "during": 0,
           "zone_served_during": 0}
    bad = []
    for k, name in enumerate(sample):
        mid = during is not None and during() > 0
        try:
            msg, zoned = await lane_ask(server, name, (k + 1) & 0xFFFF)
        except asyncio.TimeoutError:
            bad.append(f"{what}: no reply for {name}")
            continue
        out["zone"][name] = zoned
        out["during"] += mid
        out["zone_served_during"] += mid and zoned
        rcode = names.get(msg.rcode, str(msg.rcode))
        out["rcodes"][rcode] = out["rcodes"].get(rcode, 0) + 1
        got = [a.address for a in msg.answers if hasattr(a, "address")]
        t = msg.answers[0].ttl if msg.answers else None
        out["ttls"][name] = t
        if (msg.rcode != Rcode.NOERROR or got != [expect[name]]
                or (ttl is not None and t != ttl[name])
                or (clamp is not None and t > clamp)):
            bad.append(f"{what}: {name} answered {rcode} {got} TTL {t}, "
                       f"expected {expect[name]}"
                       + (f" TTL {ttl[name]}" if ttl else "")
                       + (f" TTL <= {clamp}" if clamp else ""))
    if bad:
        errors += bad[:5] + [f"{what}: {len(bad)} wrong or missing "
                             f"of {len(sample)}"]
    return out


async def wait_state(intro, state: str, what: str) -> float:
    """Seconds until ``/status`` shows the degradation ``state``."""
    t0 = time.monotonic()
    while True:
        snap = intro.snapshot()["policy"]["degradation"]
        if snap["state"] == state:
            return time.monotonic() - t0
        if time.monotonic() - t0 > ZONE_LANE_STATE_S:
            raise PhaseError(f"zone: {what}: /status shows "
                             f"{snap['state']}, not {state}, after "
                             f"{ZONE_LANE_STATE_S:.0f}s")
        await asyncio.sleep(0.02)


def zone_share(r: dict, names) -> float:
    """The share of ``names`` the C zone served in round ``r``."""
    return sum(r["zone"].get(n, False) for n in names) / max(1, len(names))


async def zone_lane_run(hosts: int, n_sample: int,
                        recover_s: float) -> dict:
    """Leg (c): an in-process server at ``hosts`` names with the C zone
    resident, through a session rebuild and a degradation cycle."""
    import gc
    from binder_torch.introspect import (FlightRecorder, Introspector,
                                         LoopLagWatchdog)
    from binder_torch.metrics.collector import MetricsCollector
    from binder_torch.server import BinderServer
    from binder_torch.store import FakeStore, MirrorCache
    from binder_torch.store.fake import load_state, populate_synthetic
    errors = []
    report = {"zone_names": hosts, "sample": n_sample,
              "stale_ttl_clamp_s": ZONE_LANE_CLAMP_S,
              "max_staleness_s": ZONE_LANE_MAX_STALENESS_S}
    collector = MetricsCollector()
    recorder = FlightRecorder(capacity=1024)
    store = FakeStore(recorder=recorder)
    load_state(store, zone_fixture())
    populate_synthetic(store, DOMAIN, hosts=hosts)
    cache = MirrorCache(store, DOMAIN, collector=collector,
                        recorder=recorder)
    store.start_session()
    server = BinderServer(
        zk_cache=cache, dns_domain=DOMAIN, datacenter_name="dc0",
        host="127.0.0.1", port=0, collector=collector, query_log=False,
        flight_recorder=recorder, rrl={"allowlist": ["127.0.0.0/8"]},
        degradation={"maxStalenessSeconds": ZONE_LANE_MAX_STALENESS_S,
                     "staleTtlClampSeconds": ZONE_LANE_CLAMP_S})
    t0 = time.monotonic()
    await server.start()
    frozen = False
    try:
        if server._fastpath is None or not server._zone_enabled:
            raise PhaseError("zone: the server has no C zone lane")
        intro = Introspector(server=server, recorder=recorder,
                             name="chip-smoke-zone")
        intro.set_loop(asyncio.get_running_loop())
        report.update(await verify_settle(server, "zone"))
        report["boot_s"] = time.monotonic() - t0
        if len(cache.nodes) > 100_000:
            # main.py's posture for a large zone: the mirror frozen out
            # of the collector, so a gen-2 pass is no serving stall
            gc.collect()
            gc.freeze()
            frozen = True
        racks = max(1, min(1024, hosts // 512))
        picks = random.Random(SEED + 11).sample(range(hosts), n_sample)
        sample = [host_name(i, racks) for i in picks]
        expect = {host_name(i, racks): host_addr(i) for i in picks}
        moved = sample[0]
        rest = sample[1:]
        before = inproc_reading(server)

        # 1. the sample once, fresh: the record's own TTLs
        r1 = await lane_round(server, sample, expect, "fresh", errors)
        ttl = dict(r1["ttls"])
        report["fresh"] = {"zone_share": zone_share(r1, sample),
                           "rcodes": r1["rcodes"],
                           "ttls": sorted({t for t in ttl.values()
                                           if t is not None})}
        if any(t is None or t <= ZONE_LANE_CLAMP_S for t in ttl.values()):
            errors.append(f"fresh TTLs {report['fresh']['ttls']} are not "
                          f"above the clamp {ZONE_LANE_CLAMP_S}: the "
                          "stale check would prove nothing")

        # 2. a session rebuild right after a mutation, asked during and
        # after the chunked walk
        i_moved = picks[0]
        epoch0, chunks0 = cache.epoch, cache.rebuild_chunks
        watchdog = LoopLagWatchdog(interval=0.002)
        watchdog.start()
        store.put_json(f"/com/foo/zs/r{i_moved % racks:04d}/h{i_moved:06d}",
                       {"type": "host", "host": {"address": ZONE_LANE_MOVED}})
        expect[moved] = ZONE_LANE_MOVED
        t1 = time.monotonic()
        store.expire_session()
        r2 = await lane_round(server, sample, expect, "mid-rebuild", errors,
                              during=cache.rebuild_pending)
        while cache.rebuild_pending() or server._zone_dirty:
            await asyncio.sleep(0.005)
        drained_s = time.monotonic() - t1
        r3 = await lane_round(server, sample, expect, "after rebuild",
                              errors, ttl=ttl)
        watchdog.stop()
        lag = watchdog.snapshot()
        report["rebuild"] = {
            "epochs": cache.epoch - epoch0,
            "seconds": cache.last_rebuild_duration_s,
            "drained_s": drained_s,
            "chunks": cache.rebuild_chunks - chunks0,
            "asked_mid_rebuild": r2["during"],
            "zone_served_mid_rebuild": r2["zone_served_during"],
            "zone_share_while_rebuilding": zone_share(r2, rest),
            "rcodes": r2["rcodes"], "rcodes_after": r3["rcodes"],
            "moved_host_zone_served_after": r3["zone"].get(moved),
            "unchanged_zone_share_after": zone_share(r3, rest),
            "max_loop_lag_ms": lag["max_lag_seconds"] * 1000,
            "loop_stalls": lag["stalls"]}
        if not r3["zone"].get(moved):
            errors.append(f"the mutated host {moved} was not served from "
                          "the C zone after the rebuild")
        if lag["max_lag_seconds"] >= lag["stall_threshold_seconds"]:
            errors.append(f"the loop lagged {lag['max_lag_seconds']:.3f}s "
                          "through the rebuild (watchdog threshold "
                          f"{lag['stall_threshold_seconds']}s)")

        # 3. a degradation cycle: the session lost, then back
        watchdog = LoopLagWatchdog(interval=0.002)
        watchdog.start()
        store.lose_session()
        to_stale = await wait_state(intro, "stale-serving", "session lost")
        r4 = await lane_round(server, sample, expect, "stale", errors,
                              clamp=ZONE_LANE_CLAMP_S)
        still = intro.snapshot()["policy"]["degradation"]["state"]
        if still != "stale-serving":
            errors.append(f"the stale round ended in {still}: raise the "
                          "cap")
        store.start_session()
        to_fresh = await wait_state(intro, "fresh", "session back")
        t2 = time.monotonic()
        r5 = await lane_round(server, sample, expect, "recovered", errors,
                              ttl=ttl)
        # does the C zone's share come back by itself?
        probe = rest[:ZONE_LANE_RECOVER_SAMPLE]
        target = zone_share(r1, probe)
        polls = []
        while True:
            rp = await lane_round(server, probe, expect, "recovering",
                                  errors, ttl=ttl)
            polls.append(zone_share(rp, probe))
            back = polls[-1] >= target
            if back or time.monotonic() - t2 > recover_s:
                break
            await asyncio.sleep(1.0)
        watchdog.stop()
        lag = watchdog.snapshot()
        stale_ttls = sorted({t for t in r4["ttls"].values()
                             if t is not None})
        report["degradation"] = {
            "to_stale_s": to_stale, "to_fresh_s": to_fresh,
            "stale_rcodes": r4["rcodes"], "stale_ttls": stale_ttls,
            "stale_zone_share": zone_share(r4, sample),
            "recovered_rcodes": r5["rcodes"],
            "zone_share_after_recovery": zone_share(r5, rest),
            "zone_share_polls": polls,
            "zone_share_target": target,
            "zone_share_back_within_s": (time.monotonic() - t2
                                         if back else None),
            "max_loop_lag_ms": lag["max_lag_seconds"] * 1000,
            "loop_stalls": lag["stalls"],
            "transitions": [(t["from"], t["to"]) for t in
                            server._policy.introspect()["transitions"]]}
        report["c_lane"] = native_delta(before, inproc_reading(server))
        errors += native_gate("zone", before, inproc_reading(server))
    finally:
        await server.stop()
        if frozen:
            gc.unfreeze()
    report["errors"] = errors
    return report


def zone_phase(control: int = ZONE_CONTROL, smoke: int = ZONE_SMOKE,
               scale=ZONE_SCALE, verify_sizes=VERIFY_PROBE_SIZES,
               lane_hosts: int = HOSTS, lane_sample: int = ZONE_LANE_SAMPLE,
               recover_s: float = ZONE_LANE_RECOVER_S, native=None) -> dict:
    """Port of ``tools/zone_smoke.py`` at its default size (leg a), the
    zone and verify probes from 10,000 to 1,000,000 names (leg b), and
    the C zone lane through a session rebuild and a degradation cycle
    (leg c); returns the report.

    Each probe size runs in a process of its own, one at a time in two
    chains side by side, a latency ratio's two sizes back to back in one
    chain: the zone probe's (control and smoke sizes, then smallest and
    largest) beside the verify probe's (smallest and largest, then the
    others); leg (c) runs in this process meanwhile.  Runs with each
    ratio's sizes alone read the same spread as runs beside three other
    probes (PERF.md §6): a p50 of a few hundred mutations in a fresh
    process moves that much by itself."""
    import concurrent.futures
    import gc
    t_phase = time.monotonic()
    departures = [d.format(lane=lane_hosts) for d in ZONE_DEPARTURES]
    for d in departures:
        log("zone departure: " + d)
    zone_sizes = sorted({smoke, *scale})
    zone_args = {n: (ZONE_SCALE_MUTATIONS, max(500, smoke // 20))
                 if n == smoke else
                 (ZONE_SCALE_MUTATIONS, max(500, min(5000, n // 10)))
                 for n in zone_sizes}
    verify_lo, verify_hi = min(verify_sizes), max(verify_sizes)
    zone_chain = [("zone", control, 100, max(100, control // 4))] + [
        ("zone", n, *zone_args[n])
        for n in dict.fromkeys((smoke, zone_sizes[0], zone_sizes[-1]))]
    verify_chain = [("verify", n, VERIFY_PROBE_MUTATIONS)
                    for n in dict.fromkeys((verify_lo, verify_hi))]
    rest = [("zone", n, *zone_args[n]) for n in zone_sizes
            if n not in (smoke, zone_sizes[0], zone_sizes[-1])]
    rest += [("verify", n, VERIFY_PROBE_MUTATIONS) for n in verify_sizes
             if n not in (verify_lo, verify_hi)]
    zone, verify = {}, {}
    t_probes = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        chains = [pool.submit(lambda c: [run_probe(*r) for r in c], c)
                  for c in (zone_chain, verify_chain + rest)]
        t_lane = time.monotonic()
        lane = asyncio.run(zone_lane_run(lane_hosts, lane_sample,
                                         recover_s))
        lane["phase_s"] = time.monotonic() - t_lane
        runs = chains[0].result() + chains[1].result()
    probes_s = time.monotonic() - t_probes
    ctl = runs[0]
    for (kind, n, *_), r in zip(zone_chain[1:] + verify_chain + rest,
                                runs[1:]):
        (zone if kind == "zone" else verify)[n] = r
    gc.collect()
    smoke_leg = zone_smoke_leg(ctl, zone[smoke])
    scale_leg = zone_scale_leg(zone, verify)
    errors = (smoke_leg.pop("errors") + scale_leg.pop("errors")
              + lane.pop("errors"))
    report = {"smoke": smoke_leg, "scale": scale_leg["readings"],
              "lane": lane, "departures": departures, "probes_s": probes_s,
              "phase_s": time.monotonic() - t_phase,
              "errors": len(errors)}
    log(json.dumps({"zone": report}))
    if native is not None:
        native["zone"] = lane["c_lane"]
    check_phase("zone", errors, descendants(os.getpid()))
    return report


# -- phase 19: libc ---------------------------------------------------

#: the getent tier of ``tests/test_conformance.py`` (``TestLibcConformance``)
#: at the serve phase's zone: a seeded sample of hosts, asked ``LIBC_BATCH``
#: keys to a ``getent`` call, ``LIBC_CALLS`` calls at once (one after
#: another, 2,000 hosts took 17.3 s of ``getent`` on the H100 host)
LIBC_SAMPLE = 2_000
LIBC_BATCH = 200
LIBC_CALLS = 5
LIBC_UNKNOWN = f"nosuch-libc.zs.{DOMAIN}"
LIBC_DNS_PORT = 53
LIBC_GETENT_S = 120.0
LIBC_DEADLINE_S = 600.0
LIBC_HOST_FILES = ("/etc/resolv.conf", "/etc/nsswitch.conf")
LIBC_DEPARTURES = (
    "route: a private network and mount namespace "
    "(binder_torch.cli.resolv_ns), not the host's resolv.conf and port "
    "53: the server binds 127.0.0.1:53 of the namespace and glibc reads "
    "a resolv.conf bound over the host's there",
    "rrl: loopback allowlisted, as in every phase of this smoke: glibc "
    "asks from 127.0.0.1 alone, five getent calls at once")


def getent(*args: str):
    """``getent`` (glibc's NSS) with ``args``: its exit code and
    output."""
    out = subprocess.run(["getent", *args], capture_output=True,
                         timeout=LIBC_GETENT_S)
    return out.returncode, out.stdout.decode(errors="replace")


def getent_map(database: str, keys, key_field: int, value_field: int):
    """``getent database`` over ``keys``, ``LIBC_BATCH`` a call and
    ``LIBC_CALLS`` calls at once: what each output line's field
    ``key_field`` maps to, and each call's exit code.  ``ahosts`` and
    ``ahostsv4`` print three lines a key, the first with the canonical
    name."""
    got = {}
    with ThreadPoolExecutor(LIBC_CALLS) as pool:
        done = list(pool.map(lambda k: getent(database,
                                              *keys[k:k + LIBC_BATCH]),
                             range(0, len(keys), LIBC_BATCH)))
    for _, text in done:
        for line in text.splitlines():
            fields = line.split()
            if len(fields) > max(key_field, value_field) and (
                    not database.startswith("ahosts")
                    or fields[1] == "STREAM"):
                got.setdefault(fields[key_field], fields[value_field])
    return got, [rc for rc, _ in done]


def namespace_errors() -> list:
    """Errors unless this process runs under ``resolv_ns`` with its
    resolv.conf and nsswitch.conf in place."""
    from binder_torch.cli import resolv_ns
    errors = []
    if "RESOLV_NS" not in os.environ:
        errors.append("not run under binder_torch.cli.resolv_ns")
    try:
        with open(resolv_ns.RESOLV_PATH) as f:
            conf = f.read()
        with open(resolv_ns.NSSWITCH_PATH) as f:
            nss = resolv_ns.hosts_line(f.read())
    except OSError as e:
        return errors + [f"namespace files: {e}"]
    if conf != resolv_ns.RESOLV_CONF:
        errors.append(f"resolv.conf here reads {conf!r}")
    if nss != resolv_ns.NSSWITCH_HOSTS:
        errors.append(f"nsswitch.conf here reads {nss!r}")
    return errors


def libc_leg(hosts: int, sample: int, wrong=None) -> dict:
    """Inside ``resolv_ns``: a server on 127.0.0.1:53 at ``hosts``
    names; ``sample`` of its hosts through ``getent ahostsv4``,
    ``getent hosts`` (name and address), the resolv.conf route of
    ``libresolv_probe`` and one unknown name.  ``wrong``: the index in
    the sample of a host whose address is taken to be another (a planted
    fault for the gate to catch)."""
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))
    errors = namespace_errors()
    racks = max(1, min(1024, hosts // 512))
    chosen = random.Random(SEED + 11).sample(range(hosts), sample)
    names = [host_name(i, racks) for i in chosen]
    addrs = [host_addr(i) for i in chosen]
    if wrong is not None:
        addrs[wrong] = "10.255.255.254"
    zone = dict(zip(names, addrs))
    proc = server_pid = None
    report = {"hosts": hosts, "sample": sample}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_libc_") as tmp:
        log_path = os.path.join(tmp, "server.log")
        try:
            t0 = time.monotonic()
            proc, port = boot_server(write_config(tmp, hosts), log_path,
                                     "libc: server", port=LIBC_DNS_PORT)
            server_pid = proc.pid
            report["boot_s"] = time.monotonic() - t0
            mport = metrics_port(log_path)
            report.update(settle_zone(mport, "libc"))
            before = native_reading(mport)
            t1 = time.monotonic()
            report["queries"] = {}
            # kind -> (database, keys, expected, key field, value field)
            for kind, (db, keys, want, kf, vf) in {
                    "ahostsv4": ("ahostsv4", names, zone, 2, 0),
                    "hosts": ("hosts", names, zone, 1, 0),
                    "hosts_reverse": ("hosts", addrs,
                                      dict(zip(addrs, names)), 0, 1),
            }.items():
                got, rcs = getent_map(db, keys, kf, vf)
                right = sum(got.get(k) == v for k, v in want.items())
                report["queries"][kind] = {"asked": len(want),
                                           "right": right, "rcs": rcs}
                for k, v in want.items():
                    if got.get(k) != v:
                        errors.append(f"getent {kind} {k}: glibc read "
                                      f"{got.get(k)}, the zone says {v}")
            report["getent_s"] = time.monotonic() - t1
            unknown = {db: getent(db, LIBC_UNKNOWN)
                       for db in ("ahostsv4", "hosts")}
            report["unknown"] = {db: rc for db, (rc, _) in unknown.items()}
            for db, (rc, text) in unknown.items():
                if rc != 2 or text:
                    errors.append(f"getent {db} {LIBC_UNKNOWN}: exit {rc}, "
                                  f"{text!r}; glibc must say not found")
            t2 = time.monotonic()
            resolv = libresolv_leg(None, hosts)
            report["libresolv_s"] = time.monotonic() - t2
            errors += resolv.pop("errors")
            report["libresolv"] = resolv
            after = native_reading(mport)
            report["c_lane"] = native_delta(before, after)
            errors += native_gate("libc", before, after)
            if proc.poll() is not None:
                errors.append(f"server exited {proc.returncode}")
        except PhaseError as e:
            errors.append(str(e))
            if os.path.exists(log_path):
                tail = read_bytes(log_path)[-3000:].decode(errors="replace")
                log(f"--- libc server.log (last 3000 bytes) ---\n{tail}")
        finally:
            reap(proc)
    report.update(pids=[os.getpid(), server_pid],
                  left=descendants(os.getpid()), errors=errors,
                  namespace=json.loads(os.environ.get("RESOLV_NS", "null")))
    return report


def libc_leg_main(spec: str) -> int:
    """``chip_smoke.py --libc-leg SPEC``: ``libc_leg(**SPEC)``, printed
    as one ``{"libc_leg": ...}`` line."""
    report = libc_leg(**json.loads(spec))
    log(json.dumps({"libc_leg": report}))
    return 1 if report["errors"] or report["left"] else 0


def file_stamp(path: str):
    """The sha256 and mtime of ``path``, or the error reading it."""
    try:
        with open(path, "rb") as f:
            return [hashlib.sha256(f.read()).hexdigest(),
                    os.stat(path).st_mtime_ns]
    except OSError as e:
        return [f"unreadable: {e}", None]


def libc_phase(hosts: int = HOSTS, sample: int = LIBC_SAMPLE,
               native=None, wrong=None) -> dict:
    """The getent tier on the port: ``libc_leg`` under ``python -m
    binder_torch.cli.resolv_ns``, judged from its one JSON line, with the
    host's ``/etc/resolv.conf`` and ``/etc/nsswitch.conf`` the same
    after as before."""
    from binder_torch.cli import resolv_ns
    t0 = time.monotonic()
    for d in LIBC_DEPARTURES:
        log("libc departure: " + d)
    stamps = {p: file_stamp(p) for p in LIBC_HOST_FILES}
    with open(resolv_ns.NSSWITCH_PATH) as f:
        host_hosts = resolv_ns.hosts_line(f.read())
    spec = json.dumps({"hosts": hosts, "sample": sample, "wrong": wrong})
    proc = subprocess.Popen(
        [sys.executable, "-m", "binder_torch.cli.resolv_ns", "--",
         sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--libc-leg", spec],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out, err = proc.communicate(timeout=LIBC_DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.terminate()        # resolv_ns hands it to the leg
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    said = out.decode(errors="replace")
    lines = [x for x in said.splitlines() if x.startswith('{"libc_leg": ')]
    errors = []
    leg = json.loads(lines[-1])["libc_leg"] if lines else None
    if leg is None:
        errors.append(f"the leg printed no report (resolv_ns exited "
                      f"{proc.returncode}): "
                      + err.decode(errors="replace")[-1500:])
        leg = {"errors": [], "left": [], "pids": []}
    elif proc.returncode != 0 and not leg["errors"]:
        errors.append(f"resolv_ns exited {proc.returncode}")
    errors += leg["errors"]
    changed = [p for p in LIBC_HOST_FILES if file_stamp(p) != stamps[p]]
    errors += [f"the host's {p} changed" for p in changed]
    left = leg["left"] + [p for p in leg["pids"] if p and pid_running(p)]
    report = {k: v for k, v in leg.items()
              if k not in ("errors", "left", "pids")}
    report.update(
        route=(report.get("namespace") or {}).get("route"),
        glibc=os.confstr("CS_GNU_LIBC_VERSION"), host_hosts=host_hosts,
        host_nscd=[d for d in resolv_ns.NSCD_DIRS if os.path.isdir(d)],
        host_files=stamps, host_files_changed=changed,
        phase_s=time.monotonic() - t0, errors=len(errors),
        departures=list(LIBC_DEPARTURES))
    log(json.dumps({"libc": report}))
    if native is not None and "c_lane" in report:
        native["libc"] = report["c_lane"]
    tail = ("\n".join(x for x in said.splitlines() if x not in lines)
            + err.decode(errors="replace"))[-3000:].strip()
    if errors and tail:
        log(f"--- libc leg output ---\n{tail}")
    check_phase("libc", errors, left)
    return report


# -- phase 17: aggregate ----------------------------------------------


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


# -- phase 18: collective ---------------------------------------------


def collective_phase() -> None:
    import concurrent.futures
    from binder_torch.graft_entry import dryrun_multichip, run_ranks
    # the two spawns at once: each rank is its own single-rank group
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        dry = pool.submit(dryrun_multichip, 1)
        ranks = pool.submit(run_ranks, 1, "cuda", timeout_s=RANK_DEADLINE_S)
        dry.result()
        (mean,) = ranks.result()
    expect = float(np.mean(np.linspace(0.0, 1.0, 8, dtype=np.float32),
                           dtype=np.float64))
    log(json.dumps({"collective": {"backend": "nccl", "ranks": 1,
                                   "mean": mean, "expected": expect}}))
    if abs(mean - expect) > 1e-6:
        raise PhaseError(f"collective: mean {mean!r} != {expect!r}")


#: streams cut so that the zone and check phases fit in the smoke's
#: 600 s: each duplicates a stream of an earlier phase, and none cuts a
#: zone, the churn's rate or a gate
STREAM_CUTS = (
    "deploy: the 16-socket UDP stream is 30,000 queries, not 60,000",
    "topology: the 16-address UDP stream is 30,000 queries, not 60,000",
    "systemd: the Python client sends 30,000 UDP queries, not 60,000 "
    "(dnsblast keeps its 60,000)",
    "systemd: the fresh addresses' stream after the restore is 2,000 "
    "queries, as topology's, not 30,000")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "binder_torch")):
        print("chip_smoke: binder_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--churn-cost"]:
        return churn_cost_main([int(n) for n in sys.argv[2].split(",")])
    if sys.argv[1:2] == ["--libc-leg"]:
        return libc_leg_main(sys.argv[2])
    if sys.argv[1:2] == ["--churn"]:
        return churn_main(int(sys.argv[2]), int(sys.argv[3]),
                          CHURN_CLIENTS if sys.argv[4:5] == ["--spread"]
                          else None)
    native = {}
    seconds = {}
    for cut in STREAM_CUTS:
        log("cut: " + cut)

    def timed(name, phase, *args, **kw):
        t0 = time.monotonic()
        try:
            return phase(*args, **kw)
        finally:
            seconds[name] = time.monotonic() - t0
            log(json.dumps({"phase_seconds": seconds}))

    try:
        card_reading()
        # the device check beside the native builds, so the seconds of
        # importing torch and starting CUDA overlap the compilers'
        with ThreadPoolExecutor(1) as pool:
            device = pool.submit(timed, "device", device_phase)
            built = timed("native", native_phase, also=check_builds())
            torch = device.result()
        latencies = timed("serve", serve_phase, native=native)
        sharded = timed("deploy", deploy_phase, native=native)
        timed("balancer", balancer_phase, native=native)
        timed("topology", topology_phase, native=native)
        timed("systemd", systemd_phase, native=native)
        timed("chaos", chaos_phase, native=native)
        timed("hostile", hostile_phase, native=native)
        timed("population", population_phase, native=native)
        timed("federation", federation_phase, native=native)
        timed("verify", verify_phase, native=native)
        timed("tcp", tcp_phase, native=native)
        timed("zone", zone_phase, native=native)
        # the port's make check and the getent tier beside the device
        # phases, which gate on values, not on time
        with ThreadPoolExecutor(2) as pool:
            checked = pool.submit(timed, "check", make_check_phase,
                                  built["also_build_s"])
            libc = pool.submit(timed, "libc", libc_phase, native=native)
            timed("aggregate", aggregate_phase, torch, latencies, sharded)
            timed("collective", collective_phase)
            checked.result()
            libc.result()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        left = stop_children()
    if left:
        print(f"chip_smoke: FAILED: process(es) {left} would not stop",
              file=sys.stderr)
        return 1
    reference = sorted(m for m in sys.modules
                       if m.split(".")[0] == "binder_tpu")
    if reference:
        print(f"chip_smoke: FAILED: the reference was imported: "
              f"{reference[:5]}", file=sys.stderr)
        return 1
    log(json.dumps({"native": {
        "build_s": built["build_s"], "build_wall_s": built["build_wall_s"],
        "clean_checkout": built["clean_checkout"],
        "lane_parity": built["parity"], "c_lane_hits": native}}))
    log(json.dumps({"kernels": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
