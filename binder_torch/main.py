"""Process entry point: config, metrics, store, recursion, server wiring.

Port of the reference's ``main.js`` startup pipeline (``main.js:154-224``):

    metrics server (port+1000) → store client + mirror cache → recursion
    (optional) → balancer-socket SIGTERM handling → DNS server

Run as:  python -m binder_torch.main -f etc/config.json [-p port] [-v]
"""
from __future__ import annotations

import asyncio
import logging
import os
import signal
import sys
import threading
import time
from typing import Dict

from binder_torch.config.options import ConfigError, parse_options
from binder_torch.introspect import (BalancerStatsFold, FlightRecorder,
                                     Introspector, LoopLagWatchdog)
from binder_torch.introspect.loopacct import ACCOUNT
from binder_torch.metrics.collector import MetricsCollector, MetricsServer
from binder_torch.server import BinderServer
from binder_torch.store import FakeStore, MirrorCache
from binder_torch.store.fake import load_state, populate_synthetic
from binder_torch.utils import netif
from binder_torch.utils.jsonlog import log_event, make_logger

NAME = "binder"


def safe_unlink(path: str, log: logging.Logger) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
    except OSError as e:
        log.warning("unlinking socket path %s: %s", path, e)


def make_store(options: Dict[str, object], log: logging.Logger,
               collector=None, recorder=None):
    """Select the coordination-store backend from config."""
    store_cfg = options.get("store") or {}
    backend = store_cfg.get("backend", "zookeeper")
    if backend == "fake":
        store = FakeStore(recorder=recorder)
        fixture = store_cfg.get("fixture")
        if fixture:
            import json
            with open(fixture) as f:
                load_state(store, json.load(f))
        synthetic = store_cfg.get("synthetic")
        if synthetic:
            # zone_scale bench / smoke surface: generate a
            # production-scale zone procedurally instead of shipping a
            # hundred-MB fixture file through JSON twice
            n = populate_synthetic(
                store, str(options["dnsDomain"]),
                hosts=int(synthetic.get("hosts", 0)),
                racks=int(synthetic.get("racks", 0)),
                subtree=str(synthetic.get("subtree", "zs")))
            log.info("synthetic zone: %d host(s) generated", n)
        store.start_session()
        return store
    if backend == "zookeeper":
        try:
            from binder_torch.store.zk_client import ZKClient
        except ImportError as e:
            raise ConfigError(f"zookeeper store backend unavailable: {e}")
        return ZKClient(
            address=store_cfg.get("host",
                                  os.environ.get("ZK_HOST", "127.0.0.1")),
            port=int(store_cfg.get("port", 2181)),
            session_timeout_ms=int(store_cfg.get("sessionTimeout", 30000)),
            log=log,
            collector=collector,
            recorder=recorder,
        )
    raise ConfigError(f"unknown store backend: {backend}")


async def run_supervisor(options: Dict[str, object]):
    """Shard mode (``--shards N``): this process is the mirror OWNER —
    it holds the one store session, fans mutations out to N serving
    workers over per-shard socketpair mutation logs, respawns crashes,
    drains on SIGTERM, and aggregates metrics/status.  It serves no
    queries itself; the kernel balances those across the workers'
    SO_REUSEPORT sockets (binder_torch/shard, docs/operations.md)."""
    from binder_torch.shard import ShardSupervisor

    log = make_logger(NAME, str(options.get("logLevel", os.environ.get(
        "LOG_LEVEL", "info"))))
    log_event(log, logging.INFO, "starting shard supervisor", options={
        k: v for k, v in options.items() if k != "store"})

    port = int(options["port"])
    collector = MetricsCollector(static_labels={
        "datacenter": options.get("datacenterName"),
        "instance": options.get("instance_uuid"),
        "server": options.get("server_uuid"),
        "service": options.get("service_name"),
        "port": port,
    })
    metrics = MetricsServer(collector, address="0.0.0.0",
                            port=port + 1000 if port else 0)
    metrics.start()
    log.info("metrics server started on port %d", metrics.port)

    recorder = FlightRecorder(
        capacity=int(options.get("flightRecorderSize", 512)), log=log)
    # loop accounting and boot phases (docs/observability.md), from
    # before the store session opens
    ACCOUNT.bind(collector, recorder)
    store = make_store(options, log, collector=collector,
                       recorder=recorder)
    cache = MirrorCache(store, str(options["dnsDomain"]), log=log,
                        collector=collector, recorder=recorder)
    supervisor = ShardSupervisor(options=options, store=store,
                                 cache=cache, collector=collector,
                                 recorder=recorder, log=log, name=NAME)
    # arm /status before start(): the canonical announce line prints
    # inside start() once the whole group serves, and a client may
    # poll the snapshot the instant it sees that line (the metrics
    # server thread answers concurrently with the lines below)
    metrics.status_source = supervisor.snapshot
    await supervisor.start()

    loop = asyncio.get_running_loop()

    def on_sigterm():
        log.info("caught SIGTERM; draining %d shard(s)", supervisor.n)

        async def _drain():
            await supervisor.drain()
            os._exit(0)

        loop.create_task(_drain())

    loop.add_signal_handler(signal.SIGTERM, on_sigterm)

    def on_sighup():
        # zero-downtime rolling operations (docs/operations.md
        # "Rolling upgrade / config reload"): re-read the config file
        # and drain-and-replace one shard at a time; a roll already in
        # progress absorbs the repeat signal
        log.info("caught SIGHUP; rolling %d shard(s) with reloaded "
                 "config", supervisor.n)
        supervisor.request_roll(reload_config=True)

    loop.add_signal_handler(signal.SIGHUP, on_sighup)

    # chaos (supervisor-side): store faults and watch storms hit the
    # owner mirror and propagate down every mutation log; shard-kill
    # SIGKILLs a worker mid-load; stream faults drive the shared
    # reuseport TCP port (whichever worker the kernel picks)
    chaos_cfg = options.get("chaos")
    if chaos_cfg:
        from binder_torch.chaos import ChaosDriver, FaultPlan
        from binder_torch.store.cache import domain_to_path
        plan = FaultPlan.parse(str(chaos_cfg.get("plan", "")),
                               seed=int(chaos_cfg.get("seed", 0)))
        domain = str(options["dnsDomain"])

        def chaos_mutate(i: int) -> None:
            store.put_json(
                domain_to_path(f"chaos{i % 8}.{domain}"),
                {"type": "host",
                 "host": {"address": f"10.254.{i % 8}.{i % 250 + 1}"}})

        chaos_host = str(options.get("host", "0.0.0.0"))
        if chaos_host in ("0.0.0.0", "::"):
            chaos_host = "127.0.0.1"
        driver = ChaosDriver(
            plan, store=store,
            mutate=chaos_mutate if hasattr(store, "put_json") else None,
            tcp_target=(chaos_host, supervisor.tcp_port,
                        f"chaos0.{domain}"),
            udp_target=(chaos_host, supervisor.udp_port,
                        f"chaos0.{domain}"),
            shard_target=supervisor.kill_shard,
            # worker-roll is the cooperative counterpart to shard-kill:
            # drain-and-replace with zero query loss, mid-incident
            roll_target=lambda shard=-1: supervisor.request_roll(
                shard=shard),
            # skew-replica desyncs one worker's mutation log (the
            # digest frames must catch it); the supervisor owns the
            # per-link streams
            verify_target=supervisor,
            recorder=recorder, log=log)
        supervisor.chaos_driver = driver
        driver.start()
        log.warning("chaos: FaultPlan armed (%d scheduled action(s), "
                    "%.1fs)", len(plan.timeline), plan.duration)

    watchdog = LoopLagWatchdog(collector=collector, recorder=recorder)
    watchdog.start()
    recorder.install_sigusr2(loop, path=options.get("flightRecorderDump"))
    supervisor.watchdog = watchdog
    supervisor.metrics = metrics
    log.info("done with binder init (shard supervisor)")
    return supervisor


def resolve_shard_count(options: Dict[str, object]) -> int:
    """``shards: "auto"`` sizes the reuseport group to the machine —
    one single-threaded worker per core is the sizing rule
    (docs/operations.md "Sizing N")."""
    n = options.get("shards") or 0
    if n == "auto":
        n = os.cpu_count() or 1
    return int(n)


async def run(options: Dict[str, object]) -> BinderServer:
    shard_worker = options.get("shardWorker")
    # resolve "auto" up front so the supervisor and its status
    # plumbing only ever see an int
    options["shards"] = resolve_shard_count(options)
    if shard_worker is None and options["shards"] >= 1:
        return await run_supervisor(options)
    # the start of this process's boot phases (its imports done)
    started = ACCOUNT.phase_start()

    log = make_logger(NAME, str(options.get("logLevel", os.environ.get(
        "LOG_LEVEL", "info"))))
    log_event(log, logging.INFO, "starting with options", options={
        k: v for k, v in options.items() if k != "store"})

    port = int(options["port"])
    collector = MetricsCollector(static_labels={
        "datacenter": options.get("datacenterName"),
        "instance": options.get("instance_uuid"),
        "server": options.get("server_uuid"),
        "service": options.get("service_name"),
        "port": port,
    })
    # a shard worker's scrape endpoint is per-process (ephemeral port,
    # reported to the supervisor in the hello frame); the well-known
    # port+1000 belongs to the supervisor's aggregated view
    metrics = MetricsServer(collector, address="0.0.0.0",
                            port=(0 if shard_worker is not None
                                  else port + 1000 if port else 0))
    metrics.start()
    log.info("metrics server started on port %d", metrics.port)

    recorder = FlightRecorder(
        capacity=int(options.get("flightRecorderSize", 512)), log=log)
    # loop accounting and boot phases (docs/observability.md), from
    # before the store session opens
    ACCOUNT.bind(collector, recorder)
    if shard_worker is not None:
        # shard worker: NO store session of its own — the one session
        # lives in the supervisor; this process replays the mutation
        # log (snapshot now, deltas once the loop runs)
        from binder_torch.shard import ReplicaStore
        from binder_torch.shard.protocol import (SHARD_FD_ENV,
                                                 SHARD_SPAWNED_ENV)
        spawned = float(os.environ.get(SHARD_SPAWNED_ENV,
                                       time.monotonic()))
        fd = int(os.environ[SHARD_FD_ENV])
        store = ReplicaStore.from_fd(fd, int(shard_worker),
                                     recorder=recorder, log=log)
        nodes = store.read_snapshot()
        # boot phase ``replay``: spawn to the snapshot applied; all of
        # the process's CPU so far (its imports included)
        ACCOUNT.boot_phase("replay", spawned, time.monotonic(),
                           time.process_time())
        serving = ACCOUNT.phase_start()
        log.info("shard %d: snapshot applied (%d node(s))",
                 shard_worker, nodes)
    else:
        store = make_store(options, log, collector=collector,
                           recorder=recorder)
        # boot phase ``serving`` runs from the process's start
        serving = started
    cache = MirrorCache(store, str(options["dnsDomain"]), log=log,
                        collector=collector, recorder=recorder)
    if shard_worker is None:
        # boot phase ``walk``: this process's own session's first walk
        cache.watch_first_walk(asyncio.get_running_loop())

    # multi-DC federation (binder_torch/federation, docs/federation.md):
    # peer discovery from the watched /dcs subtree, cross-DC forwarding
    # through the recursion plane, foreign-answer stale-serve.  Started
    # before the recursion client so its registry already holds the
    # current membership when the routing table first fills.
    federation = None
    fed_cfg = options.get("federation")
    if fed_cfg:
        from binder_torch.federation import Federation
        federation = Federation(
            store=store, dns_domain=str(options["dnsDomain"]),
            datacenter_name=str(options.get("datacenterName", "")),
            config=dict(fed_cfg), collector=collector,
            recorder=recorder, log=log)
        federation.start()

    recursion = None
    if options.get("recursion") or federation is not None:
        try:
            from binder_torch.recursion import Recursion
        except ImportError as e:
            raise ConfigError(f"recursion unavailable: {e}")
        rcfg = dict(options.get("recursion") or {})
        # federation supplies the routing table from its /dcs registry
        # unless the recursion block brings its own discovery (static
        # dcs or UFDS).  Self-exclusion is then by DC name in the
        # registry, not by NIC address — federated peers may share a
        # host (one port per DC), which the NIC filter would wrongly
        # drop; nicSelfFilter: true restores the address filter.
        fed_source = None
        if federation is not None and not (rcfg.get("dcs")
                                           or rcfg.get("ufds")):
            fed_source = federation.resolver_source()
        recursion = Recursion(
            zk_cache=cache, log=log,
            region_name=rcfg.get("regionName", ""),
            datacenter_name=str(options.get("datacenterName", "")),
            dns_domain=str(options["dnsDomain"]),
            source=fed_source,
            # static per-DC resolver lists may live at recursion.dcs or
            # recursion.ufds.dcs; a real UFDS/LDAP source plugs in here
            ufds=rcfg.get("ufds") or rcfg,
            nic_provider=((lambda: [])
                          if fed_source is not None
                          and not (fed_cfg or {}).get("nicSelfFilter")
                          else netif.local_addresses),
            # per-peer circuit breakers report binder_breaker_state and
            # breaker-transition flight events (docs/degradation.md)
            collector=collector, recorder=recorder,
        )
        if federation is not None:
            federation.attach(recursion)
        await recursion.wait_ready()

    balancer_socket = (None if shard_worker is not None
                       else options.get("balancerSocket"))
    if balancer_socket:
        # clear any stale socket; unlink on SIGTERM so the balancer stops
        # routing to us (main.js:181-199)
        safe_unlink(str(balancer_socket), log)
        loop = asyncio.get_running_loop()

        def on_sigterm():
            log.info("caught SIGTERM; unlinking socket %s", balancer_socket)
            safe_unlink(str(balancer_socket), log)
            sys.exit(0)

        loop.add_signal_handler(signal.SIGTERM, on_sigterm)

    server = BinderServer(
        zk_cache=cache,
        dns_domain=str(options["dnsDomain"]),
        datacenter_name=str(options.get("datacenterName", "")),
        recursion=recursion,
        log=log,
        collector=collector,
        name=NAME,
        host=str(options.get("host", "0.0.0.0")),
        port=port,
        balancer_socket=str(balancer_socket) if balancer_socket else None,
        query_log=bool(options.get("queryLog", True)),
        cache_size=int(options.get("size", 10000)),
        cache_expiry_ms=int(options.get("expiry", 60000)),
        zone_precompile=bool(options.get("zonePrecompile", True)),
        answer_precompile=bool(options.get("answerPrecompile", True)),
        precompile_size=(int(options["precompileSize"])
                         if "precompileSize" in options else None),
        tcp_idle_timeout=(float(options["tcpIdleTimeout"])
                          if "tcpIdleTimeout" in options else None),
        max_tcp_conns=(int(options["maxTcpConns"])
                       if "maxTcpConns" in options else None),
        max_tcp_write_buffer=(int(options["maxTcpWriteBuffer"])
                              if "maxTcpWriteBuffer" in options else None),
        flight_recorder=recorder,
        # graceful degradation + overload shedding (docs/degradation.md):
        # on by default in production, tunable/disable-able per block
        # ({"enabled": false} turns one off)
        degradation=dict(options.get("degradation") or {}),
        admission=dict(options.get("admission") or {}),
        # response rate limiting at the UDP ingress (hostile-internet
        # posture, docs/operations.md): same on-by-default convention
        rrl=dict(options.get("rrl") or {}),
        # serving-plane verification + propagation tracing
        # (docs/observability.md): on by default like the other
        # production observability
        verify=dict(options.get("verify") or {}),
        # shard workers share ONE port via SO_REUSEPORT (the kernel
        # balances) and leave the canonical announce lines to the
        # supervisor, which prints them once the whole group serves
        reuse_port=shard_worker is not None,
        announce=shard_worker is None,
    )
    # introspection handle (/status federation section, bstat line)
    server.federation = federation
    if balancer_socket:
        # boot phase ``join``: the process's start to the first balancer
        # link it accepts, which it listens for once the mirror is whole
        server.engine.on_balancer_join = lambda: ACCOUNT.phase_end(
            "join", started)
    await server.start()
    # boot phase ``serving``: the serve stack built and its sockets bound
    ACCOUNT.phase_end("serving", serving)

    if len(cache.nodes) > 100_000:
        # large zones: the mirror is millions of long-lived objects; a
        # gen-2 GC pass over them is a multi-hundred-ms serving stall
        # for zero reclaim.  Freeze the resident set out of collection
        # (query/mutation garbage still collects normally).  Runs
        # BEFORE the loop-lag watchdog arms — the collect+freeze pass
        # is itself a one-time stall-sized pause.
        import gc
        gc.collect()
        gc.freeze()
        log.info("large zone: froze %d mirrored names out of gc",
                 len(cache.nodes))

    # fault injection (chaos) — ONLY when configured, for soaks and the
    # bench's degraded axis: a scripted FaultPlan drives session loss /
    # watch storms / loop stalls inside the live process
    # (binder_torch/chaos, docs/degradation.md).  In shard mode the
    # supervisor owns chaos (it has the store and the kill switch).
    chaos_cfg = None if shard_worker is not None \
        else options.get("chaos")
    if chaos_cfg:
        from binder_torch.chaos import ChaosDriver, FaultPlan
        from binder_torch.store.cache import domain_to_path
        plan = FaultPlan.parse(str(chaos_cfg.get("plan", "")),
                               seed=int(chaos_cfg.get("seed", 0)))
        domain = str(options["dnsDomain"])

        def chaos_mutate(i: int) -> None:
            # default watch-storm mutator: churn a small ring of
            # chaos-owned host records under the served domain
            store.put_json(
                domain_to_path(f"chaos{i % 8}.{domain}"),
                {"type": "host",
                 "host": {"address": f"10.254.{i % 8}.{i % 250 + 1}"}})

        chaos_host = str(options.get("host", "0.0.0.0"))
        if chaos_host in ("0.0.0.0", "::"):
            chaos_host = "127.0.0.1"
        driver = ChaosDriver(
            plan, store=store,
            mutate=chaos_mutate if hasattr(store, "put_json") else None,
            # stream faults (tcp-slow-reader / tcp-half-close /
            # tcp-rst) drive the server's own TCP listener
            tcp_target=(chaos_host, server.tcp_port,
                        f"chaos0.{domain}"),
            udp_target=(chaos_host, server.udp_port,
                        f"chaos0.{domain}"),
            # verify-plane corruption (corrupt-answer / drop-reverse)
            # mutates the server's own tables behind the checker's back
            verify_target=server,
            recorder=recorder, log=log)
        server.chaos_driver = driver
        driver.start()
        log.warning("chaos: FaultPlan armed (%d scheduled action(s), "
                    "%.1fs)", len(plan.timeline), plan.duration)

    # introspection layer: loop-lag watchdog, status endpoint, SIGUSR2
    # flight-recorder dump, balancer stats fold (docs/observability.md)
    loop = asyncio.get_running_loop()
    watchdog = LoopLagWatchdog(collector=collector, recorder=recorder)
    watchdog.start()
    introspector = Introspector(server=server, recorder=recorder,
                                watchdog=watchdog, collector=collector,
                                name=NAME)
    introspector.set_loop(loop)
    metrics.status_source = introspector.snapshot
    recorder.install_sigusr2(
        loop, path=options.get("flightRecorderDump"))
    if balancer_socket:
        # the balancer serves its stats as a sibling socket in the same
        # directory (docs/balancer-protocol.md)
        BalancerStatsFold(collector, os.path.join(
            os.path.dirname(str(balancer_socket)), ".balancer.stats"),
            log=log)
    server.watchdog = watchdog          # keep handles for shutdown /
    server.introspector = introspector  # debugging sessions

    if shard_worker is not None:
        _wire_shard_worker(server, store, metrics, collector,
                           int(shard_worker), loop, log)

    log.info("done with binder init")
    server.metrics = metrics  # keep a handle for shutdown
    return server


def _wire_shard_worker(server: BinderServer, store, metrics, collector,
                       shard: int, loop, log: logging.Logger) -> None:
    """Post-start plumbing for a shard worker: switch the mutation log
    to event-loop delta reading, report hello (pid + bound ports) to
    the supervisor, start the 1 Hz stats feed, drain on SIGTERM, and
    die if the supervisor link ever drops (an orphan worker would
    serve a silently aging mirror forever — the exact failure this
    architecture exists to avoid)."""
    from binder_torch.shard import protocol

    def link_down():
        log.error("shard %d: supervisor gone; exiting", shard)
        os._exit(1)

    store.on_link_down = link_down
    verify = getattr(server, "_verify", None)
    if verify is not None:
        # replica-parity wiring: delta-frame trace contexts feed the
        # worker's propagation tracer, digest comparisons feed its
        # replica-digest counters (the supervisor counts its own half)
        store.tracer = verify.tracer
        store.on_digest = verify.note_digest
    store.start(loop)
    store.send(protocol.hello_frame(
        shard, os.getpid(), server.udp_port, server.tcp_port,
        metrics.port))
    requests = collector.counter("binder_requests_completed")
    frames = collector.counter(
        "binder_replica_frames_applied_total",
        "mutation-log frames (deltas, digests, session state) the "
        "replica applied").labelled()
    frames_folded = [0]
    fold_lock = threading.Lock()

    def fold_frames():
        # scrapes run on the metrics server's threads
        with fold_lock:
            n = store.frames_applied
            frames.inc(n - frames_folded[0])
            frames_folded[0] = n

    collector.on_expose(fold_frames)
    act_stats = ACCOUNT.activity("stats")

    async def stats_loop():
        while True:
            await asyncio.sleep(1.0)
            ACCOUNT.begin(act_stats)
            try:
                collector.fold()   # natively counted serves included
                rrl = getattr(server, "_rrl", None)
                store.send(protocol.stats_frame(
                    requests.total(), server.zk_cache.gen,
                    server.zk_cache.epoch, server.zk_cache.is_ready(),
                    len(server.engine.inflight),
                    rrl_dropped=(rrl.dropped if rrl is not None else 0)))
            except Exception:
                log.exception("shard stats report failed")
            finally:
                ACCOUNT.end()

    server._shard_stats_task = loop.create_task(stats_loop())

    def on_sigterm():
        log.info("shard %d: caught SIGTERM; draining", shard)

        async def _drain():
            # rolling-drain semantics (docs/operations.md "Rolling
            # upgrade"): leave the reuseport group and serve out the
            # in-flight queries BEFORE tearing the serve stack down —
            # stop() cancels whatever quiesce could not finish
            try:
                pending = await server.engine.quiesce()
                if pending:
                    log.warning("shard %d: %d in-flight quer(ies) "
                                "unfinished at the drain deadline",
                                shard, pending)
                else:
                    log.info("shard %d: quiesced clean (in-flight "
                             "served out)", shard)
            except Exception:
                log.exception("shard %d: quiesce failed", shard)
            await server.stop()
            metrics.stop()
            os._exit(0)

        loop.create_task(_drain())

    loop.add_signal_handler(signal.SIGTERM, on_sigterm)


def main(argv=None) -> None:
    try:
        options = parse_options(argv)
    except ConfigError as e:
        print(e, file=sys.stderr)
        sys.exit(1)

    async def _run():
        await run(options)
        await asyncio.Event().wait()  # serve forever

    # the loop accounts its own wait in its selector too
    # (docs/observability.md "Loop accounting")
    try:
        asyncio.run(_run(), loop_factory=ACCOUNT.loop)
    except KeyboardInterrupt:
        pass
    except ConfigError as e:
        print(e, file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
