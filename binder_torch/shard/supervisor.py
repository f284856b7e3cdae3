"""ShardSupervisor: one mirror owner fanning out to N serving shards.

The reference's entire scaling story is N identical single-threaded
processes behind a balancer (PAPER.md L1); ZDNS (arXiv:2309.13495)
makes the same shared-nothing argument for DNS throughput.  This is the
rebuild's version of that story with two deliberate twists:

- **Kernel-balanced sockets.**  Every worker binds the SAME UDP+TCP
  port with ``SO_REUSEPORT``; the kernel's 4-tuple hash spreads
  clients across shards with zero balancer hops on the hot path.  A
  dead worker's socket leaves the reuseport group at once, so its
  share re-hashes to the survivors while the supervisor respawns it.
- **One mirror owner.**  Only the supervisor holds the ZK session and
  the store mirror, no matter how many shards serve — N shards never
  multiply the watch load on the ensemble.  Mutations fan out over a
  per-shard UNIX socketpair mutation log (``shard/protocol.py``):
  snapshot + replay on attach, per-name deltas from the owner
  MirrorCache's invalidation events afterwards.  Each worker's
  precompiler re-renders from that same delta feed, so shard answers
  stay byte-identical (modulo ID/rotation) to the single-process path.
- **The group joins its port with the tree mirrored.**  At boot the
  supervisor holds the first spawn while the owner mirror's first walk
  is in flight, as a balancer backend joins its balancer only once
  synced: every worker then attaches with the whole tree in one
  snapshot, read before its serve stack exists, instead of replaying
  the walk as per-name deltas, and the public port never answers from
  a half-walked mirror.  The hold ends as soon as the store reports no
  walk coming (its first connection attempt ended without a session,
  or the session dropped mid-walk): the group then serves what the
  mirror holds, SERVFAIL from an empty one.  What ended it is counted
  in ``binder_shard_boot_attach_total{after}``, and how long it took
  is the ``hold`` boot phase.

The supervisor also owns the operational surface: it respawns crashed
shards (exponential backoff, snapshot catch-up), drains on SIGTERM
(TERM to workers, bounded wait, KILL stragglers — no orphan PIDs), and
aggregates ``/status`` + Prometheus metrics across shards (the
``binder_shard_*`` family, one ``shard`` label per series; each
worker's own metrics endpoint stays reachable for drill-down — its
port is in the supervisor snapshot).

Zero-downtime rolling operations (SIGHUP / ``roll_all``,
docs/operations.md "Rolling upgrade / config reload"): one shard at a
time, spawn the replacement worker, stream it the attach snapshot,
wait for it to converge (hello + replica ready) and join the
``SO_REUSEPORT`` group — at which point the kernel already splits
load across old AND new — then SIGTERM the old incarnation, which
quiesces (stops accepting, serves out in-flight) and exits.  A
replacement that fails to converge aborts the roll with the old
worker still serving; no client ever sees an empty group.  Config
reload rides the same cycle: the config file is re-read once up
front and each replacement spawns with the fresh config.
"""
from __future__ import annotations

import asyncio
import json
import logging
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from collections import deque
from typing import Dict, List, Optional

from binder_torch.introspect.loopacct import ACCOUNT
from binder_torch.introspect.status import Introspector
from binder_torch.shard import protocol
from binder_torch.verify.tracer import PropagationTracer, trace_id

#: a worker whose stats are older than this is reported down
#: (binder_shard_up 0) even if its PID still exists
STALE_REPORT_S = 5.0

#: respawn backoff: 0.25 * 2^consecutive_failures, capped
RESPAWN_BACKOFF_MAX_S = 5.0

#: per-link outbound cap: a worker that stops draining its mutation
#: log this far behind is wedged — kill it and let snapshot catch-up
#: do its job (bounded memory beats an unbounded replay queue)
MAX_LINK_BUFFER = 256 << 20

#: rolling upgrade: a replacement worker must hello AND report a
#: ready replica within this window, else the step aborts with the
#: old worker still serving
ROLL_CONVERGE_S = 30.0
#: bounded graceful-drain window for the outgoing incarnation (it
#: quiesces and exits on SIGTERM; stragglers are KILLed)
ROLL_DRAIN_S = 10.0

SUPERVISOR_SNAPSHOT_VERSION = 1

#: how often the boot watch looks whether the owner mirror holds the
#: tree (the end of the ``walk`` boot phase and of the spawn hold)
WALK_POLL_S = 0.02

#: what ends the group's boot hold (``binder_shard_boot_attach_total``'s
#: ``after`` label): the owner mirror's first walk done, the store's
#: first connection attempt ended without a session, or the session
#: lost mid-walk
BOOT_ATTACH = ("walk", "no-session", "session-lost")

#: loop-accounting activities (introspect/loopacct.py) of this module
_ACT_FANOUT = ACCOUNT.activity("fanout")
_ACT_ENCODE = ACCOUNT.activity("fanout.encode")
_ACT_DIGEST = ACCOUNT.activity("fanout.digest")
_ACT_FLUSH = ACCOUNT.activity("fanout.flush")
_ACT_TICK = ACCOUNT.activity("tick")
_ACT_SNAPSHOT = ACCOUNT.activity("boot.snapshot")


class ShardLink:
    """Supervisor-side state for one worker incarnation."""

    __slots__ = ("shard", "proc", "sock", "wbuf", "writer_armed",
                 "hello", "stats", "stats_at", "last_requests",
                 "last_rrl_dropped",
                 "spawned_mono", "rbuf", "closed",
                 "snap_queue", "snap_sent", "snap_started",
                 "snap_t0", "snap_cpu_ns", "snap_tail",
                 "dg", "skew_pending")

    def __init__(self, shard: int, proc: subprocess.Popen,
                 sock: socket.socket) -> None:
        self.shard = shard
        self.proc = proc
        self.sock = sock
        self.wbuf = bytearray()
        self.rbuf = bytearray()
        self.writer_armed = False
        self.hello: Optional[dict] = None
        self.stats: Optional[dict] = None
        self.stats_at = 0.0
        # last raw requests figure this incarnation reported, for the
        # monotonic fold into binder_shard_requests across respawns
        self.last_requests = 0.0
        # same per-incarnation baseline for the hostile-traffic fold
        # (binder_shard_rrl_dropped)
        self.last_rrl_dropped = 0.0
        self.spawned_mono = time.monotonic()
        self.closed = False
        # chunked attach-time snapshot state: the walk queue of owner
        # mirror nodes still to frame (None once snap-end was sent),
        # frames sent so far, and the start instant for the stall
        # backstop
        self.snap_queue: Optional[object] = None
        self.snap_sent = 0
        self.snap_started = 0.0
        # the ``snapshot`` boot phase: its start, the CPU of its pump
        # passes, and the bytes up to snap-end still unsent (its end is
        # the last of them leaving)
        self.snap_t0 = 0.0
        self.snap_cpu_ns = 0
        self.snap_tail = 0
        # replica-parity digest: the owner-side rolling
        # digest over this link's post-snapshot delta stream (None
        # until snap-end), and the chaos `skew-replica` counter of
        # deltas to hash-but-suppress (forcing a detectable mismatch)
        self.dg: Optional[str] = None
        self.skew_pending = 0


class ShardSupervisor:
    def __init__(self, *, options: Dict[str, object], store, cache,
                 collector, recorder=None,
                 log: Optional[logging.Logger] = None,
                 name: str = "binder") -> None:
        self.options = options
        self.store = store
        self.cache = cache
        self.collector = collector
        self.recorder = recorder
        self.log = log or logging.getLogger("binder.shard")
        self.name = name
        self.n = max(1, int(options.get("shards") or 1))
        self.host = str(options.get("host", "0.0.0.0"))
        self.port = int(options.get("port", 0))
        # resolved by shard 0's hello when the configured port is 0
        self.udp_port: Optional[int] = self.port or None
        self.tcp_port: Optional[int] = None
        self.links: Dict[int, ShardLink] = {}
        # rolling upgrade state: replacement links catching up while
        # the incumbent still serves (shard -> ShardLink), the roll
        # counters, and the single-roll-at-a-time guard
        self._roll_links: Dict[int, ShardLink] = {}
        self.rolls: Dict[int, int] = {i: 0 for i in range(self.n)}
        self.roll_aborts = 0
        self._rolling_shard: Optional[int] = None
        self._roll_busy = False
        self.respawns: Dict[int, int] = {i: 0 for i in range(self.n)}
        self._consec_fail: Dict[int, int] = {i: 0 for i in range(self.n)}
        self._respawn_at: Dict[int, float] = {}
        self._requests_total: Dict[int, float] = {}
        self._hello_futs: Dict[int, asyncio.Future] = {}
        self._draining = False
        self._tick_task: Optional[asyncio.Task] = None
        # the ``walk`` boot phase: its start (the store session's first
        # establishment) and the task that sees its end
        self._walk_started: Optional[tuple] = None
        self._walk_task: Optional[asyncio.Task] = None
        self._tmpdir: Optional[str] = None
        self._cfg_path: Optional[str] = None
        self._last_state: Optional[tuple] = None
        self._rng = random.Random()
        self.started_mono = time.monotonic()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # serving-plane verification: the owner-side
        # propagation tracer (mutations are stamped here; workers
        # inherit the context from the delta frames) and the
        # supervisor half of the replica-digest invariant accounting
        self.tracer = PropagationTracer(collector=collector, log=self.log)
        cache.tracer = self.tracer
        self.digest_checks = 0
        self.digest_violations = 0
        self._m_digest_checks = collector.counter(
            "binder_verify_checks_total",
            "serving-plane invariant checks evaluated").labelled(
                {"invariant": "replica-digest"})
        self._m_digest_violations = collector.counter(
            "binder_verify_violations_total",
            "serving-plane invariant violations detected").labelled(
                {"invariant": "replica-digest"})
        self._m_digest_checks.inc(0)
        self._m_digest_violations.inc(0)
        self._register_metrics()
        # the owner mirror's per-name invalidation events ARE the
        # mutation log: every tag maps to a node upsert or removal
        cache.on_invalidate(self._on_invalidate)
        getattr(store, "on_session", lambda cb: None)(
            self._on_session_start)
        # federation membership rides the same log: the
        # owner watches /dcs exactly like DcRegistry does and fans
        # join/leave through as raw-path frames, so shard workers track
        # membership LIVE instead of bootstrapping from static config
        fed = options.get("federation") or {}
        self._dcs_path = "/" + str(
            fed.get("dcsPath", "/dcs")).strip("/")
        self._dcs_records: Dict[str, object] = {}
        self._dcs_watched: set = set()
        try:
            store.watcher(self._dcs_path).on(
                "children", self._on_dcs_children)
            store.on_session(self._resync_dcs)
        except Exception:
            self.log.debug("store has no watcher surface; "
                           "/dcs fanout off")

    # -- metrics: the binder_shard_* family (docs/observability.md) --

    def _register_metrics(self) -> None:
        c = self.collector
        c.gauge("binder_shards",
                "configured shard (worker process) count"
                ).set_function(lambda: float(self.n))
        self._respawn_children = {}
        self._request_children = {}
        up = c.gauge("binder_shard_up",
                     "1 when the shard process is alive and reporting")
        pid = c.gauge("binder_shard_pid",
                      "PID of the shard's current incarnation")
        gen = c.gauge("binder_shard_generation",
                      "shard-local mirror mutation generation")
        ready = c.gauge("binder_shard_ready",
                        "1 when the shard's replica mirror is ready")
        respawns = c.counter("binder_shard_respawns",
                             "times the supervisor respawned a crashed "
                             "shard")
        requests = c.counter("binder_shard_requests",
                             "requests completed per shard (folded "
                             "monotonically across respawns)")
        rrl_drops = c.counter("binder_shard_rrl_dropped",
                              "response-rate-limit drops per shard "
                              "(folded monotonically across respawns)")
        self._m_fanout_events = c.counter(
            "binder_shard_fanout_events_total",
            "owner-mirror store events fanned out to the workers as "
            "delta frames").labelled()
        self._m_fanout_events.inc(0)
        boot_attach = c.counter(
            "binder_shard_boot_attach_total",
            "group boots by what ended the hold on the first worker "
            "spawn (walk: the owner mirror holds the tree; no-session, "
            "session-lost: the store reported no walk coming)")
        self._m_boot_attach = {}
        for after in BOOT_ATTACH:
            self._m_boot_attach[after] = boot_attach.labelled(
                {"after": after})
            self._m_boot_attach[after].inc(0)
        rolls = c.counter("binder_shard_rolls_total",
                          "completed zero-downtime drain-and-replace "
                          "cycles per shard (rolling upgrade / config "
                          "reload)")
        self._m_roll_aborts = c.counter(
            "binder_shard_roll_aborts_total",
            "rolling-upgrade steps aborted because the replacement "
            "failed to converge (the old worker kept serving)"
        ).labelled()
        self._m_roll_aborts.inc(0)
        self._rrl_drop_children = {}
        self._roll_children = {}
        for i in range(self.n):
            labels = {"shard": str(i)}
            up.set_function(lambda i=i: self._up(i), labels)
            pid.set_function(lambda i=i: float(self._pid(i) or 0),
                             labels)
            gen.set_function(lambda i=i: self._stat(i, "gen"), labels)
            ready.set_function(lambda i=i: self._stat(i, "ready"),
                               labels)
            rc = respawns.labelled(labels)
            rc.inc(0)
            self._respawn_children[i] = rc
            qc = requests.labelled(labels)
            qc.inc(0)
            self._request_children[i] = qc
            dc = rrl_drops.labelled(labels)
            dc.inc(0)
            self._rrl_drop_children[i] = dc
            rlc = rolls.labelled(labels)
            rlc.inc(0)
            self._roll_children[i] = rlc

    def _up(self, i: int) -> float:
        link = self.links.get(i)
        if link is None or link.proc.poll() is not None:
            return 0.0
        if link.hello is None:
            return 0.0
        if time.monotonic() - link.stats_at > STALE_REPORT_S \
                and link.stats is not None:
            return 0.0
        return 1.0

    def _pid(self, i: int) -> Optional[int]:
        link = self.links.get(i)
        return None if link is None else link.proc.pid

    def _stat(self, i: int, key: str) -> float:
        link = self.links.get(i)
        if link is None or link.stats is None:
            return 0.0
        return float(link.stats.get(key) or 0)

    # -- lifecycle --

    async def start(self) -> None:
        """Hold the first spawn through the owner mirror's first walk
        (:meth:`_hold`), then spawn shard 0 first (it resolves an
        ephemeral port draw for the whole reuseport group), then the
        rest concurrently."""
        self._loop = asyncio.get_running_loop()
        self._walk_task = self._loop.create_task(self._watch_walk())
        held = ACCOUNT.phase_start()
        after = await self._hold()
        ACCOUNT.phase_end("hold", held)
        self._m_boot_attach[after].inc()
        self.log.info("boot hold ended (%s): owner mirror at %d name(s); "
                      "spawning %d shard(s)", after, len(self.cache.nodes),
                      self.n)
        self._tmpdir = tempfile.mkdtemp(prefix="binder-shards-")
        self._spawn(0, self.port)
        hello = await self._wait_hello(0)
        self.udp_port = int(hello["udp_port"])
        self.tcp_port = int(hello["tcp_port"])
        for i in range(1, self.n):
            self._spawn(i, self.udp_port)
        if self.n > 1:
            await asyncio.gather(*[self._wait_hello(i)
                                   for i in range(1, self.n)])
        self._tick_task = self._loop.create_task(self._tick_loop())
        self.log.info("all %d shard(s) serving (pids %s)", self.n,
                      ",".join(str(self._pid(i)) for i in
                               range(self.n)))
        # the canonical "service started" lines, printed ONCE the whole
        # group is up — launchers key on these exact formats, and a
        # worker's own announce would advertise a group still forming
        self.log.info("UDP DNS service started on %s:%d", self.host,
                      self.udp_port)
        self.log.info("TCP DNS service started on %s:%d", self.host,
                      self.tcp_port)

    def _on_session_start(self) -> None:
        if self._walk_started is None:
            self._walk_started = ACCOUNT.phase_start()

    async def _hold(self) -> str:
        """Wait while the owner mirror's first walk is in flight; return
        what ended the wait (one of :data:`BOOT_ATTACH`).  Until a
        worker exists no link takes a delta, so the walk fans nothing
        out, and each worker's attach snapshot carries the whole tree.
        No walk is coming once the store's first connection attempt
        has ended without a session, or once the session it walked
        under is gone: the group then boots at once, as it always did."""
        while True:
            state = self._state_tuple()[0]
            if state == "connected":
                if self._walk_task.done():
                    return "walk"
            elif state != "never-connected":
                return "session-lost"
            elif not self.store.connecting():
                return "no-session"
            await asyncio.sleep(WALK_POLL_S)

    async def _watch_walk(self) -> None:
        """The ``walk`` boot phase: from the store session's first
        establishment to the owner mirror holding the store's tree."""
        while self._walk_started is None or not self.cache.synced():
            await asyncio.sleep(WALK_POLL_S)
        ACCOUNT.phase_end("walk", self._walk_started)

    async def _wait_hello(self, i: int, timeout: float = 30.0,
                          link: Optional[ShardLink] = None) -> dict:
        link = self.links[i] if link is None else link
        if link.hello is not None:
            return link.hello
        fut = self._loop.create_future()
        self._hello_futs[i] = fut
        try:
            return await asyncio.wait_for(fut, timeout)
        finally:
            self._hello_futs.pop(i, None)

    def _worker_config(self, port: int) -> str:
        """Write the resolved worker config once per port draw.  The
        store block is STRIPPED — a worker must never open its own
        store session (that is the whole point of the owner) — and so
        are the supervisor-only knobs."""
        if self._cfg_path is not None:
            return self._cfg_path
        opts = {k: v for k, v in self.options.items()
                if k not in ("shards", "chaos", "store",
                             "balancerSocket", "configFile",
                             "shardWorker")}
        opts["port"] = port
        path = os.path.join(self._tmpdir, "worker-config.json")
        with open(path, "w") as f:
            json.dump(opts, f)
        if port:
            self._cfg_path = path
        return path

    def _spawn(self, i: int, port: int) -> None:
        self.links[i] = self._spawn_link(i, port)

    def _spawn_link(self, i: int, port: int,
                    role: str = "serving") -> ShardLink:
        """Create one worker incarnation WITHOUT installing it as the
        shard's serving link — the rolling upgrade spawns replacements
        that catch up next to the incumbent before promotion."""
        parent, child = socket.socketpair(socket.AF_UNIX,
                                          socket.SOCK_STREAM)
        argv = [sys.executable, "-u", "-m", "binder_torch.main",
                "-f", self._worker_config(port),
                "--shard-worker", str(i)]
        env = dict(os.environ)
        env[protocol.SHARD_FD_ENV] = str(child.fileno())
        env[protocol.SHARD_SPAWNED_ENV] = repr(time.monotonic())
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        try:
            proc = subprocess.Popen(argv, pass_fds=(child.fileno(),),
                                    env=env)
        finally:
            child.close()
        parent.setblocking(False)
        link = ShardLink(i, proc, parent)
        self._loop.add_reader(parent.fileno(), ACCOUNT.wrap(
            "link-read", self._on_worker_readable), link)
        # attach-time snapshot: the worker replays this, then the
        # delta feed continues seamlessly on the same ordered stream
        self._send_snapshot(link)
        self.log.info("shard %d %s spawned (pid %d)", i, role, proc.pid)
        if self.recorder is not None:
            self.recorder.record("shard-spawn", shard=i, pid=proc.pid,
                                 respawns=self.respawns[i], role=role)
        return link

    # -- federation /dcs fanout --

    def _resync_dcs(self) -> None:
        """Session (re-)establishment: pull current /dcs state when
        the store reads synchronously (FakeStore family); real
        ZooKeeper re-delivers through the re-registered watches."""
        import inspect
        get_children = getattr(self.store, "get_children", None)
        get_data = getattr(self.store, "get_data", None)
        if (not callable(get_children) or not callable(get_data)
                or inspect.iscoroutinefunction(get_children)):
            return
        kids = get_children(self._dcs_path)
        if kids is None:
            return
        self._on_dcs_children(kids)
        for k in kids:
            data = get_data(self._dcs_path + "/" + k)
            if data is not None:
                self._on_dcs_data(k, data)

    def _on_dcs_children(self, kids) -> None:
        names = set(kids or [])
        for k in sorted(names - self._dcs_watched):
            self._dcs_watched.add(k)
            # the data watcher delivers the child's current record
            # synchronously on attach (fake store) — dc data flows
            # from _on_dcs_data either way
            self.store.watcher(self._dcs_path + "/" + k).on(
                "data", lambda data, _k=k: self._on_dcs_data(_k, data))
        for k in sorted(self._dcs_watched - names):
            self._dcs_watched.discard(k)
            if k in self._dcs_records:
                del self._dcs_records[k]
                self._dcs_fanout(protocol.path_gone_frame(
                    self._dcs_path + "/" + k))

    def _on_dcs_data(self, dc: str, data) -> None:
        try:
            obj = (json.loads(bytes(data).decode("utf-8"))
                   if data else None)
        except (ValueError, UnicodeDecodeError):
            obj = None
        if self._dcs_records.get(dc) == obj and dc in self._dcs_records:
            return
        self._dcs_records[dc] = obj
        self._dcs_fanout(protocol.path_node_frame(
            self._dcs_path + "/" + dc, obj))

    def _dcs_fanout(self, frame: dict) -> None:
        # _send, NOT _send_delta: raw-path frames stay outside the
        # replica-parity digest (it pins zone data only)
        for link in self._fanout_links():
            self._send(link, frame)

    # -- mutation-log fanout --

    def _state_tuple(self) -> tuple:
        st = self.store
        state = getattr(st, "session_state",
                        lambda: "connected" if st.is_connected()
                        else "never-connected")()
        disc = getattr(st, "disconnected_seconds", lambda: None)()
        est = getattr(st, "session_establishments", 0)
        return (state, bool(st.is_connected()), disc, est)

    def _state_frame(self) -> dict:
        state, connected, disc, est = self._state_tuple()
        return protocol.state_frame(state, connected, disc, est)

    #: node frames per snapshot pump pass (one event-loop callback);
    #: bounds the time the supervisor loop spends framing before it
    #: yields back to heartbeats, stats folding, and the other links
    SNAP_CHUNK = 2048
    #: outbound high-water during a snapshot: the pump pauses above
    #: this and resumes from the writability callback, so a large-zone
    #: snapshot streams at the worker's pace instead of materializing
    #: the whole mirror in the link buffer (the old eager build put a
    #: million-name snapshot straight into wbuf — nearly the wedge-kill
    #: cap — while blocking the loop for the entire walk)
    SNAP_HIGH_WATER = 4 << 20
    #: a snapshot making no progress for this long means a wedged
    #: worker; kill for respawn (snapshot catch-up IS the recovery)
    SNAP_STALL_S = 120.0

    def _send_snapshot(self, link: ShardLink) -> None:
        """Start the CHUNKED attach-time snapshot: a state frame now,
        then node frames streamed in bounded pump passes (tree order —
        parents before children — via a breadth-first walk of the owner
        mirror), then snap-end.  Deltas and state heartbeats produced
        while the snapshot streams simply interleave into the same
        ordered stream: node frames are upserts read from live mirror
        state, so replaying them in any interleaving converges the
        worker to the owner's view."""
        self._send(link, self._state_frame())
        # current federation membership first: the
        # worker's DcRegistry is live from the instant it attaches
        for dc in sorted(self._dcs_records):
            self._send(link, protocol.path_node_frame(
                self._dcs_path + "/" + dc, self._dcs_records[dc]))
        link.snap_queue = deque()
        link.snap_sent = 0
        link.snap_started = link.snap_t0 = time.monotonic()
        link.snap_cpu_ns = 0
        root = self.cache.nodes.get(self.cache.domain)
        if root is not None:
            link.snap_queue.append(root)
        self._pump_snapshot(link)

    def _pump_snapshot(self, link: ShardLink) -> None:
        ACCOUNT.begin(_ACT_SNAPSHOT)
        try:
            self._pump_snapshot_pass(link)
        finally:
            link.snap_cpu_ns += ACCOUNT.end()

    def _pump_snapshot_pass(self, link: ShardLink) -> None:
        q = link.snap_queue
        if link.closed or q is None:
            return
        nodes = self.cache.nodes
        n = 0
        while q and n < self.SNAP_CHUNK \
                and len(link.wbuf) < self.SNAP_HIGH_WATER:
            node = q.popleft()
            if nodes.get(node.domain) is not node:
                continue                # subtree left the mirror mid-walk
            for kid in node.children:
                q.append(kid)
            link.wbuf.extend(protocol.encode_frame(
                protocol.node_frame(node.domain, node.data)))
            link.snap_sent += 1
            n += 1
        if n:
            link.snap_started = time.monotonic()   # progress
        self._flush(link)
        if link.closed or link.snap_queue is None:
            return                      # flush may have severed the link
        if q:
            if len(link.wbuf) >= self.SNAP_HIGH_WATER:
                return      # paused: _on_worker_writable resumes the pump
            self._loop.call_soon(self._pump_snapshot, link)
            return
        link.snap_queue = None
        # arm the per-link replica-parity digest at the same stream
        # point the replica does (receiving snap-end): deltas that
        # interleaved with the snapshot stayed unhashed on both ends
        link.dg = "0"
        self._send(link, protocol.snap_end_frame(link.snap_sent))
        link.snap_tail = len(link.wbuf)
        if not link.snap_tail:
            self._snapshot_sent(link)

    def _snapshot_sent(self, link: ShardLink) -> None:
        """The ``snapshot`` boot phase of ``link`` ended: its snap-end
        frame's last byte left for the worker."""
        link.snap_tail = 0
        ACCOUNT.boot_phase("snapshot", link.snap_t0, time.monotonic(),
                           link.snap_cpu_ns / 1e9, shard=link.shard)

    def _on_invalidate(self, tags) -> None:
        """Owner-mirror invalidation -> delta frames.  Tags are lookup
        domains and PTR qnames; only forward names under the served
        domain map to mirrored nodes (workers rebuild their own
        reverse index from node data)."""
        if not self.links and not self._roll_links:
            return
        ACCOUNT.begin(_ACT_FANOUT)
        try:
            self._fanout(tags)
        finally:
            ACCOUNT.end(lambda: trace_id(self.tracer))

    def _fanout(self, tags) -> None:
        domain = self.cache.domain
        suffix = "." + domain
        # propagation trace context: stamped by the owner mirror's
        # bump_gen; the delta frames carry it so the workers' stages
        # report against the owner's t0
        ctx = self.tracer.current
        tr, t0 = ctx if ctx is not None else (None, None)
        frames = []
        for tag in tags:
            if tag != domain and not tag.endswith(suffix):
                continue
            node = self.cache.lookup(tag)
            frames.append(protocol.node_frame(tag, node.data, tr, t0)
                          if node is not None
                          else protocol.gone_frame(tag, tr, t0))
        if not frames:
            return
        self._m_fanout_events.inc()
        gen = self.cache.gen
        for link in self._fanout_links():
            for frame in frames:
                self._send_delta(link, frame)
            # one digest frame per delta batch: the replica compares
            # its roll against the owner's (replica-digest invariant)
            if not link.closed and link.dg is not None:
                self.digest_checks += 1
                self._m_digest_checks.inc()
                self._send(link, protocol.digest_frame(gen, link.dg))
        self.tracer.observe("shard-frame", ctx)

    def _send_delta(self, link: ShardLink, frame: dict) -> None:
        """One mutation-log delta: roll the link's parity digest, then
        send — unless a chaos ``skew-replica`` armed suppression, in
        which case the digest rolls WITHOUT the send (the replica must
        flag the divergence at the next digest frame)."""
        if link.dg is not None:
            ACCOUNT.begin(_ACT_DIGEST)
            try:
                link.dg = protocol.delta_digest(link.dg, frame)
            finally:
                ACCOUNT.end()
            if link.skew_pending > 0:
                link.skew_pending -= 1
                self.log.warning(
                    "shard %d: suppressing one delta frame "
                    "(chaos skew-replica)", link.shard)
                return
        self._send(link, frame)

    def skew_replica(self, shard: int = -1,
                     frames: int = 1) -> Optional[int]:
        """Chaos ``skew-replica``: suppress the next *frames* delta
        frames to one worker while still folding them into the owner's
        digest roll — the replica-digest invariant must catch the
        divergence within one mutation cycle.  ``shard=-1`` picks a
        live digest-armed link at random; returns the skewed shard (or
        None when no link is eligible)."""
        candidates = [lk for lk in self.links.values()
                      if not lk.closed and lk.dg is not None]
        if not candidates:
            return None
        if shard < 0:
            link = self._rng.choice(candidates)
        else:
            link = self.links.get(shard)
            if link is None or link.closed or link.dg is None:
                return None
        link.skew_pending += max(1, int(frames))
        return link.shard

    def _fanout_links(self) -> List[ShardLink]:
        """Every link the mutation log must reach: the serving set
        plus replacements catching up mid-roll (a replacement that
        missed deltas between its snapshot and promotion would serve
        an aging mirror the moment it binds the reuseport group)."""
        links = list(self.links.values())
        if self._roll_links:
            links.extend(self._roll_links.values())
        return links

    def _kill_link(self, link: ShardLink) -> None:
        """Link-scoped wedge recovery: sever the stream and SIGKILL
        THIS incarnation (``kill_shard`` is index-keyed and would hit
        the serving link — wrong answer for a mid-roll replacement)."""
        self._close_link(link)
        if link.proc.poll() is None:
            try:
                link.proc.kill()
            except (ProcessLookupError, OSError):
                pass

    def _send(self, link: ShardLink, frame: dict) -> None:
        if link.closed:
            return
        ACCOUNT.begin(_ACT_ENCODE)
        try:
            link.wbuf.extend(protocol.encode_frame(frame))
        finally:
            ACCOUNT.end()
        if len(link.wbuf) > MAX_LINK_BUFFER:
            # a worker this far behind on its mutation log is wedged;
            # snapshot catch-up on respawn is the bounded recovery
            self.log.error("shard %d: mutation log %d bytes behind; "
                           "killing for respawn", link.shard,
                           len(link.wbuf))
            self._kill_link(link)
            return
        self._flush(link)

    def _flush(self, link: ShardLink) -> None:
        if link.closed or not link.wbuf:
            return
        ACCOUNT.begin(_ACT_FLUSH)
        try:
            sent = link.sock.send(bytes(link.wbuf))
            del link.wbuf[:sent]
        except (BlockingIOError, InterruptedError):
            sent = 0
        except OSError:
            # worker died mid-write; the tick loop reaps and respawns
            self._close_link(link)
            return
        finally:
            ACCOUNT.end()
        if link.snap_tail > 0:
            link.snap_tail -= sent
            if link.snap_tail <= 0:
                self._snapshot_sent(link)
        if link.wbuf and not link.writer_armed:
            link.writer_armed = True
            self._loop.add_writer(link.sock.fileno(),
                                  self._on_worker_writable, link)

    def _on_worker_writable(self, link: ShardLink) -> None:
        try:
            self._loop.remove_writer(link.sock.fileno())
        except (OSError, ValueError):
            pass
        link.writer_armed = False
        self._flush(link)
        # a paused snapshot resumes once the worker drained us below
        # the high-water mark
        if (link.snap_queue is not None and not link.closed
                and len(link.wbuf) < self.SNAP_HIGH_WATER):
            self._pump_snapshot(link)

    # -- worker -> supervisor frames --

    def _on_worker_readable(self, link: ShardLink) -> None:
        try:
            chunk = link.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._sever(link)
            return
        if not chunk:
            self._sever(link)
            return
        link.rbuf.extend(chunk)
        try:
            frames = protocol.decode_frames(link.rbuf)
        except ValueError:
            self.log.error("shard %d: corrupt worker stream; killing",
                           link.shard)
            self._kill_link(link)
            return
        for frame in frames:
            op = frame.get("op")
            if op == "hello":
                link.hello = frame
                self._consec_fail[link.shard] = 0
                self.log.info(
                    "shard %d serving: pid %d udp %s tcp %s metrics %s",
                    link.shard, frame.get("pid"), frame.get("udp_port"),
                    frame.get("tcp_port"), frame.get("metrics_port"))
                fut = self._hello_futs.get(link.shard)
                if fut is not None and not fut.done():
                    fut.set_result(frame)
            elif op == "stats":
                self._fold_stats(link, frame)
            elif op == "digest-report":
                self._on_digest_report(link, frame)

    def _on_digest_report(self, link: ShardLink, frame: dict) -> None:
        """A replica flagged a mutation-log digest mismatch: count the
        replica-digest violation and keep the evidence (the replica
        already resynced its roll; operators decide whether to recycle
        the shard — see docs/operations.md)."""
        if frame.get("ok"):
            return
        self.digest_violations += 1
        self._m_digest_violations.inc()
        self.log.error(
            "shard %d: replica digest mismatch at gen %s "
            "(have %s want %s)", link.shard, frame.get("gen"),
            frame.get("have"), frame.get("want"))
        if self.recorder is not None:
            self.recorder.record(
                "verify-violation", invariant="replica-digest",
                shard=link.shard, generation=frame.get("gen"),
                have=frame.get("have"), want=frame.get("want"))

    def _fold_stats(self, link: ShardLink, frame: dict) -> None:
        link.stats = frame
        link.stats_at = time.monotonic()
        req = float(frame.get("requests") or 0.0)
        # monotonic fold: a respawned incarnation restarts its counter
        # at 0, so deltas are per-incarnation
        delta = req - link.last_requests
        if delta < 0:
            delta = req
        link.last_requests = req
        if delta > 0:
            self._request_children[link.shard].inc(delta)
            self._requests_total[link.shard] = \
                self._requests_total.get(link.shard, 0.0) + delta
        val = float(frame.get("rrl_dropped") or 0.0)
        d = val - link.last_rrl_dropped
        if d < 0:
            d = val
        link.last_rrl_dropped = val
        if d > 0:
            self._rrl_drop_children[link.shard].inc(d)

    def _sever(self, link: ShardLink) -> None:
        """A dead mutation log means a dead shard: a worker that lost
        its feed can only serve an aging mirror, so force the exit the
        tick loop's respawn path expects."""
        self._close_link(link)
        if link.proc.poll() is None:
            try:
                link.proc.terminate()
            except (ProcessLookupError, OSError):
                pass

    def _close_link(self, link: ShardLink) -> None:
        if link.closed:
            return
        link.closed = True
        link.snap_queue = None
        try:
            self._loop.remove_reader(link.sock.fileno())
        except (OSError, ValueError):
            pass
        if link.writer_armed:
            try:
                self._loop.remove_writer(link.sock.fileno())
            except (OSError, ValueError):
                pass
        try:
            link.sock.close()
        except OSError:
            pass

    # -- crash handling / heartbeat tick --

    async def _tick_loop(self) -> None:
        while not self._draining:
            await asyncio.sleep(0.5)
            ACCOUNT.begin(_ACT_TICK)
            try:
                self._tick()
            except Exception:
                self.log.exception("shard supervisor tick failed")
            finally:
                ACCOUNT.end()

    def _tick(self) -> None:
        # session-state heartbeat (edge-triggered + periodic): workers'
        # degradation policies age on the owner's measured clock
        state = self._state_tuple()
        frame = protocol.state_frame(*state)
        for link in self._fanout_links():
            self._send(link, frame)
        self._last_state = state
        if self._draining:
            return
        now = time.monotonic()
        # snapshot stall backstop: a worker that stopped draining its
        # attach snapshot is wedged — kill it and let respawn + a fresh
        # snapshot do its job
        for link in self._fanout_links():
            if (link.snap_queue is not None and not link.closed
                    and now - link.snap_started > self.SNAP_STALL_S):
                self.log.error("shard %d: snapshot stalled %.0fs; "
                               "killing for respawn", link.shard,
                               now - link.snap_started)
                self._kill_link(link)
        for i in range(self.n):
            if i in self._roll_links:
                # the roll cycle owns this shard's lifecycle: the
                # incumbent may exit (drain) or the replacement may
                # die (abort) without the respawn path interfering
                continue
            link = self.links.get(i)
            if link is not None and link.proc.poll() is None:
                continue
            if link is not None:
                # reap + schedule the respawn with backoff
                rc = link.proc.poll()
                self._close_link(link)
                del self.links[i]
                self.respawns[i] += 1
                self._respawn_children[i].inc()
                self._consec_fail[i] += 1
                backoff = min(RESPAWN_BACKOFF_MAX_S,
                              0.25 * (2 ** (self._consec_fail[i] - 1)))
                self._respawn_at[i] = now + backoff
                self.log.warning(
                    "shard %d (pid %d) exited rc=%s; respawning in "
                    "%.2fs (respawn #%d)", i, link.proc.pid, rc,
                    backoff, self.respawns[i])
                if self.recorder is not None:
                    self.recorder.record("shard-exit", shard=i,
                                         pid=link.proc.pid, rc=rc,
                                         respawns=self.respawns[i])
                continue
            if now >= self._respawn_at.get(i, 0.0) \
                    and self.udp_port is not None:
                self._spawn(i, self.udp_port)

    def kill_shard(self, shard: int = -1,
                   sig: int = signal.SIGKILL) -> Optional[int]:
        """Kill one worker (chaos ``shard-kill``, wedged-link
        recovery).  ``shard=-1`` picks a live one at random.  Returns
        the killed PID (None when nothing was killable)."""
        candidates = [lk for lk in self.links.values()
                      if lk.proc.poll() is None]
        if not candidates:
            return None
        if shard < 0:
            link = self._rng.choice(candidates)
        else:
            link = self.links.get(shard)
            if link is None or link.proc.poll() is not None:
                return None
        pid = link.proc.pid
        try:
            link.proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            return None
        self.log.warning("shard %d: sent signal %d to pid %d",
                         link.shard, sig, pid)
        return pid

    # -- zero-downtime rolling operations (SIGHUP / chaos worker-roll) --

    def request_roll(self, reload_config: bool = False,
                     shard: int = -1) -> Optional[asyncio.Task]:
        """Sync entry point (signal handler, chaos driver): schedule a
        roll of one shard (``shard >= 0``) or the whole group.  A roll
        already in progress absorbs the request — two interleaved
        rolls would race promotions for the same shard slot.  Busy is
        marked HERE, synchronously: a double SIGHUP arrives before the
        scheduled coroutine gets its first tick."""
        if self._roll_busy or self._draining or self._loop is None:
            self.log.warning("rolling upgrade already in progress or "
                             "draining; request ignored")
            return None
        self._roll_busy = True
        if shard >= 0:
            return self._loop.create_task(self._roll_one(shard))
        return self._loop.create_task(
            self.roll_all(reload_config=reload_config))

    async def _roll_one(self, shard: int) -> bool:
        self._roll_busy = True
        try:
            return await self.roll_shard(shard)
        finally:
            self._roll_busy = False

    async def roll_all(self, reload_config: bool = False) -> bool:
        """The zero-downtime rolling operation: one shard at a time —
        spawn replacement, snapshot catch-up, reuseport join, drain
        the incumbent — stopping at the FIRST failed step (a bad
        config or build aborts with every remaining shard untouched
        and still serving)."""
        self._roll_busy = True
        try:
            if reload_config:
                self._reload_options()
            for i in range(self.n):
                if self._draining:
                    return False
                if not await self.roll_shard(i):
                    self.log.error(
                        "rolling upgrade stopped at shard %d; %d "
                        "shard(s) still on the previous incarnation",
                        i, self.n - i)
                    return False
            self.log.info("rolling upgrade complete (%d shard(s))",
                          self.n)
            return True
        finally:
            self._roll_busy = False

    def _reload_options(self) -> bool:
        """Config-reload half of SIGHUP: re-read the config file so
        every subsequent spawn — the roll cycle's replacements first —
        sees the fresh config.  The resolved port, host, and shard
        count are pinned: a reload must never re-draw the reuseport
        group out from under connected clients.  A malformed file
        rolls with the previous config (and says so) — the roll's
        process-replacement half still applies code updates."""
        path = self.options.get("configFile")
        if not path:
            # direct-options deployments (tests, embedding) roll the
            # processes with the current config
            self._cfg_path = None
            return False
        try:
            with open(str(path)) as f:
                fresh = json.load(f)
        except (OSError, ValueError) as e:
            self.log.error("config reload from %s failed (%s); "
                           "rolling with the previous config", path, e)
            return False
        fresh["configFile"] = path
        fresh["shards"] = self.n
        fresh["host"] = self.host
        fresh["port"] = self.port
        self.options = fresh
        self._cfg_path = None
        self.log.info("config reloaded from %s", path)
        return True

    async def roll_shard(self, i: int) -> bool:
        """One drain-and-replace step.  The incumbent keeps serving
        until the replacement has (1) replayed the attach snapshot,
        (2) reported hello — its SO_REUSEPORT sockets are bound, the
        kernel is already splitting load across both incarnations —
        and (3) reported a ready replica over the stats feed.  Only
        then does the incumbent get SIGTERM, quiesce (serve out
        in-flight), and exit.  Every phase is a ``rolling-upgrade``
        flight event; failure to converge aborts with the incumbent
        untouched."""
        if self.udp_port is None or i in self._roll_links \
                or not 0 <= i < self.n:
            return False
        old = self.links.get(i)
        old_pid = old.proc.pid if old is not None else None
        self._rolling_shard = i
        if self.recorder is not None:
            self.recorder.record("rolling-upgrade", phase="spawn",
                                 shard=i, old_pid=old_pid)
        repl = self._spawn_link(i, self.udp_port, role="replacement")
        self._roll_links[i] = repl
        try:
            reason = None
            try:
                await self._wait_hello(i, timeout=ROLL_CONVERGE_S,
                                       link=repl)
            except asyncio.TimeoutError:
                reason = f"no hello within {ROLL_CONVERGE_S:.0f}s"
            if reason is None:
                deadline = time.monotonic() + ROLL_CONVERGE_S
                while True:
                    if repl.closed or repl.proc.poll() is not None:
                        reason = "replacement died during catch-up"
                        break
                    stats = repl.stats
                    if stats is not None and stats.get("ready"):
                        break
                    if time.monotonic() >= deadline:
                        reason = ("replica not ready within "
                                  f"{ROLL_CONVERGE_S:.0f}s")
                        break
                    await asyncio.sleep(0.05)
            if reason is not None:
                self.roll_aborts += 1
                self._m_roll_aborts.inc()
                self.log.error("shard %d roll aborted: %s "
                               "(incumbent pid %s keeps serving)",
                               i, reason, old_pid)
                if self.recorder is not None:
                    self.recorder.record("rolling-upgrade",
                                         phase="abort", shard=i,
                                         reason=reason)
                self._kill_link(repl)
                try:
                    repl.proc.wait(timeout=5)
                except Exception:
                    pass
                return False
            if self.recorder is not None:
                self.recorder.record(
                    "rolling-upgrade", phase="promote", shard=i,
                    old_pid=old_pid, new_pid=repl.proc.pid,
                    snapshot_frames=repl.snap_sent)
            self.links[i] = repl
            if old is not None:
                await self._drain_incumbent(old)
            self.rolls[i] += 1
            self._roll_children[i].inc()
            self.log.info("shard %d rolled: pid %s -> %d", i, old_pid,
                          repl.proc.pid)
            if self.recorder is not None:
                self.recorder.record("rolling-upgrade", phase="done",
                                     shard=i, old_pid=old_pid,
                                     new_pid=repl.proc.pid)
            return True
        finally:
            self._roll_links.pop(i, None)
            self._rolling_shard = None

    async def _drain_incumbent(self, link: ShardLink) -> None:
        """SIGTERM the outgoing incarnation and wait bounded: the
        worker quiesces (leaves the reuseport group, serves out its
        in-flight queries) and exits clean; a straggler is KILLed at
        the deadline."""
        proc = link.proc
        if proc.poll() is None:
            try:
                proc.terminate()
            except (ProcessLookupError, OSError):
                pass
        deadline = time.monotonic() + ROLL_DRAIN_S
        while proc.poll() is None and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        if proc.poll() is None:
            self.log.warning("shard %d: outgoing pid %d ignored the "
                             "drain window; killing", link.shard,
                             proc.pid)
            try:
                proc.kill()
            except (ProcessLookupError, OSError):
                pass
        try:
            proc.wait(timeout=5)
        except Exception:
            pass
        self._close_link(link)

    async def drain(self, timeout: float = 10.0) -> None:
        """SIGTERM drain: stop respawning, TERM every worker, wait
        bounded, KILL stragglers, reap everything — no orphan PIDs."""
        self._draining = True
        if self._walk_task is not None:
            self._walk_task.cancel()
            self._walk_task = None
        if self._tick_task is not None:
            self._tick_task.cancel()
            try:
                await self._tick_task
            except asyncio.CancelledError:
                pass
            self._tick_task = None
        procs: List[subprocess.Popen] = []
        # mid-roll replacements are processes too — no orphan PIDs
        for link in self._fanout_links():
            if link.proc.poll() is None:
                try:
                    link.proc.terminate()
                except (ProcessLookupError, OSError):
                    pass
            procs.append(link.proc)
        deadline = time.monotonic() + timeout
        for proc in procs:
            while proc.poll() is None and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            if proc.poll() is None:
                self.log.warning("shard pid %d ignored SIGTERM; "
                                 "killing", proc.pid)
                try:
                    proc.kill()
                except (ProcessLookupError, OSError):
                    pass
            try:
                proc.wait(timeout=5)
            except Exception:
                pass
        # links close only AFTER the workers had their SIGTERM window:
        # closing first would race their graceful drain with the noisy
        # link-down exit path
        for link in self._fanout_links():
            self._close_link(link)
        self.links.clear()
        self._roll_links.clear()
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None
        self.log.info("shard supervisor drained (%d worker(s))",
                      len(procs))

    # -- aggregated /status (served by the supervisor metrics port) --

    def snapshot(self) -> dict:
        now = time.monotonic()
        workers = []
        for i in range(self.n):
            link = self.links.get(i)
            hello = link.hello if link is not None else None
            stats = link.stats if link is not None else None
            workers.append({
                "shard": i,
                "pid": self._pid(i),
                "alive": bool(link is not None
                              and link.proc.poll() is None),
                "up": bool(self._up(i)),
                "state": ("serving" if self._up(i) else
                          "starting" if link is not None else
                          "respawning"),
                "udp_port": hello.get("udp_port") if hello else None,
                "tcp_port": hello.get("tcp_port") if hello else None,
                "metrics_port": (hello.get("metrics_port")
                                 if hello else None),
                "respawns": self.respawns[i],
                "rolls": self.rolls[i],
                "requests": self._requests_total.get(i, 0.0),
                "generation": (stats or {}).get("gen", 0),
                "epoch": (stats or {}).get("epoch", 0),
                "ready": bool((stats or {}).get("ready")),
                "inflight": (stats or {}).get("inflight", 0),
                "last_report_age_seconds": (
                    None if link is None or not link.stats_at
                    else now - link.stats_at),
            })
        intro = Introspector(zk_cache=self.cache, store=self.store,
                             recorder=self.recorder, name=self.name)
        return {
            "service": {
                "name": self.name + "-supervisor",
                "pid": os.getpid(),
                "version": SUPERVISOR_SNAPSHOT_VERSION,
                "uptime_seconds": now - self.started_mono,
                "generated_at": time.time(),
            },
            "store": intro._store_section(),
            "mirror": intro._mirror_section(),
            "shards": {
                "count": self.n,
                "up": sum(1 for w in workers if w["up"]),
                "udp_port": self.udp_port,
                "tcp_port": self.tcp_port,
                "respawns_total": sum(self.respawns.values()),
                "rolls_total": sum(self.rolls.values()),
                "roll_aborts": self.roll_aborts,
                "rolling_shard": self._rolling_shard,
                "digest_checks": self.digest_checks,
                "digest_violations": self.digest_violations,
                "workers": workers,
            },
            "flight_recorder": intro._recorder_section(),
        }
