"""FaultPlan: a scriptable fault-injection schedule.

The degraded paths are only trustworthy if they are *tested* the way
the hot path is benched — ZDNS-style measurement discipline applied to
failure.  A :class:`FaultPlan` is a timeline of fault actions plus the
live upstream-fault state, injectable into the fake store, the ZK test
server, and the chaos upstream (``chaos/upstream.py``), and scriptable
from three places: unit tests (build it in code), the chaos phase of
``chip_smoke.py`` (the DSL below), and a live server's ``chaos`` config
block (``main.py``).

DSL — one action per line (``;`` also separates), ``#`` comments::

    at 0.5  lose-session            # store goes dark, mirror starts aging
    at 1.0  watch-storm n=600       # mutation burst through the store
    at 2.0  loop-stall ms=120       # synchronous event-loop stall
    at 2.5  upstream loss=0.3 delay_ms=40 dup=0.05
    at 3.0  tcp-slow-reader conns=2 queries=512   # never reads answers
    at 3.5  tcp-half-close queries=3    # send then SHUT_WR
    at 3.8  tcp-rst conns=2             # torn frame + RST
    at 4.0  expire-session          # loss + immediate re-establish
    at 4.5  shard-kill shard=0      # SIGKILL a serving shard worker
    at 4.7  worker-roll shard=0     # zero-downtime drain-and-replace
    at 4.8  rrl-flood n=400         # spoofed-prefix UDP burst
    at 5.0  restore-session         # plain re-establish
    at 5.2  corrupt-answer          # flip a byte in a compiled wire
    at 5.4  drop-reverse            # delete one PTR map entry
    at 5.6  skew-replica shard=0    # suppress one worker delta frame
    at 6.0  upstream clear          # all upstream faults off

Actions
-------
- ``lose-session`` / ``restore-session`` / ``expire-session`` — drive
  the store's session test hooks (``FakeStore.lose_session`` /
  ``start_session`` / ``expire_session``; the ZK test server's
  ``drop_connections`` / ``expire_session`` via duck typing).
- ``watch-storm n=N`` — apply N mutations through the driver's
  ``mutate`` callback (the caller owns what a mutation writes).
- ``loop-stall ms=M`` — block the event loop synchronously for M ms
  (what a GC pause / runaway callback does to serving).
- ``upstream k=v ...`` — set live fault knobs consumed by
  :class:`~binder_torch.chaos.upstream.ChaosUpstream`: ``loss`` (drop
  probability), ``delay_ms`` (response delay, making a slow peer),
  ``dup`` (duplicate-response probability), ``truncate`` (1 = answer
  TC=1 with no answers, forcing the TCP retry path), ``dead`` (1 =
  drop everything).  ``upstream clear`` resets all of them.
- ``tcp-slow-reader`` / ``tcp-half-close`` / ``tcp-rst`` — misbehaving
  stream-lane clients driven at the driver's ``tcp_target``
  (``chaos/stream.py``): a pipelining client that never reads (must be
  disconnected at the write-buffer cap), a send-then-SHUT_WR client
  (must still get its answers), and a torn-frame RST (must never wedge
  the connection table).
- ``shard-kill [shard=I]`` — SIGKILL one shard worker mid-load via the
  driver's ``shard_target`` (the supervisor's ``kill_shard``;
  ``shard`` omitted or -1 picks a live worker at random).  The
  acceptance invariant is the supervisor's: the kernel re-hashes the
  dead socket's share to the survivors at once, and the respawned
  worker catches up from snapshot (binder_torch/shard).
- ``worker-roll [shard=I]`` — request a zero-downtime drain-and-
  replace cycle via the driver's ``roll_target`` (the supervisor's
  ``request_roll``; ``shard`` omitted or -1 rolls every shard in
  sequence).  Unlike ``shard-kill`` this is the *cooperative* path:
  the acceptance invariant is zero query loss — replacement converges
  from snapshot and joins the reuseport group BEFORE the incumbent is
  drained, one shard at a time.  Rolling mid-incident (after a
  ``lose-session`` or during an ``rrl-flood``) is exactly the
  operator reality the chaos smoke pins.
- ``rrl-flood [n=N] [qname=...]`` — synchronous burst of N (default
  400) well-formed UDP queries from spoofed attacker-prefix source
  addresses (the same 127/8 prefixes ``tools/hostile.py`` uses, so
  per-prefix RRL isolates them from the 127.0.0/24 measurement
  client), fired at the driver's ``udp_target``.  Replies are never
  read — the flood models reflection-attack ammunition, and the
  assertable outcome is on the server: ``binder_rrl_*`` counters move,
  the legit client's goodput survives.
- ``corrupt-answer [qname=...]`` / ``drop-reverse [ip=...]`` /
  ``skew-replica [shard=I] [frames=N]`` — verify-plane faults,
  dispatched by method name at the driver's ``verify_target``
  (the :class:`BinderServer` for the table corruptions, the shard
  supervisor for the mutation-log skew).  Each breaks serving state
  WITHOUT firing an invalidation — the sampled audit (compiled-bytes,
  ptr-coherence) and the digest frames (replica-digest) are the only
  things that can catch them, which is the point: the chaos action
  proves the checker's detection, not the datapath's tolerance.

Determinism: the plan carries its own seeded RNG; two runs with the
same seed inject byte-identical fault decisions.
"""
from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Callable, List, Optional, Tuple

ACTIONS = ("lose-session", "restore-session", "expire-session",
           "watch-storm", "loop-stall", "upstream",
           "tcp-slow-reader", "tcp-half-close", "tcp-rst",
           "shard-kill", "worker-roll", "rrl-flood",
           "corrupt-answer", "drop-reverse", "skew-replica")
STREAM_ACTIONS = ("tcp-slow-reader", "tcp-half-close", "tcp-rst")
#: spoofed-source /24s the rrl-flood action binds (Linux accepts any
#: 127/8 address unconfigured) — the SAME prefixes tools/hostile.py
#: floods from, so one RRL allowlist/bucket story covers both harnesses
FLOOD_PREFIXES = ("127.66.7", "127.66.8", "127.99.1", "127.99.2")
#: verify-plane faults, dispatched by method name at ``verify_target``
VERIFY_ACTIONS = ("corrupt-answer", "drop-reverse", "skew-replica")


class UpstreamFaults:
    """Live fault state the chaos upstream consults per packet."""

    __slots__ = ("loss", "delay_ms", "dup", "truncate", "dead")

    def __init__(self) -> None:
        self.clear()

    def clear(self) -> None:
        self.loss = 0.0
        self.delay_ms = 0.0
        self.dup = 0.0
        self.truncate = False
        self.dead = False

    def set(self, **kw) -> None:
        for key, val in kw.items():
            if key == "clear":
                self.clear()
            elif key in ("loss", "delay_ms", "dup"):
                setattr(self, key, float(val))
            elif key in ("truncate", "dead"):
                setattr(self, key, bool(int(val)))
            else:
                raise ValueError(f"unknown upstream fault knob {key!r}")

    def snapshot(self) -> dict:
        return {"loss": self.loss, "delay_ms": self.delay_ms,
                "dup": self.dup, "truncate": self.truncate,
                "dead": self.dead}


class FaultPlan:
    """Timeline of (t_offset_seconds, action, kwargs) + live state."""

    def __init__(self, seed: int = 0) -> None:
        self.timeline: List[Tuple[float, str, dict]] = []
        self.upstream = UpstreamFaults()
        self.rng = random.Random(seed)
        self.seed = seed

    def at(self, t: float, action: str, **kwargs) -> "FaultPlan":
        """Append one scheduled action (builder style, chainable)."""
        if action not in ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}")
        self.timeline.append((float(t), action, kwargs))
        self.timeline.sort(key=lambda e: e[0])
        return self

    @property
    def duration(self) -> float:
        return self.timeline[-1][0] if self.timeline else 0.0

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse the DSL above.  Raises ValueError with the offending
        fragment on any malformed line — a chaos script that silently
        does nothing is worse than none."""
        plan = cls(seed=seed)
        for raw_line in spec.replace(";", "\n").splitlines():
            line = raw_line.split("#", 1)[0].strip()
            if not line:
                continue
            toks = line.split()
            if len(toks) < 3 or toks[0] != "at":
                raise ValueError(f"chaos spec: expected "
                                 f"'at <t> <action> ...': {line!r}")
            try:
                t = float(toks[1])
            except ValueError:
                raise ValueError(f"chaos spec: bad time {toks[1]!r}")
            action = toks[2]
            kwargs: dict = {}
            for tok in toks[3:]:
                if tok == "clear":
                    kwargs["clear"] = True
                    continue
                if "=" not in tok:
                    raise ValueError(f"chaos spec: expected k=v, "
                                     f"got {tok!r}")
                k, v = tok.split("=", 1)
                try:
                    kwargs[k] = float(v) if "." in v else int(v)
                except ValueError:
                    # non-numeric values are strings (verify-plane
                    # selectors: qname=..., ip=...); empty is still
                    # malformed
                    if not v:
                        raise ValueError(f"chaos spec: bad value {tok!r}")
                    kwargs[k] = v
            plan.at(t, action, **kwargs)
        return plan


class ChaosDriver:
    """Binds a :class:`FaultPlan` to live targets and runs it.

    Targets are all optional — a plan driven only at an upstream needs
    no store, and vice versa.  ``mutate`` is called ``mutate(i)`` per
    watch-storm mutation; the caller decides what churn means for its
    fixture.  Every applied action is flight-recorded
    (``chaos-inject``) so a soak's failure report can line the
    injected faults up against the observed transitions.
    """

    def __init__(self, plan: FaultPlan, *, store=None,
                 mutate: Optional[Callable[[int], None]] = None,
                 tcp_target: Optional[Tuple[str, int, str]] = None,
                 udp_target: Optional[Tuple[str, int, str]] = None,
                 shard_target: Optional[Callable[[int], object]] = None,
                 roll_target: Optional[Callable[[int], object]] = None,
                 verify_target=None,
                 recorder=None,
                 log: Optional[logging.Logger] = None) -> None:
        self.plan = plan
        self.store = store
        self.mutate = mutate
        # (host, port, qname) the stream faults connect to; None skips
        # tcp-* actions with a warning (a plan driven only at the store
        # needs no live listener)
        self.tcp_target = tcp_target
        # (host, port, qname) the rrl-flood spoofed burst fires at;
        # falls back to tcp_target (binder serves both lanes on one
        # port) when unset
        self.udp_target = udp_target
        # shard-kill sink: the supervisor's kill_shard(index) (index -1
        # = random live worker); None skips with a warning
        self.shard_target = shard_target
        # worker-roll sink: request_roll(shard) on the supervisor
        # (shard -1 = roll every shard in sequence)
        self.roll_target = roll_target
        # verify-plane fault sink: corrupt_answer/drop_reverse on a
        # BinderServer, skew_replica on a shard supervisor — dispatch
        # is by method name, so either (or a test double) fits
        self.verify_target = verify_target
        self.recorder = recorder
        self.log = log or logging.getLogger("binder.chaos")
        self.applied: List[Tuple[float, str]] = []
        self.started_mono: Optional[float] = None
        self._stream_tasks: set = set()

    # -- action dispatch --

    def apply(self, action: str, kwargs: dict) -> None:
        """Apply one action NOW (also the unit-test entry — no loop
        needed)."""
        if action == "upstream":
            self.plan.upstream.set(**kwargs)
        elif action == "watch-storm":
            n = int(kwargs.get("n", 100))
            if self.mutate is None:
                self.log.warning("chaos: watch-storm with no mutate "
                                 "target; skipped")
            else:
                for i in range(n):
                    self.mutate(i)
        elif action == "loop-stall":
            time.sleep(float(kwargs.get("ms", 100)) / 1000.0)
        elif action in ("lose-session", "restore-session",
                        "expire-session"):
            self._session_action(action)
        elif action == "shard-kill":
            if self.shard_target is None:
                self.log.warning("chaos: shard-kill with no shard "
                                 "target; skipped")
            else:
                self.shard_target(int(kwargs.get("shard", -1)))
        elif action == "worker-roll":
            if self.roll_target is None:
                self.log.warning("chaos: worker-roll with no roll "
                                 "target; skipped")
            else:
                self.roll_target(int(kwargs.get("shard", -1)))
        elif action == "rrl-flood":
            self._flood_action(kwargs)
        elif action in STREAM_ACTIONS:
            self._stream_action(action, kwargs)
        elif action in VERIFY_ACTIONS:
            self._verify_action(action, kwargs)
        else:
            raise ValueError(f"unknown chaos action {action!r}")
        self.applied.append((time.monotonic(), action))
        if self.recorder is not None:
            self.recorder.record("chaos-inject", action=action, **{
                k: v for k, v in kwargs.items()})
        self.log.info("chaos: injected %s %s", action, kwargs or "")

    def _session_action(self, action: str) -> None:
        st = self.store
        if st is None:
            self.log.warning("chaos: %s with no store target; skipped",
                             action)
            return
        if action == "lose-session":
            # FakeStore.lose_session; the ZK test server's analog is
            # severing this member's connections without expiry
            fn = getattr(st, "lose_session", None) \
                or getattr(st, "drop_connections", None)
        elif action == "expire-session":
            fn = getattr(st, "expire_session", None)
        else:
            # restore: FakeStore.start_session; the real client
            # re-establishes on its own once connections are allowed
            fn = getattr(st, "start_session", None)
        if fn is None:
            self.log.warning("chaos: store %s has no hook for %s",
                             type(st).__name__, action)
            return
        fn()

    def _verify_action(self, action: str, kwargs: dict) -> None:
        vt = self.verify_target
        if vt is None:
            self.log.warning("chaos: %s with no verify target; skipped",
                             action)
            return
        fn = getattr(vt, action.replace("-", "_"), None)
        if fn is None:
            self.log.warning("chaos: verify target %s has no hook "
                             "for %s", type(vt).__name__, action)
            return
        result = fn(**kwargs)
        if result is None:
            # nothing to corrupt (empty table / no matching entry):
            # loud, so a smoke that asserted a detection can tell
            # "not injected" apart from "not detected"
            self.log.warning("chaos: %s found no target state", action)

    def _flood_action(self, kwargs: dict) -> None:
        """Spoofed-prefix UDP burst: n queries round-robined across
        sockets bound inside the attacker /24s, replies never read.
        Synchronous and send-only — a few hundred sendto()s finish in
        single-digit milliseconds, well inside timeline accuracy."""
        target = self.udp_target or self.tcp_target
        if target is None:
            self.log.warning("chaos: rrl-flood with no udp target; "
                             "skipped")
            return
        host, port, default_qname = target
        n = int(kwargs.get("n", 400))
        qname = str(kwargs.get("qname", default_qname))
        from binder_torch.dns.wire import Type, make_query
        import socket as socket_mod
        socks = []
        for pfx in FLOOD_PREFIXES:
            for host_octet in (7, 8):
                s = socket_mod.socket(socket_mod.AF_INET,
                                      socket_mod.SOCK_DGRAM)
                try:
                    s.bind((f"{pfx}.{host_octet}", 0))
                    s.connect((host, port))
                    s.setblocking(False)
                except OSError:
                    s.close()
                    continue
                socks.append(s)
        if not socks:
            self.log.warning("chaos: rrl-flood could not bind any "
                             "spoofed source; skipped")
            return
        try:
            for i in range(n):
                wire = make_query(qname, Type.A,
                                  qid=(i % 65535) + 1).encode()
                try:
                    socks[i % len(socks)].send(wire)
                except OSError:
                    # full socket buffer / ICMP-refused connect errors
                    # are flood reality, not harness failures
                    pass
        finally:
            for s in socks:
                s.close()

    def _stream_action(self, action: str, kwargs: dict) -> None:
        if self.tcp_target is None:
            self.log.warning("chaos: %s with no tcp target; skipped",
                             action)
            return
        from binder_torch.chaos.stream import run_stream_fault
        coro = run_stream_fault(action, *self.tcp_target, **kwargs)
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            # no loop (synchronous unit-test entry): drive inline
            asyncio.run(coro)
            return
        # fault clients do real socket I/O: run them as tasks so the
        # plan's timeline keeps its scripted instants
        task = asyncio.ensure_future(coro)
        self._stream_tasks.add(task)
        task.add_done_callback(self._stream_tasks.discard)

    async def stream_quiesce(self) -> None:
        """Await completion of every in-flight stream fault client
        (smokes assert table state after the faults, not during)."""
        while self._stream_tasks:
            await asyncio.gather(*list(self._stream_tasks),
                                 return_exceptions=True)

    # -- the scripted run --

    async def run(self) -> None:
        """Play the plan's timeline against the targets.  Sleeps are
        relative to the run's own start; actions land within event-loop
        scheduling accuracy of their scripted instants."""
        loop = asyncio.get_running_loop()
        self.started_mono = loop.time()
        for t, action, kwargs in self.plan.timeline:
            delay = self.started_mono + t - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            try:
                self.apply(action, kwargs)
            except Exception:  # noqa: BLE001 — keep injecting
                self.log.exception("chaos action %s failed", action)

    def start(self) -> "asyncio.Task":
        return asyncio.ensure_future(self.run())
