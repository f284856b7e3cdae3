"""Per-peer circuit breakers + latency tracking for recursion upstreams.

The reference forwards cross-DC queries with a flat 3 s timeout per
upstream and no memory between queries (``lib/recursion.js:253-279``):
a dead remote binder costs every single query the full timeout before
the next resolver is tried, and the dead peer keeps being retried at
full rate — exactly the uncontrolled upstream fan-out NXNSAttack
(PAPERS.md) shows amplifying a remote failure into a local outage.

This module gives each upstream peer a classic three-state breaker:

- **closed** — normal serving; consecutive transport failures are
  counted and ``FAILURE_THRESHOLD`` of them open the breaker.
- **open** — the peer is skipped outright (a query to a DC whose only
  peer is open fails over to REFUSED in well under a millisecond — the
  "<100 ms once the breaker is open" guarantee, pinned by
  tests/test_chaos.py).  The open interval backs off exponentially
  with full jitter (cap ``BACKOFF_CAP``) so a herd of binders doesn't
  re-probe a recovering peer in lockstep.
- **half-open** — after the backoff expires exactly ONE probe query is
  let through; success closes the breaker and resets the backoff,
  failure re-opens it at the next backoff step.

An *rcode* error (REFUSED, NXDOMAIN...) is a *response*: the peer is
alive and the breaker records success — breakers track transport
liveness, not answer quality.

Latency tracking rides along: a bounded ring of recent RTTs per peer
feeds ``hedge_delay()``, the p95-based stagger the DNS client uses to
launch a hedged second request instead of waiting out the full serial
timeout (``recursion/client.py``).

Every transition emits a ``breaker-transition`` flight-recorder event
and updates ``binder_breaker_state`` (0 closed / 1 half-open / 2 open,
labelled by peer, plus an always-present ``peer="(max)"`` aggregate
series alerting rules can key on without knowing peer names).
"""
from __future__ import annotations

import logging
import random
import time
from typing import Dict, List, Optional, Sequence

#: breaker state encoding for binder_breaker_state (docs/degradation.md)
STATE_CODES = {"closed": 0, "half-open": 1, "open": 2}


class CircuitBreaker:
    """One peer's breaker + latency ring.  Single-threaded (event-loop
    owned), monotonic-clock based."""

    FAILURE_THRESHOLD = 3
    BACKOFF_BASE = 1.0      # first open interval (seconds)
    BACKOFF_CAP = 30.0      # backoff ceiling
    LATENCY_RING = 64       # recent RTT samples kept for the p95
    #: half-open probe admission rate: one probe per interval.  Rate-
    #: based rather than one-outstanding-at-a-time on purpose — a probe
    #: whose outcome is never reported back (winner raced it, task
    #: cancelled mid-flight) must not wedge the breaker half-open
    #: forever.
    PROBE_INTERVAL = 1.0

    __slots__ = ("peer", "state", "failures", "consecutive", "successes",
                 "opened_at", "open_until", "_backoff", "_last_probe",
                 "_lat", "_lat_i", "transitions", "_rng", "_on_transition")

    def __init__(self, peer: str, rng: Optional[random.Random] = None,
                 on_transition=None) -> None:
        self.peer = peer
        self.state = "closed"
        self.failures = 0          # total transport failures ever
        self.consecutive = 0       # current consecutive-failure run
        self.successes = 0
        self.opened_at: Optional[float] = None
        self.open_until = 0.0
        self._backoff = self.BACKOFF_BASE
        self._last_probe = 0.0
        self._lat: List[float] = []
        self._lat_i = 0
        self.transitions = 0
        self._rng = rng or random.Random()
        self._on_transition = on_transition

    # -- admission --

    def allow(self, now: Optional[float] = None) -> bool:
        """May a query be sent to this peer right now?  In the open
        state this flips to half-open (and admits a probe) once the
        backoff interval has elapsed."""
        if self.state == "closed":
            return True
        now = time.monotonic() if now is None else now
        if self.state == "open":
            if now < self.open_until:
                return False
            self._transition("half-open")
            self._last_probe = now
            return True
        # half-open: one probe per PROBE_INTERVAL
        if now - self._last_probe < self.PROBE_INTERVAL:
            return False
        self._last_probe = now
        return True

    # -- outcome feedback --

    def record_success(self, latency_s: Optional[float] = None) -> None:
        self.successes += 1
        self.consecutive = 0
        if latency_s is not None:
            if len(self._lat) < self.LATENCY_RING:
                self._lat.append(latency_s)
            else:
                self._lat[self._lat_i] = latency_s
                self._lat_i = (self._lat_i + 1) % self.LATENCY_RING
        if self.state != "closed":
            self._backoff = self.BACKOFF_BASE
            self._transition("closed")

    def record_failure(self, now: Optional[float] = None) -> None:
        self.failures += 1
        self.consecutive += 1
        now = time.monotonic() if now is None else now
        if self.state == "half-open":
            # failed probe: re-open at the next backoff step
            self._backoff = min(self._backoff * 2, self.BACKOFF_CAP)
            self._open(now)
        elif (self.state == "closed"
                and self.consecutive >= self.FAILURE_THRESHOLD):
            self._open(now)

    def _open(self, now: float) -> None:
        self.opened_at = now
        # full jitter (0.5x..1x of the backoff): decorrelates probe
        # herds across the N-process deployment unit
        self.open_until = now + self._backoff * (
            0.5 + 0.5 * self._rng.random())
        self._transition("open")

    def _transition(self, new: str) -> None:
        old, self.state = self.state, new
        self.transitions += 1
        if self._on_transition is not None:
            self._on_transition(self, old, new)

    # -- latency / introspection --

    def p95_latency(self) -> Optional[float]:
        if not self._lat:
            return None
        ordered = sorted(self._lat)
        return ordered[min(len(ordered) - 1,
                           int(len(ordered) * 0.95))]

    def introspect(self) -> dict:
        return {
            "state": self.state,
            "failures": self.failures,
            "consecutive_failures": self.consecutive,
            "successes": self.successes,
            "backoff_seconds": self._backoff,
            "open_remaining_seconds": (
                max(0.0, self.open_until - time.monotonic())
                if self.state == "open" else 0.0),
            "p95_latency_ms": (None if self.p95_latency() is None
                               else self.p95_latency() * 1000.0),
        }


class PeerBreakers:
    """Breaker registry keyed by resolver string ("ip" / "ip:port").

    Shared by both recursion DNS clients (the bounded-concurrency
    forwarder and the PTR fan-out client) so a peer's health is one
    fact, not two.  Registered peers get a ``binder_breaker_state``
    series; an LRU bound keeps a rogue resolver-discovery source from
    minting unbounded series."""

    MAX_PEERS = 256
    #: hedge stagger bounds: never hedge sooner than the floor (a p95
    #: of microseconds would hedge every query), never later than the
    #: cap (the whole point is beating the 3 s serial timeout)
    HEDGE_FLOOR = 0.05
    HEDGE_CAP = 1.0
    #: stagger used before a peer has any latency samples
    HEDGE_DEFAULT = 0.25

    def __init__(self, collector=None, recorder=None,
                 log: Optional[logging.Logger] = None,
                 rng: Optional[random.Random] = None) -> None:
        self.log = log or logging.getLogger("binder.breaker")
        self.recorder = recorder
        self._rng = rng or random.Random()
        self._peers: Dict[str, CircuitBreaker] = {}
        self._gauge = None
        if collector is not None:
            self._gauge = collector.gauge(
                "binder_breaker_state",
                "per-peer circuit breaker state (0 closed, 1 half-open, "
                "2 open); peer=\"(max)\" aggregates the worst peer")
            # the aggregate series exists from scrape 1, peers or not —
            # alerting rules key on it without knowing peer addresses
            self._gauge.set_function(self._max_state_code,
                                     {"peer": "(max)"})

    def _max_state_code(self) -> float:
        return float(max((STATE_CODES[b.state]
                          for b in self._peers.values()), default=0))

    def _note_transition(self, breaker: CircuitBreaker, old: str,
                         new: str) -> None:
        if self.recorder is not None:
            self.recorder.record("breaker-transition", peer=breaker.peer,
                                 frm=old, to=new,
                                 consecutive=breaker.consecutive)
        if new == "open":
            self.log.warning(
                "circuit breaker OPEN for upstream %s after %d "
                "consecutive failures (backoff %.1fs)", breaker.peer,
                breaker.consecutive, breaker._backoff)
        elif new == "closed" and old != "closed":
            self.log.info("circuit breaker closed for upstream %s",
                          breaker.peer)

    def get(self, peer: str) -> CircuitBreaker:
        b = self._peers.get(peer)
        if b is None:
            if len(self._peers) >= self.MAX_PEERS:
                self._peers.pop(next(iter(self._peers)))
            b = CircuitBreaker(peer, rng=self._rng,
                               on_transition=self._note_transition)
            self._peers[peer] = b
            if self._gauge is not None:
                self._gauge.set_function(
                    lambda b=b: float(STATE_CODES[b.state]),
                    {"peer": peer})
        return b

    # -- client-facing policy --

    def filter(self, resolvers: Sequence[str]) -> List[str]:
        """The resolvers a lookup may use right now: closed peers
        first, then half-open probes; open (not yet probe-eligible)
        peers are skipped.  An empty result means every peer is open —
        the lookup fails fast (well-formed refusal) instead of
        hanging, and the next backoff expiry re-probes."""
        closed, probing = [], []
        now = time.monotonic()
        for r in resolvers:
            b = self._peers.get(r)
            if b is None or b.state == "closed":
                closed.append(r)
            elif b.allow(now):
                probing.append(r)
        return closed + probing

    def hedge_delay(self, peer: str) -> float:
        """How long to wait on *peer* before launching the next
        upstream: p95 of its recent RTTs (x1.5 headroom), clamped —
        the RFC-style hedged request stagger."""
        b = self._peers.get(peer)
        p95 = b.p95_latency() if b is not None else None
        if p95 is None:
            return self.HEDGE_DEFAULT
        return min(max(p95 * 1.5, self.HEDGE_FLOOR), self.HEDGE_CAP)

    def record(self, peer: str, ok: bool,
               latency_s: Optional[float] = None) -> None:
        b = self.get(peer)
        if ok:
            b.record_success(latency_s)
        else:
            b.record_failure()

    def open_count(self) -> int:
        return sum(1 for b in self._peers.values() if b.state == "open")

    def introspect(self) -> dict:
        return {peer: b.introspect()
                for peer, b in self._peers.items()}
