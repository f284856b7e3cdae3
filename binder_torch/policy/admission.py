"""Overload admission control: bounded in-flight table + client buckets.

Two distinct overload shapes, two levers:

- **In-flight overflow** (oldest-shed).  Queries that go async
  (recursion forwards, parked handlers) sit in the engine's in-flight
  table.  Under an upstream brown-out that table grows without bound —
  every entry holds a client still waiting, and the oldest entries are
  the ones least likely to ever complete usefully (their clients have
  long retried).  When the table exceeds ``maxInflight``, the OLDEST
  in-flight query is shed: it gets an immediate well-formed REFUSED
  (clients fail over to their next nameserver — the engine's standing
  rcode policy) and its task is cancelled, so the table bounds both
  memory and upstream fan-out.  A hang is never the failure mode.

- **Recursion-triggering floods** (per-client token buckets).  A
  single client hammering cold RD names converts cheap local misses
  into expensive cross-DC forwards — the NXNSAttack amplification
  shape (PAPERS.md).  Each client IP gets a token bucket
  (``recursionRate``/s, burst ``recursionBurst``); an empty bucket
  REFUSES the forward *before* any upstream work.  Mirror-served
  queries are never charged — only the queries that would fan out.

Both shed paths count into ``binder_shed_total{reason=...}`` (series
materialized at 0 so rate() works from the first scrape), emit
rate-limited ``query-shed`` flight-recorder events, and surface in
``/status`` under ``policy.admission``.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

DEFAULT_MAX_INFLIGHT = 512
DEFAULT_RECURSION_RATE = 50.0     # tokens/second per client
DEFAULT_RECURSION_BURST = 100.0
#: client buckets tracked at once (LRU): bounds memory under address
#: spoofing; an evicted client simply starts with a full bucket
MAX_CLIENTS = 4096

SHED_REASONS = ("inflight-overflow", "recursion-ratelimit",
                "response-ratelimit")


class AdmissionControl:
    #: shed flight-recorder events are rate-limited to one per window
    SHED_EVENT_WINDOW_S = 1.0

    def __init__(self, *, max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 recursion_rate: float = DEFAULT_RECURSION_RATE,
                 recursion_burst: float = DEFAULT_RECURSION_BURST,
                 collector=None, recorder=None,
                 log: Optional[logging.Logger] = None) -> None:
        self.max_inflight = int(max_inflight)
        self.recursion_rate = float(recursion_rate)
        self.recursion_burst = float(recursion_burst)
        self.recorder = recorder
        self.log = log or logging.getLogger("binder.admission")
        # client ip -> (tokens, last_refill_mono); insertion-ordered LRU
        self._buckets: Dict[str, Tuple[float, float]] = {}
        self.shed_counts = {reason: 0 for reason in SHED_REASONS}
        self._shed_children: Dict[str, object] = {}
        self._shed_event_last = 0.0
        if collector is not None:
            counter = collector.counter(
                "binder_shed_total",
                "queries shed by overload admission control, by reason")
            for reason in SHED_REASONS:
                child = counter.labelled({"reason": reason})
                child.inc(0)    # series exists from scrape 1
                self._shed_children[reason] = child

    # -- shared accounting --

    def _note_shed(self, reason: str, **detail) -> None:
        self.shed_counts[reason] += 1
        child = self._shed_children.get(reason)
        if child is not None:
            child.inc()
        now = time.monotonic()
        if (self.recorder is not None
                and now - self._shed_event_last >= self.SHED_EVENT_WINDOW_S):
            self._shed_event_last = now
            self.recorder.record("query-shed", reason=reason, **detail)

    # -- in-flight overflow (wired into DnsServer._dispatch) --

    def shed_overflow(self, engine) -> None:
        """Shed oldest in-flight queries until the table is back at
        the cap.  Called by the engine right after it admits a new
        async query; each shed query gets an immediate REFUSED and its
        driver task (if any) is cancelled."""
        from binder_torch.dns.wire import Rcode   # local: no import cycle
        inflight = engine.inflight
        while len(inflight) > self.max_inflight:
            qid, query = next(iter(inflight.items()))
            del inflight[qid]
            task = engine.inflight_tasks.pop(qid, None)
            if not query.responded:
                query.reset_sections()
                query.set_error(Rcode.REFUSED)
                query.log_ctx["reason"] = "shed: in-flight overflow"
                try:
                    query.respond()
                except OSError:
                    pass
            self._note_shed("inflight-overflow",
                            trace=query.trace_id, name=query.name(),
                            age_ms=round(query.latency_ms(), 1),
                            inflight=len(inflight))
            # metrics/log for the shed query run NOW; the guard in
            # engine._after keeps the cancelled task's own completion
            # from double-counting it
            engine._after(query)
            if task is not None:
                task.cancel()

    # -- recursion-triggering floods (wired into Resolver._finish) --

    def allow_recursion(self, client_ip: str) -> bool:
        """Charge one token against *client_ip*'s bucket; False means
        the forward must be refused (the caller answers REFUSED)."""
        now = time.monotonic()
        entry = self._buckets.pop(client_ip, None)
        if entry is None:
            if len(self._buckets) >= MAX_CLIENTS:
                self._buckets.pop(next(iter(self._buckets)))
            tokens = self.recursion_burst
        else:
            tokens, last = entry
            tokens = min(self.recursion_burst,
                         tokens + (now - last) * self.recursion_rate)
        if tokens < 1.0:
            self._buckets[client_ip] = (tokens, now)
            self._note_shed("recursion-ratelimit", client=client_ip)
            return False
        self._buckets[client_ip] = (tokens - 1.0, now)
        return True

    # -- introspection (status.py `policy.admission`) --

    def introspect(self, engine=None) -> dict:
        return {
            "max_inflight": self.max_inflight,
            "inflight": (len(engine.inflight) if engine is not None
                         else 0),
            "recursion_rate": self.recursion_rate,
            "recursion_burst": self.recursion_burst,
            "clients_tracked": len(self._buckets),
            "shed": dict(self.shed_counts),
        }
