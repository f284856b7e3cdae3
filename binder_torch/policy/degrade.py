"""Stale-serve degradation policy: what binder does once the store dies.

The session state machine made the dominant silent failure *visible* — a binder whose ZK
session is gone keeps serving an aging mirror with every query looking
fine.  This module is the *policy* for that state, RFC 8767-style:

- while the session is up: **fresh** — serve normally;
- session lost, mirror age within ``maxStalenessSeconds``:
  **stale-serving** — keep answering from the mirror, with every
  record's TTL clamped to ``staleTtlClampSeconds`` (RFC 8767 §5
  recommends a low TTL so clients re-ask and notice recovery fast);
- past the cap: **stale-exhausted** — answers are *withheld* per
  ``exhaustedAction``: ``servfail`` (default; clients fail over per
  the engine's rcode policy) or ``nodata`` (NOERROR + SOA, negative-
  cacheable).  Data older than the cap is never served, from any lane.

The cap covers the *cached* lanes too: every transition bumps the
mirror epoch (``MirrorCache.invalidate_all``), so the Python answer
cache, the compiled table, the native C caches, and the balancer all
drop answers rendered under the previous mode — an answer rendered
fresh can never be served into exhaustion, and clamped-TTL stale
answers never survive recovery.

State is evaluated lazily on the query path (a couple of attribute
reads) and by a 1 s ticker (``BinderServer``) so transitions — and
their ``binder_degraded_state`` metric and ``degraded-transition``
flight-recorder events — fire even on an idle binder.  The whole
state machine derives from the session state machine's *measured*
``disconnected_seconds``; nothing here is inferred.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import List, Optional

#: degradation states, in increasing severity; the metric encodes the
#: index (binder_degraded_state: 0 fresh / 1 stale-serving /
#: 2 stale-exhausted — "returns to 0" is the recovery assertion)
STATES = ("fresh", "stale-serving", "stale-exhausted")
STATE_CODES = {s: i for i, s in enumerate(STATES)}

DEFAULT_MAX_STALENESS_S = 300.0
DEFAULT_STALE_TTL_CLAMP_S = 30
EXHAUSTED_ACTIONS = ("servfail", "nodata")


class DegradationPolicy:
    def __init__(self, *, store, zk_cache,
                 max_staleness_s: float = DEFAULT_MAX_STALENESS_S,
                 stale_ttl_clamp_s: int = DEFAULT_STALE_TTL_CLAMP_S,
                 exhausted_action: str = "servfail",
                 collector=None, recorder=None,
                 log: Optional[logging.Logger] = None,
                 history: int = 64) -> None:
        if exhausted_action not in EXHAUSTED_ACTIONS:
            raise ValueError(
                f"exhaustedAction must be one of {EXHAUSTED_ACTIONS}, "
                f"got {exhausted_action!r}")
        self.store = store
        self.zk_cache = zk_cache
        self.max_staleness_s = float(max_staleness_s)
        self.stale_ttl_clamp_s = int(stale_ttl_clamp_s)
        self.exhausted_action = exhausted_action
        self.recorder = recorder
        self.log = log or logging.getLogger("binder.policy")
        self._state = "fresh"
        self._since = time.monotonic()
        self._transitions: deque = deque(maxlen=history)
        self._transition_cbs: List = []
        self.stale_served = 0       # answers served in stale mode
        self.withheld = 0           # answers withheld in exhausted mode
        self._m_stale = self._m_withheld = None
        if collector is not None:
            collector.gauge(
                "binder_degraded_state",
                "degradation state machine (0 fresh, 1 stale-serving, "
                "2 stale-exhausted)"
            ).set_function(lambda: float(STATE_CODES[self.mode()]))
            self._m_stale = collector.counter(
                "binder_stale_served_total",
                "answers served from a stale mirror (TTL-clamped, "
                "within maxStalenessSeconds)").labelled()
            self._m_withheld = collector.counter(
                "binder_stale_withheld_total",
                "answers withheld past maxStalenessSeconds "
                "(exhaustedAction applied)").labelled()
            # series exist from scrape 1: degradation evidence must be
            # rate()-able before the first incident
            self._m_stale.inc(0)
            self._m_withheld.inc(0)

    def on_transition(self, cb) -> None:
        """Subscribe to state edges: cb(old, new).  BinderServer wires
        the epoch bump (cache invalidation) here."""
        self._transition_cbs.append(cb)

    # -- the state machine --

    def _evaluate(self) -> str:
        getter = getattr(self.store, "disconnected_seconds", None)
        if getter is None:
            # store without a session state machine (bare test doubles):
            # is_connected is all there is
            return ("fresh" if self.store.is_connected()
                    else "stale-serving")
        ds = getter()
        if ds is None:
            # never connected: there is no stale data to police — the
            # engine's not-ready SERVFAIL path owns this shape
            return "fresh"
        if ds <= 0.0 and self.store.is_connected():
            return "fresh"
        if ds <= self.max_staleness_s:
            return "stale-serving"
        return "stale-exhausted"

    def mode(self) -> str:
        """Current state, transitioning (and notifying) if the measured
        disconnection age moved the machine.  Cheap enough for the
        query path: two attribute reads and a comparison in the steady
        (fresh) state."""
        new = self._evaluate()
        old = self._state
        if new != old:
            now = time.monotonic()
            self._state = new
            self._since = now
            self._transitions.append({
                "t_mono": now, "t_wall": time.time(),
                "from": old, "to": new,
            })
            if self.recorder is not None:
                self.recorder.record(
                    "degraded-transition", frm=old, to=new,
                    disconnected_seconds=getattr(
                        self.store, "disconnected_seconds",
                        lambda: None)(),
                    max_staleness_seconds=self.max_staleness_s)
            level = (logging.WARNING if new != "fresh" else logging.INFO)
            self.log.log(level, "degradation state %s -> %s "
                         "(maxStalenessSeconds=%g)", old, new,
                         self.max_staleness_s)
            for cb in list(self._transition_cbs):
                try:
                    cb(old, new)
                except Exception:  # noqa: BLE001 — a subscriber bug
                    self.log.exception("degradation transition callback "
                                       "failed")   # must not stop serving
        return self._state

    tick = mode   # the periodic evaluator is the lazy one, by design

    # -- query-path accounting --

    def note_stale_served(self) -> None:
        self.stale_served += 1
        if self._m_stale is not None:
            self._m_stale.inc()

    def note_withheld(self) -> None:
        self.withheld += 1
        if self._m_withheld is not None:
            self._m_withheld.inc()

    def clamp_ttl(self, ttl: int) -> int:
        return min(ttl, self.stale_ttl_clamp_s)

    # -- introspection (status.py `policy.degradation`) --

    def introspect(self) -> dict:
        now = time.monotonic()
        return {
            "state": self.mode(),
            "state_since_seconds": now - self._since,
            "max_staleness_seconds": self.max_staleness_s,
            "stale_ttl_clamp_seconds": self.stale_ttl_clamp_s,
            "exhausted_action": self.exhausted_action,
            "mirror_staleness_seconds":
                self.zk_cache.staleness_seconds(),
            "stale_served": self.stale_served,
            "withheld": self.withheld,
            "transitions": [
                {"t_wall": tr["t_wall"],
                 "age_seconds": now - tr["t_mono"],
                 "from": tr["from"], "to": tr["to"]}
                for tr in self._transitions],
        }
