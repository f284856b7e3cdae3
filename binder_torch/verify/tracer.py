"""Mutation-to-glass propagation tracing .

Every mirrored mutation gets a trace context — ``(trace_id, t0)``,
stamped when the owner mirror bumps its generation for the store event
— and each datapath stage that touches the resulting answer observes
the elapsed time against that SAME t0:

- ``mirror-apply``: the owner mirror's invalidation fan-out fired;
- ``shard-frame``: the supervisor put the delta on a worker's
  mutation-log stream;
- ``replica-apply``: a worker's replica store applied the delta (the
  frame carries the owner's trace id and t0 — ``time.monotonic`` is
  CLOCK_MONOTONIC on Linux, comparable across processes on one box);
- ``precompile-render`` / ``compiled-install``: the precompiler
  re-rendered the affected answers and installed them in the compiled
  table;
- ``native-install``: the zone lane re-installed the answer in the
  native fast path.

Observations fold into the per-stage ``binder_propagation_seconds``
histogram plus bounded in-memory reservoirs for the ``/status verify``
section: per-stage p50/p99 and a slowest-recent table that names the
trace (so an operator can grep the flight recorder / logs for the
mutation behind a propagation outlier).  Stage latencies are
END-TO-END from the store event, not per-hop deltas: "how long until
the glass showed it" is the quantity the DNS Push lane needs, and the
stage ordering recovers the per-hop costs by subtraction.

The tracer is passive: with no mutations in flight every hook is a
couple of attribute reads, and it is never on the query path at all.
"""
from __future__ import annotations

import logging
import os
import time
from collections import deque
from itertools import count
from typing import Optional, Tuple

#: the datapath stages a mutation's trace can light up, in order — the
#: exposed ``binder_propagation_seconds{stage=...}`` series set and the
#: label pins ``tools/lint.py validate_verify_metrics`` enforces
STAGES = (
    "mirror-apply",
    "shard-frame",
    "replica-apply",
    "precompile-render",
    "compiled-install",
    "native-install",
)

#: per-stage reservoir for the introspected p50/p99 (bounded; the
#: histogram keeps the unbounded account)
RECENT_PER_STAGE = 512
#: slowest-recent observations retained / shown in ``/status verify``
SLOWEST_KEEP = 64
SLOWEST_SHOW = 8


def trace_id(tracer) -> Optional[str]:
    """The id of the mutation ``tracer`` (or None) has in flight: the
    cause a stalled mutation callback is reported with."""
    ctx = tracer.current if tracer is not None else None
    return None if ctx is None else ctx[0]


def _quantile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


class PropagationTracer:
    """Allocates trace contexts at store events and folds per-stage
    observations into metrics + bounded introspection reservoirs.

    One instance per process; the owner-side instance lives on the
    serving plane's :class:`~binder_torch.verify.checker.Verifier` (the
    shard supervisor builds a bare one — it has no answer plane), and
    the mirror/precompiler/server reach it through duck-typed
    ``tracer`` attributes so every hook stays optional.
    """

    def __init__(self, *, collector=None,
                 log: Optional[logging.Logger] = None) -> None:
        self.log = log or logging.getLogger("binder.verify")
        # the trace context of the mutation currently being applied:
        # valid through the mirror's synchronous invalidation fan-out
        # (callbacks capture it for their async continuations)
        self.current: Optional[Tuple[str, float]] = None
        # a context handed down from an upstream process (a shard
        # replica's delta frame), consumed by the next store event
        self._inherit: Optional[Tuple[str, float]] = None
        self._seq = count()
        self._pid = os.getpid()
        self.observed = 0
        self._recent = {s: deque(maxlen=RECENT_PER_STAGE) for s in STAGES}
        self._slowest: deque = deque(maxlen=SLOWEST_KEEP)
        self._hist = None
        if collector is not None:
            from binder_torch.metrics.collector import DEFAULT_STAGE_BUCKETS
            hist = collector.histogram(
                "binder_propagation_seconds",
                "mutation-to-glass propagation latency from the store "
                "event to each datapath stage",
                buckets=DEFAULT_STAGE_BUCKETS)
            # materialize every stage series at 0 — the validator pins
            # the full stage set's presence before the first mutation
            self._hist = {s: hist.labelled({"stage": s}) for s in STAGES}

    # -- context lifecycle --

    def on_store_event(self, gen: int) -> None:
        """A mirrored mutation landed (``MirrorCache.bump_gen``): open
        its trace context — fresh, or the one a replica frame handed
        down (so the worker-side stages report against the OWNER's
        t0)."""
        inh = self._inherit
        if inh is not None:
            self._inherit = None
            self.current = inh
            return
        self.current = (f"m{self._pid:x}-{next(self._seq):x}",
                        time.monotonic())

    def inherit(self, tr, t0) -> None:
        """Stage an upstream context for the store event about to be
        applied (shard replica: called per delta frame, before the
        apply fires ``bump_gen``)."""
        if isinstance(tr, str) and isinstance(t0, (int, float)):
            self._inherit = (tr, float(t0))

    def clear(self) -> None:
        self._inherit = None

    # -- stage observations --

    def on_mirror_applied(self) -> None:
        self.observe("mirror-apply")

    def observe(self, stage: str,
                ctx: Optional[Tuple[str, float]] = None) -> None:
        """Record *stage* reached for *ctx* (default: the in-flight
        mutation).  No-op without a context — stages fired outside a
        traced mutation (startup seeds, tests) cost two loads."""
        if ctx is None:
            ctx = self.current
        if ctx is None:
            return
        dt = time.monotonic() - ctx[1]
        if dt < 0.0:
            dt = 0.0                    # cross-process clock guard
        self.observed += 1
        hist = self._hist
        if hist is not None:
            child = hist.get(stage)
            if child is not None:
                child.observe(dt)
        recent = self._recent.get(stage)
        if recent is not None:
            recent.append(dt)
        slow = self._slowest
        if len(slow) < slow.maxlen or dt > min(s[2] for s in slow):
            slow.append((stage, ctx[0], dt, time.time()))

    # -- introspection (/status verify.propagation) --

    def introspect(self) -> dict:
        stages = {}
        for stage in STAGES:
            vals = sorted(self._recent[stage])
            stages[stage] = {
                "count": len(vals),
                "p50_seconds": round(_quantile(vals, 0.50), 6),
                "p99_seconds": round(_quantile(vals, 0.99), 6),
            }
        slowest = sorted(self._slowest, key=lambda s: -s[2])
        return {
            "observed": self.observed,
            "stages": stages,
            "slowest": [
                {"stage": s[0], "trace": s[1],
                 "seconds": round(s[2], 6), "at": s[3]}
                for s in slowest[:SLOWEST_SHOW]],
        }
