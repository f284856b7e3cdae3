"""Incremental serving-plane invariant checker.

Janus-style (arXiv:2511.02559) incremental verification: instead of
re-proving the whole zone after every change, the checker hangs off the
SAME per-name invalidation feed the precompiler drains
(``MirrorCache.invalidate`` → ``BinderServer._on_store_invalidate``)
and re-verifies only what a mutation can have affected.  Invariants:

- ``dangling-srv``: every child label a service node advertises
  resolves to a live mirrored node (an SRV answer never names a target
  that left the tree);
- ``ptr-coherence``: the v4/v6 reverse maps and the forward records
  agree in both directions — a host-like node's address has a reverse
  entry that points back at a node carrying that address, and no
  reverse entry maps an address its node no longer owns;
- ``compiled-bytes``: a compiled-table entry's wires are byte-identical
  to a fresh engine render of the same plan (id 0 / RD clear are the
  canonical form on both sides; rotation variants compare in their
  deterministic order).  Only checked while the degradation policy is
  ``fresh`` — stale serving clamps TTLs in the rendered bytes;
- ``replica-digest``: shard replicas apply the same mutation log the
  owner sent, proven by rolling per-generation digest frames (see
  ``shard/protocol.delta_digest``; the supervisor/replica own the
  wire halves, violations are counted under this invariant on both
  sides);
- ``stale-epoch``: no pre-transition epoch survives a
  degradation-policy flush — after an ``invalidate_all`` the checker
  sweeps the compiled table (time-budgeted), and any old-epoch entry
  found AFTER the sweep completed is a violation (the bug class where
  a re-render captures its epoch before a flush and installs after).

Violations surface three ways at once: a ``verify-violation`` flight
event, the ``binder_verify_violations_total{invariant}`` counter, and
the ``recent_violations`` table in ``/status verify``.  Work the
checker cannot do soundly (stale mode, store not ready, queue
overflow) is counted as ``binder_verify_skipped_total`` — silence is
never ambiguous.

Everything is time-budgeted at 2 ms per event-loop pass (the
chunked-rebuild discipline), including the sampled full-zone
background audit that catches drift the delta feed cannot see —
corruption injected directly into tables (chaos ``corrupt-answer`` /
``drop-reverse``) never fires an invalidation, so only the audit walk
finds it.
"""
from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Optional

from binder_torch.dns.wire import Rcode, Type, ip_from_reverse_name
from binder_torch.resolver.answer_cache import _COMPILED
from binder_torch.verify.tracer import PropagationTracer
from binder_torch.introspect.loopacct import ACCOUNT

#: the invariant catalog — the ``{invariant=...}`` label values of the
#: ``binder_verify_*_total`` families, all zero-seeded at startup and
#: pinned by ``tools/lint.py validate_verify_metrics``
INVARIANTS = (
    "dangling-srv",
    "ptr-coherence",
    "compiled-bytes",
    "replica-digest",
    "stale-epoch",
)

#: skip accounting for delta work shed under queue pressure (a series
#: on the skipped counter beside the per-invariant pins)
QUEUE_SHED = "queue-shed"


class Verifier:
    """The serving-plane checker: delta-fed incremental checks plus a
    sampled, budgeted background audit, and the owner of the process's
    :class:`~binder_torch.verify.tracer.PropagationTracer`."""

    #: per-pass wall budget for the delta drain, the epoch sweep and
    #: each audit slice — same discipline as the chunked mirror rebuild
    BUDGET_S = 0.002
    MIN_CHUNK = 1
    #: delta-queue bound: overflow degrades to the audit (counted as
    #: skipped), never to unbounded memory
    MAX_QUEUE = 8192
    #: violations retained for the /status table
    RECENT_VIOLATIONS = 16

    def __init__(self, *, zk_cache, answer_cache=None, resolver=None,
                 precompiler=None, policy_mode=None, config=None,
                 collector=None, recorder=None,
                 log: Optional[logging.Logger] = None) -> None:
        cfg = dict(config or {})
        self.zk_cache = zk_cache
        self.answer_cache = answer_cache
        self.resolver = resolver
        self.precompiler = precompiler
        self._policy_mode = policy_mode or (lambda: "fresh")
        self.recorder = recorder
        self.log = log or logging.getLogger("binder.verify")
        self.audit_interval_s = float(
            cfg.get("auditIntervalSeconds", 0.25))
        #: check every Nth name/entry per audit pass; successive passes
        #: rotate the residue so N passes cover the whole zone
        self.audit_sample = max(1, int(cfg.get("auditSample", 1)))
        self.tracer = PropagationTracer(collector=collector,
                                        log=self.log)
        # plain dict mirrors of the counters for introspect() (and for
        # collector-less test builds)
        self.checks = {inv: 0 for inv in INVARIANTS}
        self.violations = {inv: 0 for inv in INVARIANTS}
        self.skipped = {inv: 0 for inv in INVARIANTS}
        self.skipped[QUEUE_SHED] = 0
        self.recent_violations: deque = deque(
            maxlen=self.RECENT_VIOLATIONS)
        self.audit_passes = 0
        # delta queue: insertion-ordered tag set (dict keys)
        self._queue: dict = {}
        self._drain_scheduled = False
        # stale-epoch sweep state (see _maybe_epoch_sweep)
        self._epoch_seen = zk_cache.epoch
        self._sweep_keys: list = []
        self._sweep_done = True
        # audit cursor
        self._audit_work: list = []
        self._audit_residue = 0
        self._audit_task = None
        self._m_checks = self._m_violations = self._m_skipped = None
        if collector is not None:
            checks = collector.counter(
                "binder_verify_checks_total",
                "serving-plane invariant checks evaluated")
            violations = collector.counter(
                "binder_verify_violations_total",
                "serving-plane invariant violations detected")
            skipped = collector.counter(
                "binder_verify_skipped_total",
                "invariant checks skipped (unsound mode, store not "
                "ready, or delta-queue overflow)")
            self._m_checks = {
                inv: checks.labelled({"invariant": inv})
                for inv in INVARIANTS}
            self._m_violations = {
                inv: violations.labelled({"invariant": inv})
                for inv in INVARIANTS}
            self._m_skipped = {
                inv: skipped.labelled({"invariant": inv})
                for inv in (INVARIANTS + (QUEUE_SHED,))}
            for children in (self._m_checks, self._m_violations,
                             self._m_skipped):
                for child in children.values():
                    child.inc(0)
            collector.gauge(
                "binder_verify_queue_depth",
                "invalidation tags awaiting incremental verification"
            ).set_function(lambda: float(len(self._queue)))

    # -- accounting --

    def _check(self, invariant: str, n: int = 1) -> None:
        self.checks[invariant] += n
        if self._m_checks is not None:
            self._m_checks[invariant].inc(n)

    def _skip(self, invariant: str, n: int = 1) -> None:
        self.skipped[invariant] += n
        if self._m_skipped is not None:
            self._m_skipped[invariant].inc(n)

    def _violation(self, invariant: str, **detail) -> None:
        self.violations[invariant] += 1
        if self._m_violations is not None:
            self._m_violations[invariant].inc()
        if self.recorder is not None:
            self.recorder.record("verify-violation",
                                 invariant=invariant, **detail)
        self.recent_violations.append(
            {"invariant": invariant, "at": time.time(), **detail})
        self.log.error("verify violation [%s]: %s", invariant, detail)

    def note_digest(self, gen: int, ok: bool, have=None,
                    want=None) -> None:
        """Fold a replica-digest comparison outcome (the shard replica
        compares on the wire; this is its counting/reporting sink)."""
        self._check("replica-digest")
        if not ok:
            self._violation("replica-digest", generation=gen,
                            have=have, want=want)

    # -- delta intake (BinderServer._on_store_invalidate) --

    def enqueue_tags(self, tags) -> None:
        q = self._queue
        room = self.MAX_QUEUE - len(q)
        shed = 0
        for tag in tags:
            if tag in q:
                continue
            if room <= 0:
                shed += 1
                continue
            q[tag] = None
            room -= 1
        if shed:
            self._skip(QUEUE_SHED, shed)
        self._schedule()

    def _schedule(self) -> None:
        if self._drain_scheduled or not self._queue:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no loop (synchronous stores, tests): drain inline
            while self._queue or not self._sweep_done:
                self._drain(reschedule=False)
            return
        self._drain_scheduled = True
        loop.call_soon(self._drain)

    @ACCOUNT.spans("verify")
    def _drain(self, reschedule: bool = True) -> None:
        self._drain_scheduled = False
        t0 = time.perf_counter()
        self._maybe_epoch_sweep(t0)
        n = 0
        q = self._queue
        while q:
            tag = next(iter(q))
            del q[tag]
            try:
                self._check_tag(tag)
            except Exception:  # noqa: BLE001 — verification must never
                self.log.exception(      # break the mutation path
                    "verify check failed for tag %s", tag)
            n += 1
            if (n >= self.MIN_CHUNK
                    and time.perf_counter() - t0 >= self.BUDGET_S):
                break
        if not q:
            # a dict keeps the entries it grew to, and next(iter())
            # skips every deleted one from the front: start small
            # again, or each later check scans the whole boot queue
            self._queue = {}
        if reschedule and (q or not self._sweep_done):
            self._drain_scheduled = False
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return
            self._drain_scheduled = True
            loop.call_soon(self._drain)

    # -- per-tag incremental checks --

    def _check_tag(self, tag: str) -> None:
        ip = ip_from_reverse_name(tag) \
            if tag.endswith((".in-addr.arpa", ".ip6.arpa")) else None
        if ip is not None:
            self._check_reverse_entry(ip)
        else:
            node = self.zk_cache.nodes.get(tag)
            if node is not None:
                self._check_node(node)
        self._check_compiled_for_tag(tag)

    def _check_reverse_entry(self, ip: str) -> None:
        """One reverse-map entry's coherence: if the map still claims
        *ip*, the claiming node must be live and still own the
        address."""
        self._check("ptr-coherence")
        node = self.zk_cache.rev_lookup.get(ip)
        if node is None:
            return                      # entry gone: nothing to claim
        if self.zk_cache.nodes.get(node.domain) is not node:
            self._violation("ptr-coherence", ip=ip, node=node.domain,
                            detail="reverse entry names an unmirrored "
                                   "node")
        elif node.ip != ip:
            self._violation("ptr-coherence", ip=ip, node=node.domain,
                            detail="reverse entry address mismatch")

    def _check_node(self, node) -> None:
        """Forward checks for one mirrored node: its address must be
        reachable through the reverse map, and — for service nodes —
        every advertised child label must resolve."""
        ip = node.ip
        if ip:
            self._check("ptr-coherence")
            rnode = self.zk_cache.rev_lookup.get(ip)
            if rnode is None:
                self._violation("ptr-coherence", ip=ip,
                                node=node.domain,
                                detail="host address missing from the "
                                       "reverse map")
            elif rnode.ip != ip:
                self._violation("ptr-coherence", ip=ip,
                                node=rnode.domain,
                                detail="reverse entry address mismatch")
        rec = node.rec
        rtype = rec[0] if type(rec) is tuple else (
            rec.get("type") if isinstance(rec, dict) else None)
        if rtype == "service" and node.kids:
            self._check("dangling-srv")
            nodes = self.zk_cache.nodes
            for label in node.kids:
                kid = (label + "." + node.domain).lower()
                if nodes.get(kid) is None:
                    self._violation("dangling-srv", service=node.domain,
                                    target=kid)

    # -- compiled-table checks --

    def _check_compiled_for_tag(self, tag: str) -> None:
        ac = self.answer_cache
        if ac is None:
            return
        keys = ac._by_tag.get(tag)
        if not keys:
            return
        for key in list(keys):
            if type(key) is tuple and len(key) == 3 \
                    and key[0] is _COMPILED:
                self._check_compiled(key[1:])

    def _check_compiled(self, ckey) -> None:
        ac = self.answer_cache
        e = ac._compiled.get(ckey)
        if e is None:
            return
        epoch = self.zk_cache.epoch
        self._check("stale-epoch")
        if e[0] != epoch:
            # during the post-flush sweep window old-epoch entries are
            # EXPECTED (the flush invalidated them wholesale) — purge;
            # after the sweep declared the table clean, survival is the
            # violation
            if self._sweep_done:
                self._violation("stale-epoch", qname=ckey[1],
                                qtype=ckey[0], entry_epoch=e[0],
                                epoch=epoch)
            ac._drop_compiled(ckey, e)
            return
        if self._policy_mode() != "fresh":
            # stale serving clamps TTLs in the rendered bytes: a
            # re-render would false-positive against a fresh-rendered
            # entry (and vice versa)
            self._skip("compiled-bytes")
            return
        pc, rz = self.precompiler, self.resolver
        if pc is None or rz is None:
            self._skip("compiled-bytes")
            return
        qtype, qname = ckey
        if qtype == Type.PTR:
            plan = rz.plan_ptr(qname)
        else:
            plan = rz.plan(qname, qtype)
        self._check("compiled-bytes")
        if plan.rcode == Rcode.SERVFAIL:
            self._skip("compiled-bytes")
            return
        if plan.miss:
            self._violation("compiled-bytes", qname=qname, qtype=qtype,
                            detail="compiled entry for a missing name")
            return
        fresh = pc.render_variants(qname, qtype, plan)
        if fresh is None:
            self._skip("compiled-bytes")  # oversize/unencodable: lazy
            return
        have = e[2]
        if len(fresh) != len(have):
            self._violation("compiled-bytes", qname=qname, qtype=qtype,
                            detail="variant count %d != fresh %d"
                                   % (len(have), len(fresh)))
            return
        for i, (hv, fv) in enumerate(zip(have, fresh)):
            if hv[0] != fv[0] or hv[1] != fv[1]:
                self._violation(
                    "compiled-bytes", qname=qname, qtype=qtype,
                    variant=i,
                    detail="compiled wire differs from fresh render")
                return

    # -- stale-epoch sweep --

    def _maybe_epoch_sweep(self, t0: float) -> None:
        ac = self.answer_cache
        if ac is None:
            return
        epoch = self.zk_cache.epoch
        if epoch != self._epoch_seen:
            self._epoch_seen = epoch
            self._sweep_keys = list(ac._compiled)
            self._sweep_done = not self._sweep_keys
        if self._sweep_done:
            return
        keys = self._sweep_keys
        while keys:
            ckey = keys.pop()
            e = ac._compiled.get(ckey)
            if e is not None and e[0] != epoch:
                self._check("stale-epoch")
                ac._drop_compiled(ckey, e)
            if time.perf_counter() - t0 >= self.BUDGET_S:
                return
        self._sweep_done = True

    # -- the sampled background audit --

    def start(self, loop) -> None:
        if self._audit_task is None:
            self._audit_task = loop.create_task(self._audit_loop())

    async def stop(self) -> None:
        task, self._audit_task = self._audit_task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _audit_loop(self) -> None:
        while True:
            await asyncio.sleep(self.audit_interval_s)
            try:
                self.audit_slice()
            except Exception:  # noqa: BLE001 — the audit must outlive
                self.log.exception("verify audit slice failed")

    def _audit_refill(self) -> None:
        """Snapshot the next pass's work list.  At zone scale the
        snapshot itself is the expensive step (one list() over the node
        index); it runs once per full cycle, stays an order of
        magnitude under the loop-lag watchdog at a million names, and
        the sample knob divides everything after it.  Residue rotation
        makes ``auditSample`` passes cover the whole zone."""
        n = self.audit_sample
        r = self._audit_residue
        self._audit_residue = (r + 1) % n
        zk = self.zk_cache
        work = [("name", d) for d in list(zk.nodes)[r::n]]
        work += [("rev", ip) for ip in list(zk.rev_lookup)[r::n]]
        if self.answer_cache is not None:
            work += [("ckey", k)
                     for k in list(self.answer_cache._compiled)[r::n]]
        self._audit_work = work
        self.audit_passes += 1

    @ACCOUNT.spans("verify")
    def audit_slice(self) -> None:
        """One time-budgeted audit slice: resumes the in-flight pass or
        snapshots a new one.  Synchronous — tests drive it directly."""
        t0 = time.perf_counter()
        self._maybe_epoch_sweep(t0)
        if not self._audit_work:
            self._audit_refill()
        work = self._audit_work
        n = 0
        while work:
            kind, item = work.pop()
            try:
                if kind == "name":
                    node = self.zk_cache.nodes.get(item)
                    if node is not None:
                        self._check_node(node)
                elif kind == "rev":
                    self._check_reverse_entry(item)
                else:
                    self._check_compiled(item)
            except Exception:  # noqa: BLE001 — see _drain
                self.log.exception("verify audit failed for %s %s",
                                   kind, item)
            n += 1
            if (n >= self.MIN_CHUNK
                    and time.perf_counter() - t0 >= self.BUDGET_S):
                return

    def audit_cycle(self, max_slices: int = 10000) -> None:
        """Drive audit slices until one full pass completes (tests and
        the smoke tools — detection latency bounded by ONE cycle)."""
        if not self._audit_work:
            self.audit_slice()
        n = 0
        while self._audit_work and n < max_slices:
            self.audit_slice()
            n += 1

    # -- introspection (/status `verify` section) --

    def introspect(self) -> dict:
        return {
            "enabled": True,
            "checks": dict(self.checks),
            "violations": dict(self.violations),
            "skipped": dict(self.skipped),
            "queue_depth": len(self._queue),
            "audit": {
                "passes": self.audit_passes,
                "pending": len(self._audit_work),
                "interval_seconds": self.audit_interval_s,
                "sample": self.audit_sample,
            },
            "recent_violations": list(self.recent_violations),
            "propagation": self.tracer.introspect(),
        }
