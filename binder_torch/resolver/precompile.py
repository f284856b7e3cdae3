"""Mutation-time answer precompilation: the miss path at hit speed.

The r05 bench put the shape of the problem on the table: answer-cache
hits serve ~347k qps, but anything that reaches the resolver engine
collapses ~10x, and churn — which invalidates cached answers and forces
re-resolution — drags the fronted rate with it.  The reference binder
has the same resolve-per-miss shape over its ZK mirror.  This module
moves that work from query time to mutation time, the incremental-
computation approach Janus (arXiv:2511.02559) applies to DNS and
ZDNS-style wire-speed encoding (arXiv:2309.13495) makes cheap per
record:

- when the mirror applies a mutation (``MirrorCache.invalidate`` →
  ``BinderServer._on_store_invalidate``), the answers the invalidation
  actually DROPPED — the shapes with serving evidence, including
  concrete negative qnames clients asked — are eagerly re-resolved
  (``Resolver.plan`` — pure resolution, no QueryCtx) and re-rendered to
  wire: every round-robin rotation variant, SRV answer+additional
  sections, negative answers (NXDOMAIN / NODATA+SOA), in both EDNS
  postures.  Mutations of names nobody queries cost nothing beyond the
  synchronous drop;
- at startup the whole mirror is seeded (``seed_mirror`` — the
  ``_zone_fill`` analog), including into the native answer cache under
  the canonical client postures, so a cold zone serves precompiled from
  query one;
- the finished wires are installed into the ``AnswerCache``'s compiled
  table under the same dependency tags, so the post-churn query is a
  dict probe plus an ID/flags patch (``dns/wire.patch_answer_wire``)
  instead of an ``engine.resolve()`` pass;
- the work rides a bounded, coalescing queue drained in batches between
  event-loop passes.  A watch storm that outruns the queue SHEDS the
  overflow — those names simply degrade to today's lazy re-resolution —
  with a ``precompile-shed`` flight-recorder event and the
  ``binder_precompile_*`` metrics keeping the evidence.  The serving
  loop can never be stalled by refill work (the drops that guarantee
  coherence are synchronous in the server and are not this module's
  concern).

What never gets compiled: SERVFAIL (store down / garbage record — must
re-check per query, and the cache-never rule is absolute), and
miss-REFUSED when recursion is configured (the answer is RD-dependent
there; the lazy path owns the split).
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Iterable, Optional, Tuple

from binder_torch.dns.wire import (
    Message,
    OPTRecord,
    Question,
    Rcode,
    Type,
    WireError,
)
from binder_torch.introspect.loopacct import ACCOUNT

#: the loop-accounting activity (introspect/loopacct.py) of the seed's
#: chunks
_ACT_SEED = ACCOUNT.activity("boot.seed")

#: the EDNS echo appended to every EDNS response (identical instance
#: semantics to QueryCtx._ECHO_OPT: payload ceiling 1232, at the HEAD of
#: the additionals section, before any answer-derived additionals)
_ECHO_OPT = OPTRecord(name="", ttl=0, udp_payload_size=1232)

#: its wire form — byte-identical to OPTRecord.encode's output (pinned
#: by the byte-parity tests): root name, TYPE OPT(41), CLASS=1232,
#: TTL 0, RDLEN 0
_ECHO_OPT_WIRE = b"\x00\x00\x29\x04\xd0\x00\x00\x00\x00\x00\x00"

#: a work item is one question identity
Item = Tuple[int, str]   # (qtype, qname)


class Precompiler:
    #: items compiled per event-loop pass — the FLOOR; the drain keeps
    #: going past it only while the time budget below lasts, so backlog
    #: drain rate scales with how cheap the renders actually are
    #: instead of a fixed count guessing at it
    BATCH = 64
    #: hard per-pass ceiling (a pass of pathologically cheap items must
    #: still yield the loop)
    MAX_BATCH = 512
    #: per-pass wall budget: refill work between serving batches stays
    #: well under the loop-lag watchdog threshold even at zone scale
    DRAIN_BUDGET_S = 0.002
    #: queue bound FLOOR; the effective bound scales with the mirrored
    #: zone (``_max_pending``) so a large zone's legitimate churn burst
    #: is not shed at a toy zone's threshold, while staying hard-capped
    MAX_PENDING = 2048
    MAX_PENDING_CAP = 65536
    #: rotation variants rendered per rotatable answer set, in lockstep
    #: with AnswerCache.variants_cap / the native FP_MAX_VARIANTS
    VARIANTS_CAP = 8
    #: answer-set size ceiling: a service with hundreds of members
    #: renders VARIANTS_CAP full rotations of the whole set — one such
    #: item can cost hundreds of ms (a measured 300 ms loop stall at
    #: zone scale), and its wire exceeds every UDP payload so the
    #: compiled entry could never serve UDP anyway.  Oversize sets stay
    #: lazy (the engine serves them, with TC -> TCP as usual).
    MAX_SET_RECORDS = 64
    #: shed flight-recorder events are rate-limited to one per window
    SHED_EVENT_WINDOW_S = 1.0
    #: zones at or below this seed inline at startup (the historical
    #: behavior every small-zone test relies on); larger mirrors seed
    #: from a chunked background task so a million-name zone starts
    #: serving immediately and fills in behind the traffic
    SEED_INLINE_MAX = 20000

    def __init__(self, *, resolver, answer_cache, zk_cache, summarize,
                 collector=None, recorder=None,
                 log: Optional[logging.Logger] = None,
                 native_put=None, tracer=None) -> None:
        self.resolver = resolver
        self.answer_cache = answer_cache
        self.zk_cache = zk_cache
        self.summarize = summarize        # BinderServer._summarize
        # optional native-tier install hook
        # (BinderServer._precompile_native_put): compiled answers land
        # in the C answer cache too, under the canonical client
        # postures, so the post-churn miss path is LITERALLY the native
        # hit path
        self.native_put = native_put
        self.recorder = recorder
        self.log = log or logging.getLogger("binder.precompile")
        # optional propagation tracer (binder_torch/verify): each queued
        # item remembers the mutation trace context that enqueued it,
        # so the async re-render reports against the mutation's t0
        self.tracer = tracer
        self._pending_trace: dict = {}
        # insertion-ordered set of pending items (dict keys)
        self._pending: dict = {}
        self._drain_scheduled = False
        # chunked startup seed (large zones only)
        self._seed_task = None
        self._seed_remaining = 0
        # monotonic counters (also folded into the metrics below)
        self.compiled = 0
        self.declined = 0
        self.shed = 0
        self._shed_event_last = 0.0
        self._m_compiled = self._m_declined = self._m_shed = None
        if collector is not None:
            self._m_compiled = collector.counter(
                "binder_precompile_compiled",
                "answers re-rendered and installed at mutation time"
            ).labelled()
            self._m_declined = collector.counter(
                "binder_precompile_declined",
                "precompile work items declined to lazy resolution "
                "(SERVFAIL shapes, recursion-dependent misses, encode "
                "failures)").labelled()
            self._m_shed = collector.counter(
                "binder_precompile_shed",
                "precompile work items shed under queue pressure "
                "(watch storms degrade to lazy resolution)").labelled()
            collector.gauge(
                "binder_precompile_queue_depth",
                "precompile work items awaiting re-render"
            ).set_function(lambda: float(len(self._pending)))
            # materialize every series at 0: shedding evidence must be
            # scrapeable (and rate()-able) before the first shed, and
            # the validator pins the full family's presence
            for child in (self._m_compiled, self._m_declined,
                          self._m_shed):
                child.inc(0)

    # -- work intake --

    #: forward record types worth an eager render — exactly the shapes
    #: the resolver answers positively (engine.plan's type dispatch)
    _RENDERABLE_TYPES = frozenset({
        "db_host", "host", "load_balancer", "moray_host", "redis_host",
        "ops_host", "rr_host", "database", "service",
    })

    def items_for_tag(self, tag: str) -> Iterable[Item]:
        """The question identities a dependency tag's mutation may have
        changed AND can serve something: the PTR shape for reverse tags
        that currently map to an owner; the A shape for forward tags
        whose node resolves to an answerable record, plus — for service
        nodes with a registered srvce/proto — the SRV qname.

        Used by the STARTUP SEED walk only — the mutation path
        re-renders from the dropped-key evidence instead (see
        ``enqueue``)."""
        if tag.endswith(".in-addr.arpa"):
            parts = tag.split(".")
            if len(parts) >= 3:
                ip = ".".join(reversed(parts[:-2]))
                if self.zk_cache.reverse_lookup(ip) is not None:
                    yield (Type.PTR, tag)
            return
        node = self.zk_cache.lookup(tag)
        record = node.data if node is not None else None
        if not (isinstance(record, dict)
                and record.get("type") in self._RENDERABLE_TYPES):
            return
        yield (Type.A, tag)
        if record.get("type") != "service":
            return
        s = record.get("service")
        if isinstance(s, dict) and isinstance(s.get("service"), dict):
            s = s["service"]            # nested historical format
        if not isinstance(s, dict):
            return
        srvce, proto = s.get("srvce"), s.get("proto")
        if isinstance(srvce, str) and isinstance(proto, str) \
                and srvce and proto:
            yield (Type.SRV, f"{srvce}.{proto}.{tag}".lower())

    def enqueue(self, items) -> None:
        """Queue re-renders for a mutation event.  ``items`` is the
        invalidation's dropped-key list — ``(qtype, qname,
        evidence_at)`` triples for the question shapes that were
        actually BEING SERVED when the mutation killed them: per-key
        entries (a query created them) and compiled entries whose query
        evidence is still inside the expiry window.  Churn on names
        nobody queries therefore costs the precompiler nothing
        (measured: eager re-render of every mutated name taxed hot-mix
        churn throughput ~15% on a 1-core box, all of it spent on
        answers no one asked for), while a hot name's answers are
        re-rendered the moment its mutation lands.  Coalescing is by
        question identity — a name mutated ten times in one burst is
        rendered once, under its freshest evidence."""
        pending = self._pending
        room = self._max_pending() - len(pending)
        shed = 0
        tracer = self.tracer
        ctx = tracer.current if tracer is not None else None
        for qtype, qname, evidence_at in items:
            key = (qtype, qname)
            have = pending.get(key)
            if have is not None:
                if evidence_at > have:
                    pending[key] = evidence_at
                if ctx is not None:
                    self._pending_trace[key] = ctx
                continue                # coalesced
            if room <= 0:
                shed += 1
                continue
            pending[key] = evidence_at
            if ctx is not None:
                self._pending_trace[key] = ctx
            room -= 1
        if shed:
            self._note_shed(shed)
        self._schedule()

    def _note_shed(self, shed: int) -> None:
        self.shed += shed
        if self._m_shed is not None:
            self._m_shed.inc(shed)
        now = time.monotonic()
        if (self.recorder is not None
                and now - self._shed_event_last >= self.SHED_EVENT_WINDOW_S):
            self._shed_event_last = now
            self.recorder.record(
                "precompile-shed", shed=shed, pending=len(self._pending),
                max_pending=self._max_pending())

    def _max_pending(self) -> int:
        """Scale-aware queue bound: at least MAX_PENDING, growing with
        the mirrored zone up to the hard cap.  A 100-name test zone
        sheds exactly where it always did; a million-name zone's watch
        storm gets a proportionate buffer before degrading to lazy."""
        return max(self.MAX_PENDING,
                   min(len(self.zk_cache.nodes), self.MAX_PENDING_CAP))

    # -- the bounded drain --

    def _schedule(self) -> None:
        if self._drain_scheduled or not self._pending:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no loop (synchronous setup paths, tests against the fake
            # store): compile inline — there is no serving loop to stall
            while self._pending:
                item, ev, trace = self._pop()
                self._compile_one(item, evidence_at=ev, trace=trace)
            return
        self._drain_scheduled = True
        loop.call_soon(self._drain)

    def _pop(self):
        item = next(iter(self._pending))
        return (item, self._pending.pop(item),
                self._pending_trace.pop(item, None))

    @ACCOUNT.spans("precompile")
    def _drain(self) -> None:
        self._drain_scheduled = False
        n = 0
        t0 = time.perf_counter()
        while self._pending and n < self.MAX_BATCH:
            item, ev, trace = self._pop()
            try:
                self._compile_one(item, evidence_at=ev, trace=trace)
            except Exception:  # noqa: BLE001 — see below
                # precompilation is an optimization: a render bug must
                # never break the mutation path that feeds it
                self.log.exception("precompile failed for %s", item)
                self._decline()
            n += 1
            if (n >= self.BATCH
                    and time.perf_counter() - t0 >= self.DRAIN_BUDGET_S):
                break
        if self._pending:
            # more pending: yield to I/O first (call_soon callbacks
            # added during a loop pass run on the NEXT pass)
            self._schedule()

    def seed_mirror(self) -> None:
        """Compile every currently mirrored name — run once at server
        start, for mirrors built before this server subscribed to
        invalidation events (the same reason ``_zone_fill`` exists).
        Later arrivals ride the mutation path.

        Small zones seed inline (the historical semantics: precompiled
        from query one).  Past ``SEED_INLINE_MAX`` the walk moves to a
        time-budgeted background task — a million-name zone must start
        SERVING immediately; unseeded names resolve lazily until their
        chunk lands (scale-aware backpressure)."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is None \
                or len(self.zk_cache.nodes) <= self.SEED_INLINE_MAX:
            started = ACCOUNT.phase_start()
            for domain in list(self.zk_cache.nodes):
                self._seed_one(domain)
            ACCOUNT.phase_end("seed", started)
            return
        self._seed_task = loop.create_task(self._seed_chunked())

    def _seed_one(self, domain: str) -> None:
        node = self.zk_cache.nodes.get(domain)
        if node is None:
            return                      # left the mirror mid-walk
        for item in self.items_for_tag(domain):
            try:
                self._compile_one(item, native=True)
            except Exception:
                self.log.exception("precompile seed failed for %s", item)
        ip = getattr(node, "ip", None)
        if ip and type(ip) is str:
            parts = ip.split(".")
            if len(parts) == 4 and all(p.isdigit() for p in parts):
                rev = ".".join(reversed(parts)) + ".in-addr.arpa"
                try:
                    self._compile_one((Type.PTR, rev), native=True)
                except Exception:
                    self.log.exception(
                        "precompile seed failed for %s", rev)

    async def _seed_chunked(self) -> None:
        domains = list(self.zk_cache.nodes)
        self._seed_remaining = len(domains)
        self.log.info("precompile seed: %d names, chunked", len(domains))
        started = time.perf_counter()
        phase = ACCOUNT.phase_start()
        cpu_ns = 0
        i = 0
        while i < len(domains):
            t0 = time.perf_counter()
            ACCOUNT.begin(_ACT_SEED)
            try:
                while i < len(domains) \
                        and time.perf_counter() - t0 < self.DRAIN_BUDGET_S:
                    self._seed_one(domains[i])
                    i += 1
            finally:
                cpu_ns += ACCOUNT.end()
            self._seed_remaining = len(domains) - i
            await asyncio.sleep(0)
        self.log.info("precompile seed done: %d names in %.1fs",
                      len(domains), time.perf_counter() - started)
        # the seed shares the loop with serving: its CPU is its chunks'
        ACCOUNT.phase_end("seed", phase, cpu_s=cpu_ns / 1e9)

    # -- one item: plan → render variants → install --

    def _decline(self) -> None:
        self.declined += 1
        if self._m_declined is not None:
            self._m_declined.inc()

    def render_variants(self, qname: str, qtype: int, plan):
        """The full rotation-variant set for *plan*: ``(w0, w1,
        answers_summary, additionals_summary)`` per variant, in the
        deterministic rotation order — or None when the set is
        oversize or unencodable (those shapes stay lazy).  Shared with
        the verify layer's compiled-bytes check, which re-renders and
        compares byte-for-byte (``verify/checker.py``)."""
        groups = plan.groups
        if sum(len(g[0]) + len(g[1]) for g in groups) \
                > self.MAX_SET_RECORDS:
            return None                 # oversize answer set: lazy
        nv = min(len(groups), self.VARIANTS_CAP) if plan.rotatable else 1
        variants = []
        summarize = self.summarize
        try:
            for i in range(nv):
                rot = groups[i:] + groups[:i]
                answers = [r for g in rot for r in g[0]]
                adds = [r for g in rot for r in g[1]]
                w0 = self._render(qname, qtype, plan, answers, adds,
                                  False)
                if adds:
                    # answer-derived additionals sit AFTER the OPT echo
                    # (QueryCtx appends the echo at construction): the
                    # EDNS posture needs its own full encode
                    w1 = self._render(qname, qtype, plan, answers,
                                      adds, True)
                else:
                    # no additionals: the EDNS wire is the bare wire
                    # plus the echo OPT at the tail, arcount 0 -> 1 —
                    # half the encode cost on the dominant (host A,
                    # PTR, negative) mutation shapes
                    w1 = (w0[:10] + b"\x00\x01" + w0[12:]
                          + _ECHO_OPT_WIRE)
                variants.append((
                    w0, w1,
                    [summarize(r) for r in answers],
                    [summarize(r) for r in adds],
                ))
        except WireError:
            return None                 # unencodable store value: lazy
        return variants

    def _compile_one(self, item: Item, native: bool = False,
                     evidence_at: Optional[float] = None,
                     trace=None) -> None:
        """``native=True`` only on the startup seed: the C answer cache
        is COLD there, so installing the whole mirror is pure win.  The
        mutation path must NOT native-install — its sustained insert
        stream would evict the resident hot set (the C cache evicts
        oldest-inserted within a probe window), which measured as a
        ~45%% churn-throughput collapse.  Post-churn names serve from
        the Python compiled table immediately and re-enter the native
        tier through the ordinary promote-on-first-hit path once they
        prove hot.  ``evidence_at`` propagates the shape's query
        evidence (see AnswerCache.put_compiled); None on the seed.
        ``trace`` is the enqueueing mutation's propagation-trace
        context (verify/tracer.py), None outside the mutation path."""
        qtype, qname = item
        epoch = self.zk_cache.epoch
        if qtype == Type.PTR:
            plan = self.resolver.plan_ptr(qname)
        else:
            plan = self.resolver.plan(qname, qtype)
        if plan.rcode == Rcode.SERVFAIL:
            self._decline()             # never cache SERVFAIL
            return
        if plan.miss:
            # nothing to serve: with recursion the answer is
            # RD-dependent (REFUSED vs cross-DC forward) and only the
            # lazy path may decide; without it, eagerly re-rendering
            # REFUSED for every name that ever existed is unbounded
            # churn amplification (the old-address PTR shape arrives
            # here on EVERY rewrite).  Misses stay lazy — the per-key
            # cache absorbs any repeat, as it always has.
            self._decline()
            return
        variants = self.render_variants(qname, qtype, plan)
        if variants is None:
            self._decline()
            return
        if trace is not None and self.tracer is not None:
            self.tracer.observe("precompile-render", trace)
        tag = plan.dep_domain or qname
        self.answer_cache.put_compiled(
            qtype, qname, epoch, variants, rotatable=plan.rotatable,
            tag=tag, negative=plan.negative, evidence_at=evidence_at)
        if trace is not None and self.tracer is not None:
            self.tracer.observe("compiled-install", trace)
        if native and self.native_put is not None:
            self.native_put(qtype, qname, variants, tag, plan.rcode)
        self.compiled += 1
        if self._m_compiled is not None:
            self._m_compiled.inc()

    @staticmethod
    def _render(qname: str, qtype: int, plan, answers, adds,
                edns: bool) -> bytes:
        """One canonical response wire (id 0, RD clear) — byte-identical
        to what ``QueryCtx.respond`` encodes for this plan, because it
        IS the same ``Message.encode``: qr/aa set, the EDNS echo (when
        present) at the head of the additionals, full name
        compression."""
        msg = Message(
            id=0, qr=True, aa=True, rd=False, rcode=plan.rcode,
            questions=[Question(name=qname, qtype=qtype)],
            answers=list(answers),
            authorities=list(plan.authorities),
            additionals=([_ECHO_OPT] + list(adds)) if edns
            else list(adds))
        return msg.encode()

    # -- introspection (status.py `precompile` section) --

    def introspect(self) -> dict:
        return {
            "queue_depth": len(self._pending),
            "max_pending": self._max_pending(),
            "batch": self.BATCH,
            "compiled": self.compiled,
            "declined": self.declined,
            "shed": self.shed,
            "seed_remaining": self._seed_remaining,
        }
