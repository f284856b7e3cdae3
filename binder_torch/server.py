"""The binder server: transport engine + resolution + observability.

Port of the reference's ``createServer`` wiring (``lib/server.js:435-660``):
attaches the resolution engine to the transport engine's ``query`` hook,
and metrics + structured query logging to the ``after`` hook.  ``start()``
brings up UDP + TCP listeners and, when configured, the balancer UNIX
socket (``lib/server.js:609-653``).
"""
from __future__ import annotations

import asyncio
import errno as _errno
import json as _json
import logging
import os as _os
import re
import socket as _socket
import struct
import threading
import time
from urllib.parse import urlparse as _urlparse
from typing import Optional

try:  # native fast path (built by `make -C native`); optional
    from binder_torch import _binderfastio as _fastio
except ImportError:
    _fastio = None

from binder_torch.dns.query import QueryCtx
from binder_torch.dns.server import DnsServer
from binder_torch.dns.wire import (
    MAX_EDNS_PAYLOAD,
    MAX_UDP_PAYLOAD,
    ARecord,
    OPTRecord,
    PTRRecord,
    Rcode,
    SRVRecord,
    Type,
    WireError,
    encode_name,
    ip_from_reverse_name,
    patch_answer_wire,
    reverse_name_for_ip,
)
from binder_torch.metrics.collector import (
    DEFAULT_SIZE_BUCKETS,
    DEFAULT_STAGE_BUCKETS,
    MetricsCollector,
)
from binder_torch.resolver.answer_cache import AnswerCache
from binder_torch.resolver.precompile import Precompiler
from binder_torch.store.names import rec_parts as _names_rec_parts
from binder_torch.resolver.engine import (
    DEFAULT_TTL,
    Resolver,
    SERVICE_CHILD_TYPES as _SERVICE_CHILD_TYPES,
    _record_ttl as _engine_record_ttl,
)
from binder_torch.utils.jsonlog import JsonFormatter, log_event
from binder_torch.utils.probes import ProbeProvider
from binder_torch.verify import Verifier
from binder_torch.introspect.loopacct import ACCOUNT

METRIC_REQUEST_COUNTER = "binder_requests_completed"
METRIC_LATENCY_HISTOGRAM = "binder_request_latency_seconds"
METRIC_SIZE_HISTOGRAM = "binder_response_size_bytes"
# per-stage attribution: one histogram, labeled by stage, fed from the
# QueryCtx phase stamps at after-hook time — the scrapeable form of the
# query log's `timers` dict (same stage names)
METRIC_STAGE_HISTOGRAM = "binder_query_stage_seconds"

#: the loop-accounting activity (introspect/loopacct.py) of the zone
#: fill's chunks
_ACT_ZONE_FILL = ACCOUNT.activity("boot.zone-fill")

SLOW_QUERY_MS = 1000.0  # log at warn above this (lib/server.js:511-514)

# byte values a name label may contain for the native fast path; names
# outside this set are still served, just never through the C cache
# (keep in lockstep with fp_name_ok in native/fastio/fastpath.c)
_FP_NAME_OK = frozenset(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_")


def strip_suffix(suffix: str, s: str) -> str:
    """Log redaction of the (long, constant) DNS domain
    (lib/server.js:60-65)."""
    if s.endswith(suffix):
        return s[:len(s) - len(suffix)] + "..."
    return s


# Pre-encoded EDNS echo for the raw lane: name 0, TYPE OPT(41),
# CLASS=payload 1232, TTL 0, RDLEN 0 — byte-identical to the generic
# path's _ECHO_OPT (dns/query.py) encoding.
_OPT_ECHO_WIRE = b"\x00" + struct.pack(">HHIH", 41, 1232, 0, 0)

# one label of a registered srvce/proto pair, exactly what one group of
# the engine's SRV_RE can match — zone SRV entries are only pushed for
# qnames the engine would parse back to the same service
_SRV_LABEL_RE = re.compile(r"^_[^_.]*$")

# rotation-variant ceiling, in lockstep with FP_MAX_VARIANTS
# (native/fastio/fpcore.h) — a push with more variants than the C side
# accepts would be silently rejected and the name never precompiled
_FP_MAX_VARIANTS = 8

# Record types the raw lane may answer directly: exactly the host-likes
# the resolver maps to a single A record (resolver/engine.py:213-216).
# 'service' (rotation, SRV) and 'database' (URL parse) take the generic
# path.
_LANE_HOST_TYPES = frozenset({
    "db_host", "host", "load_balancer", "moray_host", "redis_host",
    "ops_host", "rr_host",
})


def _rec_ttl(rec: tuple) -> int:
    """Deepest-object-wins TTL for a COMPACT record tuple
    (store/names.py) — sub-record TTL wins, else record TTL, else
    default; the compact invariant guarantees ints, so there is no
    garbage case to decline on."""
    parts = _names_rec_parts(rec)
    if parts[3] is not None:
        return parts[3]
    if parts[2] is not None:
        return parts[2]
    return DEFAULT_TTL


def _lane_ttl(record: dict, sub) -> Optional[int]:
    """Deepest-object-wins TTL (the one policy, engine._record_ttl:
    sub-record TTL wins, else record TTL, else default); None means the
    store value is garbage and the lane must decline to the generic
    path.  Shared by the A and PTR lane branches so the precedence
    cannot drift between them."""
    ttl = record.get("ttl")
    sttl = sub.get("ttl") if type(sub) is dict else None
    if sttl is not None:
        ttl = sttl
    elif ttl is None:
        ttl = DEFAULT_TTL
    return ttl if type(ttl) is int else None


def _fastpath_key_parts(rd: bool, edns: bool, payload: int, qtype: int,
                        qclass: int, qname_wire: bytes) -> bytes:
    """The native answer-cache key, from its components.

    SINGLE SOURCE OF THE LAYOUT on the Python side — both
    ``BinderServer._fastpath_key`` and the raw lane build through here.
    Must stay byte-for-byte with ``fp_build_key`` in
    native/fastio/fastpath.c and the balancer's copy (see
    docs/balancer-protocol.md):
    ``[flags rd|edns<<1][payload BE16][qtype BE16][qclass BE16][qname]``
    where qname is the wire-format name, lowercased.
    """
    return (bytes([(1 if rd else 0) | (2 if edns else 0)])
            + payload.to_bytes(2, "big") + qtype.to_bytes(2, "big")
            + qclass.to_bytes(2, "big") + qname_wire)


class BinderServer:
    def __init__(self, *, zk_cache, dns_domain: str,
                 datacenter_name: str = "",
                 recursion=None,
                 log: Optional[logging.Logger] = None,
                 collector: Optional[MetricsCollector] = None,
                 name: str = "binder",
                 host: str = "127.0.0.1", port: int = 53,
                 balancer_socket: Optional[str] = None,
                 query_log: bool = True,
                 cache_size: int = 10000,
                 cache_expiry_ms: int = 60000,
                 zone_precompile: bool = True,
                 answer_precompile: bool = False,
                 precompile_size: Optional[int] = None,
                 tcp_idle_timeout: Optional[float] = None,
                 max_tcp_conns: Optional[int] = None,
                 max_tcp_write_buffer: Optional[int] = None,
                 probes: Optional[ProbeProvider] = None,
                 flight_recorder=None,
                 degradation: Optional[dict] = None,
                 admission: Optional[dict] = None,
                 rrl: Optional[dict] = None,
                 verify: Optional[dict] = None,
                 reuse_port: bool = False,
                 announce: bool = True) -> None:
        self.log = log or logging.getLogger("binder.server")
        # introspection flight recorder (binder_torch/introspect):
        # slow-query events from the after hook and lane, resolver
        # errors from the engine's error path
        self.recorder = flight_recorder
        self.host = host
        self.port = port
        # shard mode (binder_torch/shard): N workers bind ONE port via
        # SO_REUSEPORT and the supervisor owns the canonical "service
        # started" announce lines — workers keep quiet so launchers
        # never latch onto a group still forming
        self.reuse_port = reuse_port
        self.announce = announce
        self.dns_domain = dns_domain
        self.balancer_socket = balancer_socket
        self.collector = collector or MetricsCollector()
        # per-query logging can be disabled for high-qps deployments;
        # slow queries (>1s) are logged regardless
        self.query_log = query_log
        # encoded-answer cache (the reference's -s/-a flags, main.js:34-38)
        self.zk_cache = zk_cache
        self.answer_cache = AnswerCache(
            size=cache_size, expiry_ms=cache_expiry_ms,
            compiled_size=precompile_size,
            # tag/qname strings dedup against the mirror's own domain
            # objects (the interned-name pool architecture)
            intern=getattr(zk_cache, "canon", None))
        self.cache_hit_counter = self.collector.counter(
            "binder_answer_cache_hits", "encoded-answer cache hits")
        self._cache_hit_child = self.cache_hit_counter.labelled()
        self._fp_inval_total = 0   # C-side drops, updated at each fold
        self.collector.gauge(
            "binder_answer_cache_invalidations",
            "answer-cache entries dropped by per-name store invalidation"
        ).set_function(lambda: float(self.answer_cache.invalidations
                                     + self._fp_inval_total))

        self.request_counter = self.collector.counter(
            METRIC_REQUEST_COUNTER, "count of Binder requests completed")
        self.latency_histogram = self.collector.histogram(
            METRIC_LATENCY_HISTOGRAM,
            "total time to process Binder requests")
        self.size_histogram = self.collector.histogram(
            METRIC_SIZE_HISTOGRAM, "size in bytes of Binder responses",
            buckets=DEFAULT_SIZE_BUCKETS)
        self.stage_histogram = self.collector.histogram(
            METRIC_STAGE_HISTOGRAM,
            "per-stage decomposition of request processing time",
            buckets=DEFAULT_STAGE_BUCKETS)
        # per-qtype pre-resolved metric handles (label-sort once, not
        # per query); key is the numeric qtype
        self._metric_children: dict = {}
        # per-stage pre-resolved histogram handles, keyed by stage name
        self._stage_children: dict = {}

        # USDT analog: provider 'binder', probes op-req-start/op-req-done
        # fired with the query context (lib/server.js:24-29,472-474,516-518)
        self.probes = probes or ProbeProvider("binder")
        self.p_req_start = self.probes.probe("op-req-start")
        self.p_req_done = self.probes.probe("op-req-done")

        self.resolver = Resolver(zk_cache, dns_domain=dns_domain,
                                 datacenter_name=datacenter_name,
                                 recursion=recursion, log=self.log)

        # Degradation policy engine (binder_torch/policy, docs/
        # degradation.md).  Off by default at this layer — main.py
        # turns both on from config (`degradation` / `admission`
        # blocks, default enabled) like the other production knobs.
        self._policy = None
        self._policy_task = None
        store = getattr(zk_cache, "store", None)
        if (degradation is not None
                and degradation.get("enabled", True) and store is not None):
            from binder_torch.policy import DegradationPolicy
            self._policy = DegradationPolicy(
                store=store, zk_cache=zk_cache,
                max_staleness_s=float(degradation.get(
                    "maxStalenessSeconds", 300.0)),
                stale_ttl_clamp_s=int(degradation.get(
                    "staleTtlClampSeconds", 30)),
                exhausted_action=str(degradation.get(
                    "exhaustedAction", "servfail")),
                collector=self.collector, recorder=flight_recorder,
                log=self.log)
            # answers rendered under one staleness mode must never be
            # served under another: every transition flushes all cached
            # lanes (Python, compiled, native, balancer) via the epoch
            self._policy.on_transition(self._on_degradation_transition)
            self.resolver.policy = self._policy
        self._admission = None
        if admission is not None and admission.get("enabled", True):
            from binder_torch.policy import AdmissionControl
            self._admission = AdmissionControl(
                max_inflight=int(admission.get("maxInflight", 512)),
                recursion_rate=float(admission.get(
                    "recursionRate", 50.0)),
                recursion_burst=float(admission.get(
                    "recursionBurst", 100.0)),
                collector=self.collector, recorder=flight_recorder,
                log=self.log)
            self.resolver.admission = self._admission
        # Response rate limiting (binder_torch/policy/rrl.py): per-client-
        # prefix slip/drop at the UDP ingress.  Same config convention as
        # admission — None disables (direct construction / tests), a
        # config block (even empty) enables with defaults.
        self._rrl = None
        if rrl is not None:
            from binder_torch.policy import ResponseRateLimiter
            self._rrl = ResponseRateLimiter.from_config(
                rrl,
                note_shed=(self._admission._note_shed
                           if self._admission is not None else None),
                recorder=flight_recorder, log=self.log)
        self._rrl_children: dict = {}
        self._rrl_folded: dict = {}
        if self._rrl is not None:
            for field, help_text in (
                ("responses", "UDP responses admitted by response rate "
                 "limiting"),
                ("slipped", "rate-limited UDP queries answered with a "
                 "TC=1 slip (client retries over TCP)"),
                ("dropped", "rate-limited UDP queries dropped silently"),
                ("evictions", "RRL prefix buckets evicted at the LRU "
                 "cap"),
                ("allowlisted", "responses passed by an RRL allowlist "
                 "match (never limited, never bucketed)"),
                ("adaptations", "adaptive-bucket rate doublings earned "
                 "by TCP-proven prefixes"),
                ("false_positives", "rate-limited responses charged to "
                 "a prefix later proven real by completed TCP retries "
                 "(the measured RRL false-positive count)"),
            ):
                child = self.collector.counter(
                    "binder_rrl_" + field + "_total", help_text).labelled()
                child.inc(0)   # series exists from scrape 1
                self._rrl_children[field] = child
            self.collector.gauge(
                "binder_rrl_buckets",
                "client prefixes currently tracked by response rate "
                "limiting"
            ).set_function(lambda: float(len(self._rrl._buckets)))
            self.collector.gauge(
                "binder_rrl_active",
                "1 while response rate limiting shed traffic recently "
                "(the hostile-flood posture; also closes the native "
                "fastpath gate)"
            ).set_function(lambda: 1.0 if self._rrl.hot() else 0.0)
            self.collector.gauge(
                "binder_rrl_adapted_buckets",
                "client prefixes holding an earned adaptive rate "
                "multiplier (TCP-proven NAT'd farms)"
            ).set_function(lambda: float(self._rrl.adapted_count()))
        if recursion is not None and hasattr(recursion, "engine_after"):
            # arm the recursion fast path: its future callback completes
            # the query AND runs the engine's after hook itself
            recursion.engine_after = self._engine_after_hook
        # multi-DC federation handle (binder_torch/federation) — set by
        # main.py (or tests) after construction; read by the
        # introspector for the /status federation section
        self.federation = None

        # Serving-plane verification (binder_torch/verify):
        # incremental invariant checks off the same per-name
        # invalidation feed the precompiler drains, a sampled
        # budgeted full-zone audit, and mutation-to-glass propagation
        # tracing.  Same config convention as admission/rrl: None
        # disables (direct construction / tests), a config block
        # (even empty) enables with defaults.
        self._verify: Optional[Verifier] = None
        # trace contexts for names awaiting a zone re-push, popped by
        # _zone_refresh to mark the native-install stage; bounded so a
        # mutation storm on an unserved zone cannot grow it
        self._zone_trace: dict = {}
        if verify is not None and verify.get("enabled", True):
            self._verify = Verifier(
                zk_cache=zk_cache, answer_cache=self.answer_cache,
                resolver=self.resolver,
                policy_mode=(self._policy.mode
                             if self._policy is not None else None),
                config=verify, collector=self.collector,
                recorder=flight_recorder, log=self.log)
            # the mirror stamps each mutation's trace context at
            # bump_gen and marks mirror-apply at invalidation fan-out
            zk_cache.tracer = self._verify.tracer

        # Mutation-time answer precompilation (resolver/precompile.py):
        # store mutations eagerly re-render the affected names' answers
        # into the AnswerCache's compiled table, so post-churn (and
        # seeded cold) queries are a dict probe + ID/flags patch instead
        # of an engine.resolve() pass.  Off by default at this layer —
        # main.py turns it on from config (`answerPrecompile`, default
        # true) like the other production knobs.
        self._precompiler: Optional[Precompiler] = None
        if answer_precompile and cache_size > 0:
            self._precompiler = Precompiler(
                resolver=self.resolver, answer_cache=self.answer_cache,
                zk_cache=zk_cache, summarize=self._summarize,
                collector=self.collector, recorder=flight_recorder,
                log=self.log, native_put=self._precompile_native_put,
                tracer=(self._verify.tracer
                        if self._verify is not None else None))
        if self._verify is not None:
            # the checker re-renders through the precompiler for the
            # compiled-bytes invariant (None: skip-counted, not silent)
            self._verify.precompiler = self._precompiler
        self._precompile_serve_child = self.collector.counter(
            "binder_precompile_serves",
            "queries answered from mutation-time precompiled entries"
        ).labelled()
        self._precompile_serve_child.inc(0)   # series exists from scrape 1
        self.engine = DnsServer(log=self.log, name=name,
                                tcp_idle_timeout=tcp_idle_timeout,
                                max_tcp_conns=max_tcp_conns,
                                max_tcp_write_buffer=max_tcp_write_buffer)
        self.engine.on_query = self._on_query
        self.engine.on_after = self._on_after
        self.engine.recorder = flight_recorder
        self.engine.admission = self._admission
        self.engine.rrl = self._rrl
        # the engine's cap-refusal log line is rate-limited, so the
        # counter is the only complete record — surface it in the scrape
        self._cap_refusal_child = self.collector.counter(
            "binder_tcp_cap_refusals",
            "TCP connections refused at the connection cap").labelled()
        self._cap_refusal_child.inc(0)   # series exists from scrape 1
        self._cap_folded = 0
        # late (async-completed) UDP responses dropped at a full socket
        # buffer — previously a silent debug line
        late_drops = self.collector.counter(
            "binder_udp_late_drops_total",
            "late (async-completed) UDP responses dropped because the "
            "socket send buffer stayed full through the retry").labelled()
        late_drops.inc(0)                # series exists from scrape 1
        self.engine.late_drop_counter = late_drops
        # stream-lane counters (dns/stream.py TcpStats), folded at
        # scrape time like the cap refusals; every series exists from
        # scrape 1 so absence is always an exporter bug
        # (tools/lint.py validate_tcp_metrics pins the family)
        self._tcp_stat_children: dict = {}
        for field, help_text in (
            ("accepts", "TCP connections accepted"),
            ("fast_serves", "frames served via the accept fast path "
             "(connections not yet promoted to the pipelined protocol)"),
            ("promotions", "TCP connections promoted to the full "
             "pipelined protocol (kept sending after the first served "
             "burst)"),
            ("oneshot_closes", "TCP connections closed after serving "
             "without ever promoting (one-shot clients)"),
            ("idle_timeouts", "TCP connections dropped by the idle "
             "deadline"),
            ("slow_reader_drops", "TCP connections disconnected at the "
             "write-buffer cap (client not reading responses)"),
            ("coalesced_writes", "vectored TCP writes that carried "
             "more than one response frame"),
            ("coalesced_frames", "TCP response frames sent through "
             "coalesced vectored writes"),
            ("half_closes", "half-closed TCP connections held to "
             "serve owed responses"),
            ("rst_drops", "TCP connections dropped on reset/error "
             "mid-read"),
        ):
            child = self.collector.counter("binder_tcp_" + field,
                                           help_text).labelled()
            child.inc(0)
            self._tcp_stat_children[field] = child
        self._tcp_stats_folded: dict = {}
        self.collector.gauge(
            "binder_tcp_open_conns",
            "TCP client connections currently open"
        ).set_function(lambda: float(len(self.engine._tcp_conns)))
        self.collector.on_expose(self._fold_engine_counters)

        # Raw resolve lane: direct wire assembly for single-question A/IN
        # queries (see _raw_lane).  Policy strings mirror Resolver.resolve
        # exactly; the lane declines anything it can't prove simple.
        dd = self.resolver.dns_domain
        self._lane_suffix = ("." + dd) if dd else None
        self._lane_dcsuff = dd + "." + self.resolver.datacenter_name
        self.engine.raw_lane = self._raw_lane

        # Native fast path: answer-cache hits served inside the C UDP
        # drain (native/fastio/fastpath.c).  Python remains the source of
        # truth — completed answer-cache entries are pushed down in
        # _on_query, and the C-side counters fold into the same
        # Prometheus collectors at scrape time (_fold_fastpath_metrics).
        # Balancer answer-cache support: the generation report carries
        # the mirror *epoch* (full-rebuild counter), so the balancer
        # only drops everything when a re-mirror really happened;
        # ordinary mutations ride the per-name invalidate frames
        # broadcast from _on_store_invalidate
        # (docs/balancer-protocol.md control frames)
        self.engine.gen_source = self._epoch_source
        if hasattr(zk_cache, "on_mutation"):
            zk_cache.on_mutation(self.engine.notify_mutation)
        # Per-name invalidation: a mirrored mutation drops exactly the
        # answer-cache/fast-path entries whose dependency tag it touched
        # (MirrorCache.invalidate); the epoch (bumped on full rebuilds)
        # covers everything else.  One churning record no longer evicts
        # every cached answer.
        if hasattr(zk_cache, "on_invalidate"):
            zk_cache.on_invalidate(self._on_store_invalidate)

        self._fastpath = None
        self._fp_folded: dict = {}
        self._fp_last_stats: dict = {}   # per-scrape snapshot (gauges)
        self._fp_fold_lock = threading.Lock()
        if (_fastio is not None and cache_size > 0
                and hasattr(_fastio, "fastpath_new")):
            self._fastpath = _fastio.fastpath_new(
                cache_size, cache_expiry_ms,
                [float(b) for b in self.latency_histogram.buckets],
                [float(b) for b in self.size_histogram.buckets])
            self.engine.fastpath = self._fastpath
            self.engine.fastpath_gen = self._epoch_source
            self.engine.fastpath_gate = self._fastpath_active
            self.collector.on_expose(self._fold_fastpath_metrics)

        # Native query-log ring: with per-query logging ON (the
        # reference's always-on posture, lib/server.js:537-591) the fast
        # path previously stood down completely, forfeiting ~9x
        # throughput.  Instead, entries now carry pre-rendered JSON log
        # fragments, the C serve path appends one complete bunyan-style
        # line per serve to a byte ring, and Python drains the ring in
        # batches onto the SAME stream the JSON logger writes to — one
        # stream write per batch instead of one formatting pass per
        # query.  A serve that cannot produce its line (ring full, no
        # fragment) DECLINES to the Python path, which logs normally:
        # pressure degrades throughput, never drops log records.
        # Armed only when the server's logger actually ends in a
        # JsonFormatter stream (the production logger from make_logger);
        # otherwise the old stand-down gating applies unchanged.
        self._log_ring = False
        self._log_json_handlers: list = []
        self._log_flush_task: Optional[asyncio.Task] = None
        if (self.query_log and self._fastpath is not None
                and hasattr(_fastio, "fastpath_log_enable")
                and self.log.isEnabledFor(logging.INFO)):
            self._log_json_handlers = self._find_json_handlers()
            if self._log_json_handlers:
                try:
                    _fastio.fastpath_log_enable(
                        self._fastpath, self._native_log_prefix(),
                        1 << 20)
                    self._log_ring = True
                    self.engine.fastpath_log_flush = self._drain_native_log
                except ValueError:
                    self._log_json_handlers = []

        # Zone precompilation (fpcore.h zone table): finished answer
        # bodies for the dominant record shapes (host A, PTR) are pushed
        # into the C drain from the STORE MIRROR — at startup and on
        # every mirrored mutation — so even the first query for a name
        # never surfaces to Python.  The reference resolves every cold
        # name per query (lib/server.js:136); this is the rebuild's
        # NSD/Knot-style answer to that.  `zonePrecompile: false`
        # disables it (the bench uses that to keep an honest measurement
        # of the Python resolve path).
        self._zone_enabled = (
            zone_precompile and self._fastpath is not None
            and hasattr(_fastio, "fastpath_zone_put"))
        # churn-path coalescing: batched C invalidation + deferred zone
        # refills (see _on_store_invalidate)
        self._fp_inval_many = getattr(_fastio, "fastpath_invalidate_many",
                                      None)
        self._zone_dirty: set = set()
        self._zone_drain_pending = False
        self._zone_fill_task = None
        self.zone_serve_counter = self.collector.counter(
            "binder_zone_serves",
            "queries answered from precompiled zone entries")
        self._zone_serve_child = self.zone_serve_counter.labelled({})
        if self._fastpath is not None:
            # Residency gauges: operators watching a mirror fill (or an
            # epoch rebuild) can see the native tables converge.  All
            # four read the single snapshot _fold_fastpath_metrics takes
            # per scrape (it runs as a pre-expose hook) — one stats
            # build per scrape, not one per gauge.
            def _fp_stat(key):
                return lambda: float(self._fp_last_stats.get(key, 0))
            self.collector.gauge(
                "binder_zone_entries",
                "precompiled answers resident in the native zone tables"
            ).set_function(_fp_stat("zone_entries"))
            self.collector.gauge(
                "binder_zone_bytes",
                "bytes held by precompiled zone answer bodies"
            ).set_function(_fp_stat("zone_bytes"))
            self.collector.gauge(
                "binder_fastpath_entries",
                "entries resident in the native answer cache"
            ).set_function(_fp_stat("entries"))
            self.collector.gauge(
                "binder_fastpath_bytes",
                "bytes held by native answer-cache wires"
            ).set_function(_fp_stat("bytes"))

        # actual bound ports (for tests / ephemeral binds)
        self.udp_port: Optional[int] = None
        self.tcp_port: Optional[int] = None

    def _engine_after_hook(self, query: QueryCtx) -> None:
        """After-hook entry for self-completing paths (the recursion
        fast path) — identical semantics to the engine's post-task
        _after call."""
        self.engine._after(query)

    def _epoch_source(self) -> int:
        """The epoch every cached lane validates against — evaluated
        THROUGH the degradation policy, so a lazy state transition
        (and its epoch-bumping cache flush) lands before the epoch is
        read.  Without this ordering, the first post-session-loss
        query could serve an unclamped cached wire from the native
        drain before any Python path noticed the transition."""
        if self._policy is not None:
            self._policy.mode()
        return self.zk_cache.epoch

    def _on_degradation_transition(self, old: str, new: str) -> None:
        """Degradation state edge: flush every cached answer lane.  The
        epoch bump invalidates the Python answer cache, the compiled
        table, the native C caches, and (via the generation frame) the
        balancer — so a wire rendered fresh is never served into
        exhaustion and clamped-TTL stale wires never survive recovery."""
        self.zk_cache.invalidate_all(
            reason=f"degradation {old} -> {new}")

    async def _policy_tick_loop(self) -> None:
        """1 s degradation-policy evaluator: transitions (and their
        metrics / flight-recorder events) must fire on an idle binder
        too, not only when a query happens to ask."""
        while True:
            await asyncio.sleep(1.0)
            try:
                self._policy.tick()
            except Exception:
                self.log.exception("degradation policy tick failed")

    # -- query hook (lib/server.js:471-507); sync, may return an awaitable
    # for the recursion path (see DnsServer._dispatch) --

    def _on_query(self, query: QueryCtx):
        if self.query_log:
            # log lines need decoded answer summaries: response paths
            # that would shortcut decoding (recursion splice) must not
            query.want_log_detail = True
        if self.p_req_start.enabled:   # skip closure alloc when off
            self.p_req_start.fire(lambda: {
                "trace": query.trace_id,
                "id": query.request.id, "name": query.name(),
                "type": query.qtype_name(), "client": query.src[0],
                "protocol": query.protocol,
            })
        # Answer-cache fast path.  The key is built from the decoded
        # fields the response actually depends on — transport semantics
        # (truncation), RD (drives the recursion-vs-REFUSED split on
        # misses), question, EDNS presence and payload ceiling — NOT the
        # raw wire: wire bytes vary with per-packet EDNS options (DNS
        # cookies, padding) and ignored padding sections, which would
        # mint one key per packet and evict the real entries.
        key = None
        req = query.request
        if len(req.questions) == 1 and req.opcode == 0:
            q0 = req.questions[0]
            key = (query.udp_semantics, req.rd, q0.qtype, q0.qclass,
                   q0.name, req.edns is not None, req.max_udp_payload())
            # policy-aware epoch: a pending degradation transition must
            # flush the caches BEFORE this probe can hit
            cached = self.answer_cache.get(key, self._epoch_source())
            if cached is not None:
                wire, ans, add = cached
                self._cache_hit_child.inc()
                query.response.rcode = wire[3] & 0x0F  # for metrics/logs
                query.log_ctx["cached"] = True
                query.cached_summary = (ans, add)
                query.stamp("cache-hit")   # decode→probe→serve, whole hit
                query.respond_raw(wire)
                # promote-on-first-hit: a repeat proves the name is hot,
                # so hand the entry to the C fast path NOW (resolve-time
                # pushes made one-shot cold names pay the native-push
                # cost for entries never served again)
                if (query.udp_semantics and self._fastpath is not None
                        and self._fastpath_active()):
                    self._fastpath_push(key, self.zk_cache.epoch, query)
                return None

        # Mutation-time precompiled probe: a per-key miss whose answer
        # was re-rendered at mutation time (or seeded at start) serves
        # as a dict probe + ID/flags patch — the engine never runs.
        if key is not None and self._serve_compiled(query, key, q0):
            return None

        pending = self.resolver.handle(query)

        if (pending is None and key is not None and query.responded
                and query.wire is not None and not query.no_store
                and query.rcode() != Rcode.SERVFAIL):
            ans = [self._summarize(r) for r in query.response.answers]
            add = [self._summarize(r) for r in query.response.additionals
                   if not isinstance(r, OPTRecord)]
            # reused by _on_after for this query's own log line too —
            # summaries are built exactly once per resolve
            query.cached_summary = (ans, add)
            epoch = self.zk_cache.epoch
            # dependency tag: the store name this answer derives from
            # (set by the resolver at its lookup points); immutable
            # shapes (out-of-suffix REFUSED, NOTIMP) never consulted the
            # store, but tagging them with their own qname is harmless —
            # no mutation will ever emit it.  The native push happens at
            # the entry's first HIT (promote-on-first-hit above), never
            # here on the cold path.
            tag = query.dep_domain or q0.name
            rcode = query.rcode()
            self.answer_cache.put(
                key, epoch, (query.wire, ans, add),
                rotatable=len(query.response.answers) > 1, tag=tag,
                # negative answers (NXDOMAIN / NODATA) cache like
                # positives but are accounted separately; SERVFAIL is
                # excluded above — the never-cache rule
                negative=(rcode == Rcode.NXDOMAIN
                          or (rcode == Rcode.NOERROR
                              and not query.response.answers)),
                qkey=(q0.qtype, q0.name))
        return pending

    #: the client postures precompiled answers are installed under in
    #: the NATIVE answer cache: (rd, edns, effective payload).  These
    #: are the request shapes resolvers actually send (EDNS at the
    #: 1232 safe default, classic 512 without); anything else (odd
    #: payload advertisements, options) falls to the Python compiled
    #: probe, which serves every posture by patching.
    _NATIVE_POSTURES = ((False, False, MAX_UDP_PAYLOAD),
                        (True, False, MAX_UDP_PAYLOAD),
                        (False, True, 1232),
                        (True, True, 1232))

    def _precompile_native_put(self, qtype: int, qname: str, variants,
                               tag: str, rcode: int) -> None:
        """Install a precompiled answer set into the NATIVE answer
        cache, one entry per canonical client posture — the
        mutation-time analog of promote-on-first-hit.  The hit path IS
        the C drain; installing at mutation time makes the post-churn
        (and seeded cold) miss path take it from query one.  Pure
        optimization: every failure path simply leaves the name to the
        Python compiled probe.  Unlike query-path promotion, the push
        cost lands on the mutation drain, never on a query."""
        if self._fastpath is None:
            return
        qn = self._qname_wire(qname)
        tag_wire = self._qname_wire(tag)
        if qn is None or tag_wire is None:
            return
        # the C key builder only produces hostname-charset keys; an
        # install outside that set could never be probed
        i = 0
        while qn[i]:
            ll = qn[i]
            if not _FP_NAME_OK.issuperset(qn[i + 1:i + 1 + ll]):
                return
            i += 1 + ll
        frags = None
        if self._log_ring:
            # native serves must produce the same log line the Python
            # compiled serve would ({"precompiled": true} + summaries)
            frags = [self._log_frag({"precompiled": True}, rcode,
                                    v[2], v[3]) for v in variants]
            if any(f is None for f in frags):
                return                  # unloggable: stays in Python
        epoch = self.zk_cache.epoch
        for rd, edns, payload in self._NATIVE_POSTURES:
            wires = [patch_answer_wire(v[1] if edns else v[0], rd=rd)
                     for v in variants]
            if any(len(w) > payload for w in wires):
                continue    # truncation shapes: the generic path owns TC
            ckey = _fastpath_key_parts(rd, edns, payload, qtype, 1, qn)
            try:
                if frags is not None:
                    _fastio.fastpath_put(self._fastpath, ckey, qtype,
                                         epoch, wires, -1, tag_wire,
                                         frags)
                else:
                    _fastio.fastpath_put(self._fastpath, ckey, qtype,
                                         epoch, wires, -1, tag_wire)
            except (TypeError, ValueError, MemoryError) as e:
                self.log.debug("precompile native push skipped: %s", e)
                return

    def _serve_compiled(self, query: QueryCtx, key, q0) -> bool:
        """Serve one query from the compiled-answer table, if present:
        select the EDNS posture's pre-rendered wire, patch the RD bit
        (the ID and question case are patched by respond_raw as for any
        cached wire), respond, and install the result under the query's
        exact key so repeats take the plain hit path (and promote to the
        native fast path on their first hit, same economics as lazy
        entries).  Declines (False) when the table has no entry or the
        wire would need UDP truncation — the generic path owns those."""
        if q0.qclass != 1:
            return False
        epoch = self.zk_cache.epoch
        hit = self.answer_cache.get_compiled(q0.qtype, q0.name, epoch)
        if hit is None:
            return False
        (w0, w1, ans, add), rotatable, tag, negative = hit
        req = query.request
        wire = w1 if req.edns is not None else w0
        if query.udp_semantics and len(wire) > req.max_udp_payload():
            return False
        if req.rd:
            wire = patch_answer_wire(wire, rd=True)
        query.response.rcode = wire[3] & 0x0F   # for metrics/logs
        query.log_ctx["precompiled"] = True
        query.cached_summary = (ans, add)
        query.stamp("precompile-hit")   # decode→probe→patch, whole serve
        query.respond_raw(wire)
        self._precompile_serve_child.inc()
        try:
            self.answer_cache.put(
                key, epoch, (wire, ans, add), rotatable=rotatable,
                tag=tag, negative=negative, qkey=(q0.qtype, q0.name))
        except Exception:
            # response already sent: bookkeeping must not re-raise into
            # the dispatch path (it would SERVFAIL a served query)
            self.log.exception("compiled-serve bookkeeping failed")
        return True

    @staticmethod
    def _qname_wire(name: str) -> Optional[bytes]:
        """Lowercased wire label form of a dotted name — the dependency
        tag format shared with the C caches (fpcore.h fp_invalidate_tag).
        Delegates to the one real name encoder (wire.encode_name, which
        normalizes case and enforces label/name bounds); None for names
        that cannot appear as a C-side tag."""
        buf = bytearray()
        try:
            encode_name(name, buf, None)
        except (WireError, UnicodeEncodeError):
            return None
        return bytes(buf)

    def _on_store_invalidate(self, tags) -> None:
        """MirrorCache invalidation subscriber: drop the cached answers
        whose dependency tag a store mutation touched — in the Python
        answer cache, the native fast path (one batched table pass for
        the whole event, not one scan per tag), and (via opcode-1
        control frames) the balancer's cache.  The DROPS are synchronous
        (coherence: a stale answer must never survive its mutation);
        the zone RE-PUSHES are refill work and are deferred to a
        bounded dirty-set drain between serving batches, so a mutation
        burst can't stall the hot loop.  Until a
        name's refresh runs, its queries resolve through the raw lane /
        generic path — slower, never stale."""
        wires = []
        # question shapes the drops touched — the precompiler's exact
        # re-render work list (concrete negative SRV qnames, postures)
        dropped: list = []
        for tag in tags:
            self.answer_cache.invalidate_tag(tag, dropped=dropped)
            wire = self._qname_wire(tag)
            if wire is not None:
                wires.append(wire)
        if wires and self._fastpath is not None:
            try:
                if self._fp_inval_many is not None:
                    self._fp_inval_many(self._fastpath, wires)
                else:   # older extension: per-tag fallback
                    for wire in wires:
                        _fastio.fastpath_invalidate(self._fastpath, wire)
            except (TypeError, ValueError):
                pass
        if wires:
            self.engine.notify_invalidate(wires)
        if self._precompiler is not None and dropped:
            # refill work, deferred and bounded like the zone drain; the
            # DROPS above were synchronous, so until a name's re-render
            # runs its queries resolve lazily — slower, never stale.
            # Only shapes with serving evidence (the dropped keys) are
            # re-rendered: churn on unqueried names costs nothing here.
            self._precompiler.enqueue(dropped)
        if self._verify is not None:
            # incremental verification rides the same feed (after the
            # drops and re-render enqueue: the checker sees the
            # post-mutation tables, never the stale ones)
            self._verify.enqueue_tags(tags)
            ctx = self._verify.tracer.current
            if ctx is not None and self._zone_enabled:
                zt = self._zone_trace
                for tag in tags:
                    zt[tag] = ctx
                while len(zt) > self._ZONE_TRACE_CAP:
                    del zt[next(iter(zt))]
        if self._zone_enabled:
            self._zone_dirty.update(tags)
            self._schedule_zone_drain()

    #: zone re-pushes drained per event-loop pass; bounds the refill
    #: work a mutation burst can inject between serving batches
    _ZONE_DRAIN_BATCH = 64

    #: pending native-install trace contexts retained (oldest dropped
    #: first — an evicted trace loses one stage sample, nothing else)
    _ZONE_TRACE_CAP = 4096

    def _schedule_zone_drain(self) -> None:
        if self._zone_drain_pending or not self._zone_dirty:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no loop (synchronous setup paths): refresh inline
            dirty, self._zone_dirty = self._zone_dirty, set()
            for tag in dirty:
                self._zone_refresh(tag)
            return
        self._zone_drain_pending = True
        loop.call_soon(self._drain_zone_dirty)

    @ACCOUNT.spans("zone-refresh")
    def _drain_zone_dirty(self) -> None:
        self._zone_drain_pending = False
        n = 0
        while self._zone_dirty and n < self._ZONE_DRAIN_BATCH:
            self._zone_refresh(self._zone_dirty.pop())
            n += 1
        if self._zone_dirty:
            # more pending: yield to I/O first (call_soon callbacks
            # added during a loop pass run on the NEXT pass)
            self._schedule_zone_drain()
        else:
            # a set keeps the table it grew to, and pop() walks that
            # table from where the last pop stopped: after a zone fill
            # (two entries per name) every later mutation's pop would
            # scan the whole fill's slots, so start from a small set
            self._zone_dirty = set()

    # -- zone precompilation (fpcore.h zone table) --

    def _zone_refresh(self, name: str) -> None:
        """(Re-)push the precompiled answer for one store name, if the
        mirror currently resolves it to a shape the zone table serves.
        Stale entries were already dropped by tag invalidation; absent
        or ineligible names simply stay un-pushed and resolve through
        the raw lane / generic path."""
        ctx = self._zone_trace.pop(name, None)
        try:
            if name.endswith(".in-addr.arpa") or name.endswith(".ip6.arpa"):
                if name.endswith(".ip6.arpa"):
                    # v6 reverse: canonical nibble parse; the PTR body
                    # is address-family-agnostic once the owner is found
                    ip = ip_from_reverse_name(name)
                    if ip is None:
                        return
                else:
                    parts = name.split(".")
                    if len(parts) < 3:
                        return
                    ip = ".".join(reversed(parts[:-2]))
                owner = self.zk_cache.reverse_lookup(ip)
                if owner is not None:
                    self._zone_push_ptr(name, owner)
            else:
                node = self.zk_cache.lookup(name)
                if node is None:
                    pass
                elif (type(node.rec) is dict
                        and node.rec.get("type") == "service"):
                    self._zone_push_service_a(name, node)
                    self._zone_push_service_srv(name, node)
                else:
                    self._zone_push_a(name, node)
        except Exception:
            # zone fill is an optimization: a push failure must never
            # break the mutation path that feeds it
            self.log.exception("zone push failed for %s", name)
        if ctx is not None and self._verify is not None:
            # the zone lane finished with this name — for a mutation's
            # trace that is "the glass shows it" (even a now-ineligible
            # name: its stale native entry is gone, which is the state
            # the zone table should serve)
            self._verify.tracer.observe("native-install", ctx)

    # -- chaos injection hooks (chaos/plan.py corrupt-answer /
    # drop-reverse; the chaos driver dispatches on these method names) --

    def corrupt_answer(self, qname: Optional[str] = None):
        """Flip one byte mid-wire in a compiled-table entry's first
        rotation variant.  Direct table corruption fires NO
        invalidation — only the verify audit's compiled-bytes walk can
        find it, which is exactly what the chaos action exists to
        prove.  Returns the corrupted ``(qtype, qname)`` or None."""
        for ckey, e in self.answer_cache._compiled.items():
            if qname is not None and ckey[1] != qname:
                continue
            variants = e[2]
            if not variants:
                continue
            v = variants[0]
            if len(v[0]) <= 12:
                continue                # header-only wire: nothing to flip
            w0 = bytearray(v[0])
            w0[len(w0) // 2] ^= 0xFF
            variants[0] = (bytes(w0),) + tuple(v[1:])
            self.log.warning("chaos: corrupted compiled answer for %s",
                             ckey[1])
            return ckey
        return None

    def drop_reverse(self, ip: Optional[str] = None):
        """Delete one reverse-map entry without touching the forward
        node — the forward/reverse coherence break the ptr-coherence
        audit must catch (no invalidation fires here either).
        Returns the dropped address or None."""
        rl = self.zk_cache.rev_lookup
        if ip is None:
            ip = next(iter(rl), None)
        if ip is None or ip not in rl:
            return None
        node = rl.pop(ip)
        self.log.warning("chaos: dropped reverse entry %s -> %s",
                         ip, getattr(node, "domain", "?"))
        return ip

    def _zone_host_shape(self, node):
        """(record, sub, packed_addr, ttl) when `node` is a host-like
        record the raw lane would answer, else None — the eligibility
        rules are _raw_lane's, verbatim, so the zone table can never
        answer a shape the lane would decline."""
        rec = node.rec
        if type(rec) is tuple:
            # compact host-like: the only decline left is the address
            # canonicality check (TTLs are ints by invariant)
            if rec[0] not in _LANE_HOST_TYPES:
                return None
            packed = BinderServer._zone_packed_addr(rec[1])
            if packed is None:
                return None
            return rec, None, packed, _rec_ttl(rec)
        rt = rec.get("type") if type(rec) is dict else None
        if rt not in _LANE_HOST_TYPES:
            return None
        sub = rec.get(rt)
        if type(sub) is not dict:
            return None
        return BinderServer._zone_a_tail(rec, sub, sub.get("address"))

    @staticmethod
    def _zone_packed_addr(addr):
        """Canonical-dotted-quad check shared by every zone push —
        returns the packed address, or None to decline to Python.  ONE
        copy, so the rule cannot drift between the host, database, and
        service member paths."""
        if type(addr) is not str:
            return None
        try:
            packed = _socket.inet_aton(addr)
        except (OSError, TypeError):
            return None
        if _socket.inet_ntoa(packed) != addr:
            return None
        return packed

    @staticmethod
    def _zone_a_tail(record, sub, addr):
        """Validation tail for the single-A shapes (host-likes,
        database): canonical address + int TTL, or decline.  Returns
        the full (record, sub, packed, ttl) shape so callers are a
        single return."""
        packed = BinderServer._zone_packed_addr(addr)
        if packed is None:
            return None
        ttl = _lane_ttl(record, sub)
        if ttl is None:
            return None
        return record, sub, packed, ttl

    @staticmethod
    def _zone_database_shape(record):
        """The database branch of engine.resolve — one A record whose
        address is the hostname of the ``primary`` URL
        (lib/server.js:295-305) — when it would encode cleanly, else
        None (non-IP hostnames and malformed URLs stay in Python)."""
        sub = record.get("database")
        if type(sub) is not dict:
            return None
        primary = sub.get("primary", "")
        if type(primary) is not str:
            return None                 # urlparse(non-str) raises
        try:
            addr = _urlparse(primary).hostname
        except ValueError:
            return None
        return BinderServer._zone_a_tail(record, sub, addr)

    def _zone_push_a(self, name: str, node) -> None:
        """Precompile the A answer for a host-like or database record
        (the raw lane's A branch plus engine.resolve's database branch,
        done once at mutation time instead of per query)."""
        if not self._zone_suffix_ok(name):
            return
        rec = node.rec
        if type(rec) is dict and rec.get("type") == "database":
            shape = self._zone_database_shape(rec)
        else:
            shape = self._zone_host_shape(node)
        if shape is None:
            return
        _record, _sub, packed, ttl = shape
        qn = self._qname_wire(name)
        if qn is None:
            return
        body = (b"\xc0\x0c\x00\x01\x00\x01"
                + struct.pack(">IH", ttl & 0xFFFFFFFF, 4) + packed)
        frags = None
        if self._log_ring:
            # zone serves replace what Python would resolve fresh —
            # the fragment mirrors the resolve-path log line
            addr = _socket.inet_ntoa(packed)
            frags = [self._log_frag(
                {"query": {"srv": None, "name": name, "type": "A"}},
                Rcode.NOERROR,
                [self._summarize(ARecord(name=name, ttl=ttl,
                                         address=addr))], [])]
            if frags[0] is None:
                return
        try:
            self._zone_put(b"\x00\x01\x00\x01" + qn, 1, [body], qn,
                           0, frags)
        except (TypeError, ValueError, MemoryError) as e:
            self.log.debug("zone A push skipped for %s: %s", name, e)

    def _zone_suffix_ok(self, name: str) -> bool:
        """The raw lane's dnsDomain suffix policy (a doubled suffix is
        REFUSED, never answered) — shared by every forward zone push."""
        dd_suffix = self._lane_suffix
        if dd_suffix is None or not name.endswith(dd_suffix):
            return False
        stripped = name[:-len(dd_suffix)]
        dd = self.resolver.dns_domain
        return not (stripped == dd or stripped.endswith(dd_suffix)
                    or stripped == self._lane_dcsuff
                    or stripped.endswith("." + self._lane_dcsuff))

    @staticmethod
    def _zone_service_ttl(record):
        """``(s, ttl)`` from a service record — the sub-record after the
        nested-historical-format unwrap plus the engine's TTL precedence
        (engine.resolve + _resolve_service head) — or None when the
        shape would not resolve as a service."""
        if not (type(record) is dict
                and type(record.get("service")) is dict):
            return None                 # engine SERVFAILs: decline
        s = record["service"]
        ttl = _engine_record_ttl(record, s)
        if type(s.get("service")) is dict:
            s = s["service"]            # nested historical format
        if s.get("ttl") is not None:
            ttl = s["ttl"]
        if type(ttl) is not int:
            return None
        return s, ttl

    def _zone_service_members(self, node, ttl):
        """Validated member list ``[(knode, ksub, packed_addr, rttl)]``
        for a service node — the one place the member eligibility rules
        live, consumed by both the plain-A and the SRV push so the two
        zone paths cannot drift.  None when the generic path would
        SERVFAIL mid-set or a value would fail to encode (decline to
        Python); addressless or foreign-typed kids are skipped exactly
        like engine._resolve_service does."""
        members = []
        for knode in node.children:
            kr = knode.rec
            if type(kr) is tuple:
                # compact member (store/names.py): address present and
                # TTLs int by invariant; no ports key — the SRV push
                # falls back to the service-level default port
                if kr[0] not in _SERVICE_CHILD_TYPES:
                    continue
                packed = self._zone_packed_addr(kr[1])
                if packed is None:
                    return None         # encode would fail: decline
                parts = _names_rec_parts(kr)
                rttl = parts[3] if parts[3] is not None else (
                    parts[2] if parts[2] is not None else ttl)
                members.append((knode, None, packed, rttl))
                continue
            if not (type(kr) is dict
                    and kr.get("type") in _SERVICE_CHILD_TYPES):
                continue                # engine filters these out too
            ksub = kr.get(kr["type"])
            if type(ksub) is not dict:
                return None             # engine SERVFAILs mid-set
            addr = ksub.get("address")
            if addr is None:
                continue                # engine skips addressless kids
            packed = self._zone_packed_addr(addr)
            if packed is None:
                return None             # encode would fail: decline
            rttl = _engine_record_ttl(kr, ksub, ttl)
            if type(rttl) is not int:
                return None
            members.append((knode, ksub, packed, rttl))
        return members

    def _zone_push_service_a(self, name: str, node) -> None:
        """Precompile the plain-A rotation for a service record
        (engine._resolve_service's A branch, done once at mutation time):
        one variant per cyclic rotation of the member set, so serves
        round-robin like the shuffled generic path.  Declines (leaving
        the Python path authoritative) on anything _resolve_service
        would not answer as a plain multi-A set: invalid child records
        (SERVFAIL), empty member sets (NODATA), non-int TTLs,
        non-canonical addresses."""
        if not self._zone_suffix_ok(name):
            return
        head = self._zone_service_ttl(node.data)
        if head is None:
            return
        _s, ttl = head
        members = self._zone_service_members(node, ttl)
        if not members:
            return                      # NODATA shape: Python answers
        if len(members) > Precompiler.MAX_SET_RECORDS:
            return      # oversize rotation set: lazy (see precompile.py)
        answers = [
            (b"\xc0\x0c\x00\x01\x00\x01"
             + struct.pack(">IH", min(ttl, rttl) & 0xFFFFFFFF, 4)
             + packed)
            for _knode, _ksub, packed, rttl in members]
        qn = self._qname_wire(name)
        if qn is None:
            return
        nv = min(len(answers), _FP_MAX_VARIANTS)
        bodies = [b"".join(answers[i:] + answers[:i]) for i in range(nv)]
        frags = None
        if self._log_ring:
            # per-variant summaries rotate in lockstep with the bodies
            sums = [self._summarize(ARecord(
                        name=name, ttl=min(ttl, rttl),
                        address=_socket.inet_ntoa(packed)))
                    for _knode, _ksub, packed, rttl in members]
            ctx = {"query": {"srv": None, "name": name, "type": "A"}}
            frags = [self._log_frag(ctx, Rcode.NOERROR,
                                    sums[i:] + sums[:i], [])
                     for i in range(nv)]
            if any(f is None for f in frags):
                return
        try:
            self._zone_put(b"\x00\x01\x00\x01" + qn, len(answers),
                           bodies, qn, 0, frags)
        except (TypeError, ValueError, MemoryError) as e:
            self.log.debug("zone service push skipped for %s: %s",
                           name, e)

    def _zone_push_service_srv(self, name: str, node) -> None:
        """Precompile the SRV answer set for a service record under its
        registered ``srvce.proto.name`` qname (engine._resolve_service's
        SRV branch): per member per port an SRV answer at the
        service-level TTL, plus one A additional per member at the
        member TTL, rotating together.  The dependency tag is the
        service NODE name — not the SRV qname — so these entries live in
        the C side's alien table and are invalidated by its bounded
        scan.  Negative SRV shapes (wrong srvce/proto → NXDOMAIN, SRV on
        a non-service → NODATA+SOA, malformed qnames → REFUSED) are
        never pushed and keep resolving through Python."""
        if not self._zone_suffix_ok(name):
            return
        head = self._zone_service_ttl(node.data)
        if head is None:
            return
        s, ttl = head
        srvce, proto = s.get("srvce"), s.get("proto")
        # Only qnames the engine's SRV_RE would parse back to exactly
        # this service can ever match this entry — and only LOWERCASE
        # registrations: decoded query labels arrive lowercased
        # (wire.py:185) and the engine compares them against the stored
        # strings exactly, so an uppercase-registered srvce/proto is
        # unmatchable (NXDOMAIN for every query) and must never be
        # precompiled under its lowercased qname.
        if not (type(srvce) is str and _SRV_LABEL_RE.match(srvce)
                and srvce == srvce.lower()
                and type(proto) is str and _SRV_LABEL_RE.match(proto)
                and proto == proto.lower()):
            return
        default_port = s.get("port")
        raw_members = self._zone_service_members(node, ttl)
        if not raw_members:
            return                      # empty set: NOERROR via Python
        if len(raw_members) > Precompiler.MAX_SET_RECORDS:
            return      # oversize rotation set: lazy (see precompile.py)
        members = []
        for knode, ksub, packed, rttl in raw_members:
            # compact members (ksub None) carry no ports key by
            # invariant: the service-level default port applies
            ports = ksub.get("ports") if type(ksub) is dict else None
            if not ports:
                ports = [default_port]
            if type(ports) is not list:
                return
            target = f"{knode.name}.{name}"
            tw = self._qname_wire(target)
            if tw is None:
                return
            ans = b""
            srv_sums = []
            for p in ports:
                if type(p) is not int or not 0 <= p <= 0xFFFF:
                    return              # encode would fail: decline
                # SRV rdata: priority 0, weight 10 (engine constants),
                # port, uncompressed target (RFC 2782 forbids pointers
                # in SRV rdata)
                ans += (b"\xc0\x0c\x00\x21\x00\x01"
                        + struct.pack(">IH", ttl & 0xFFFFFFFF,
                                      6 + len(tw))
                        + struct.pack(">HHH", 0, 10, p) + tw)
                if self._log_ring:
                    srv_sums.append(self._summarize(SRVRecord(
                        name=name, ttl=ttl, priority=0, weight=10,
                        port=p, target=target)))
            # summaries rendered only in the logged posture — churn-path
            # zone refreshes in the log-off posture must not pay for them
            add_sum = (self._summarize(ARecord(
                name=target, ttl=rttl,
                address=_socket.inet_ntoa(packed)))
                if self._log_ring else None)
            add = (tw + b"\x00\x01\x00\x01"
                   + struct.pack(">IH", rttl & 0xFFFFFFFF, 4) + packed)
            members.append((ans, add, len(ports), srv_sums, add_sum))
        qn = self._qname_wire(f"{srvce}.{proto}.{name}")
        tag = self._qname_wire(name)
        if qn is None or tag is None:
            return
        ancount = sum(m[2] for m in members)
        arcount = len(members)
        if ancount > 0xFFFF:
            return
        nv = min(len(members), _FP_MAX_VARIANTS)
        bodies = []
        for i in range(nv):
            rot = members[i:] + members[:i]
            bodies.append(b"".join(m[0] for m in rot)
                          + b"".join(m[1] for m in rot))
        frags = None
        if self._log_ring:
            ctx = {"query": {"srv": f"{srvce}.{proto}", "name": name,
                             "type": "SRV"}}
            frags = []
            for i in range(nv):
                rot = members[i:] + members[:i]
                frags.append(self._log_frag(
                    ctx, Rcode.NOERROR,
                    [s for m in rot for s in m[3]],
                    [m[4] for m in rot]))
            if any(f is None for f in frags):
                return
        try:
            self._zone_put(b"\x00\x21\x00\x01" + qn, ancount, bodies,
                           tag, arcount, frags)
        except (TypeError, ValueError, MemoryError) as e:
            self.log.debug("zone SRV push skipped for %s: %s", name, e)

    def _zone_push_ptr(self, rev_name: str, owner) -> None:
        """Precompile the PTR answer for a reverse name (the raw lane's
        PTR branch; NO dnsDomain suffix policy on the reverse tree,
        lib/server.js:67-134)."""
        shape = self._zone_host_shape(owner)
        if shape is None:
            return
        _record, _sub, _packed, ttl = shape
        target = owner.domain
        if target.endswith(".arpa"):
            return                      # parity with the lane's decline
        tw = self._qname_wire(target)
        if tw is None:
            return
        qn = self._qname_wire(rev_name)
        if qn is None:
            return
        body = (b"\xc0\x0c\x00\x0c\x00\x01"
                + struct.pack(">IH", ttl & 0xFFFFFFFF, len(tw)) + tw)
        frags = None
        if self._log_ring:
            ip = ".".join(reversed(rev_name.split(".")[:-2]))
            frags = [self._log_frag(
                {"query": {"ip": ip, "type": "PTR"}}, Rcode.NOERROR,
                [self._summarize(PTRRecord(name=rev_name, ttl=ttl,
                                           target=target))], [])]
            if frags[0] is None:
                return
        try:
            self._zone_put(b"\x00\x0c\x00\x01" + qn, 1, [body], qn,
                           0, frags)
        except (TypeError, ValueError, MemoryError) as e:
            self.log.debug("zone PTR push skipped for %s: %s", rev_name, e)

    def _zone_put(self, zkey: bytes, ancount: int, bodies, tag: bytes,
                  arcount: int, frags) -> None:
        """The one zone_put call site: appends the per-variant log
        fragments only when present, so an older compiled extension
        (pre-log-ring arity) keeps accepting log-off pushes.

        Declines while the degradation policy is not fresh: a zone body
        carries the record's own TTL, and pushed under the current epoch
        the C drain would serve it unclamped while stale-serving and as
        data past the cap.  The chunked fill of a large zone (at start,
        or in a respawned or rolled worker) is still running when a
        session loss lands; degraded answers are the generic path's."""
        if self._policy is not None and self._policy.mode() != "fresh":
            return
        if frags is not None:
            _fastio.fastpath_zone_put(self._fastpath, zkey,
                                      self.zk_cache.epoch, ancount,
                                      bodies, tag, arcount, frags)
        else:
            _fastio.fastpath_zone_put(self._fastpath, zkey,
                                      self.zk_cache.epoch, ancount,
                                      bodies, tag, arcount)

    #: per-pass wall budget for the chunked zone fill / seed walks
    _FILL_BUDGET_S = 0.002

    def _zone_fill(self) -> None:
        """Walk the mirror and push every eligible precompiled answer —
        run at server start for mirrors built before this server
        subscribed to invalidation events (later arrivals ride
        _on_store_invalidate).  Small zones fill inline (the historical
        semantics); at zone scale the walk moves to a time-budgeted
        background task so serving starts immediately and the fill
        streams in behind it (un-filled names resolve through the
        raw lane / generic path — slower, never wrong)."""
        if not self._zone_enabled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        nodes = self.zk_cache.nodes
        reserve = getattr(_fastio, "fastpath_zone_reserve", None)
        if reserve is not None and len(nodes) > 1024:
            # presize the native zone table for the fill (one A + one
            # PTR entry per host): growth rehashes are O(table) and the
            # largest one at zone scale measured ~370 ms — an
            # event-loop stall mid-serving, not a hiccup
            try:
                reserve(self._fastpath, 2 * len(nodes))
            except (TypeError, ValueError, MemoryError) as e:
                self.log.debug("zone-table reserve skipped: %s", e)
        if loop is not None and len(nodes) > Precompiler.SEED_INLINE_MAX:
            self._zone_fill_task = loop.create_task(
                self._zone_fill_chunked())
            return
        started = ACCOUNT.phase_start()
        for domain in list(nodes):
            self._zone_fill_one(domain)
        ACCOUNT.phase_end("zone-fill", started)

    def _zone_fill_one(self, domain: str) -> None:
        node = self.zk_cache.nodes.get(domain)
        if node is None:
            return                      # left the mirror mid-walk
        self._zone_refresh(domain)
        ip = node.ip
        if ip and type(ip) is str:
            if ":" in ip:
                # v6 (already canonical via TreeNode.ip): precompile
                # the ip6.arpa PTR alongside the forward name
                try:
                    rev = reverse_name_for_ip(ip)
                except ValueError:
                    return
                self._zone_refresh(rev)
                return
            parts = ip.split(".")
            if len(parts) == 4 and all(p.isdigit() for p in parts):
                self._zone_refresh(
                    ".".join(reversed(parts)) + ".in-addr.arpa")

    async def _zone_fill_chunked(self) -> None:
        domains = list(self.zk_cache.nodes)
        self.log.info("zone fill: %d names, chunked", len(domains))
        started = time.perf_counter()
        phase = ACCOUNT.phase_start()
        cpu_ns = 0
        i = 0
        while i < len(domains):
            t0 = time.perf_counter()
            ACCOUNT.begin(_ACT_ZONE_FILL)
            try:
                while i < len(domains) \
                        and time.perf_counter() - t0 < self._FILL_BUDGET_S:
                    self._zone_fill_one(domains[i])
                    i += 1
            finally:
                cpu_ns += ACCOUNT.end()
            await asyncio.sleep(0)
        self.log.info("zone fill done: %d names in %.1fs", len(domains),
                      time.perf_counter() - started)
        # the fill shares the loop with serving: its CPU is its chunks'
        ACCOUNT.phase_end("zone-fill", phase, cpu_s=cpu_ns / 1e9)

    def _fastpath_push(self, key, epoch: int, query: QueryCtx) -> None:
        """Promote an answer-cache entry to the native fast path (on
        its first hit — see _on_query).  The C key is built from the
        request's raw qname bytes so both key builders see identical
        input; names outside the hostname charset (which Python decodes
        with replacement) are skipped — they keep being served by the
        Python path."""
        claimed = self.answer_cache.take_push(key, epoch)
        if claimed is None:
            return
        variants, tag = claimed
        ckey = self._fastpath_key(query)
        if ckey is None:
            return
        tag_wire = self._qname_wire(tag)
        if tag_wire is None:
            return                      # not invalidatable: keep in Python
        wires = [v[0] for v in variants]
        frags = None
        if self._log_ring:
            # native serves of this entry are cache hits; the Python
            # hit path logs exactly {cached: true} + rcode + summaries
            # (_on_query cache-hit branch + _on_after), so the fragment
            # mirrors that shape per variant
            frags = [self._log_frag({"cached": True}, w[3] & 0x0F, a, d)
                     for (w, a, d) in variants]
            if any(f is None for f in frags):
                return                  # unloggable: stays in Python
        ttl_ms = self.answer_cache.remaining_ttl_ms(key, epoch)
        ttl_arg = -1 if ttl_ms is None else int(ttl_ms)
        try:
            # frags appended only when present so an older compiled
            # extension keeps accepting log-off pushes
            if frags is not None:
                _fastio.fastpath_put(self._fastpath, ckey, query.qtype(),
                                     epoch, wires, ttl_arg, tag_wire,
                                     frags)
            else:
                _fastio.fastpath_put(self._fastpath, ckey, query.qtype(),
                                     epoch, wires, ttl_arg, tag_wire)
        except (TypeError, ValueError, MemoryError) as e:
            self.log.debug("fastpath push skipped: %s", e)

    @staticmethod
    def _fastpath_key(query: QueryCtx) -> Optional[bytes]:
        # layout must match fp_build_key in native/fastio/fastpath.c:
        # [flags rd|edns<<1][payload BE16][qtype BE16][qclass BE16][qname]
        raw = query.raw
        req = query.request
        if raw is None or len(raw) < 17:
            return None
        off = 12
        try:
            while True:
                label_len = raw[off]
                if label_len == 0:
                    off += 1
                    break
                if label_len & 0xC0:
                    return None   # compressed question name: C punts too
                label = raw[off + 1:off + 1 + label_len]
                if (len(label) != label_len
                        or not _FP_NAME_OK.issuperset(label)):
                    return None
                off += 1 + label_len
                if off - 12 > 255:
                    return None
        except IndexError:
            return None
        q0 = req.questions[0]
        return _fastpath_key_parts(req.rd, req.edns is not None,
                                   req.max_udp_payload(), q0.qtype,
                                   q0.qclass, raw[12:off].lower())

    def _raw_lane(self, data: bytes, src, protocol: str, send,
                  client_transport: Optional[str] = None) -> bool:
        """Direct-assembly resolve for the dominant query shapes: one
        A/IN or PTR/IN question, optionally with a bare EDNS OPT.

        The generic path costs ~60µs per cold name (Message decode,
        QueryCtx, resolver, Message encode); this lane answers the same
        shapes in a few µs by patching the request wire: header rewrite,
        verbatim question echo, one compression-pointer A or PTR record.
        It mirrors ``Resolver.resolve`` / ``Resolver.resolve_ptr``
        policy exactly for the shapes it accepts — suffix /
        doubled-suffix REFUSED (forward only; the reverse tree has no
        suffix policy), store-down SERVFAIL, TTL precedence,
        REFUSED-not-NXDOMAIN on misses (lib/server.js:227-241) — and is
        differential-tested against the generic path
        (tests/test_raw_lane.py).  Everything else — other qtypes, EDNS
        options, service/database records, the recursion handoff,
        invalid records, responses that would need UDP truncation,
        query-log/probes active — returns False and takes the generic
        path, so divergence is impossible for declined shapes.

        The question section is echoed with the requester's original
        case (dns0x20), matching the generic path's echo in
        QueryCtx._echo_question_case.
        """
        if (self.query_log or self.p_req_start.enabled
                or self.p_req_done.enabled):
            return False
        if self._policy is not None and self._policy.mode() != "fresh":
            # degraded serving (TTL clamp, withhold-past-cap) is the
            # generic path's job; the lane declines rather than
            # duplicating the policy matrix (docs/degradation.md)
            return False
        dd_suffix = self._lane_suffix
        if dd_suffix is None:
            return False
        n = len(data)
        if n < 17:
            return False
        # header: QR / opcode / TC must be clear; QD=1; AN=NS=0; AR<=1
        if data[2] & 0xFA:
            return False
        if (data[4] or data[5] != 1 or data[6] or data[7] or data[8]
                or data[9] or data[10] or data[11] > 1):
            return False
        start = time.monotonic()
        # question name: case-preserving walk, charset-validated (the
        # charset equals the resolver's NAME_RE alphabet, so names the
        # lane declines here are exactly the generic path's
        # invalid-name REFUSED shapes plus non-ASCII oddities)
        labels = []
        off = 12
        ok = _FP_NAME_OK.issuperset
        while True:
            ll = data[off]
            if ll == 0:
                off += 1
                break
            if ll & 0xC0:
                return False           # compressed qname
            end = off + 1 + ll
            if end + 1 > n:
                return False
            if not ok(data[off + 1:end]):
                return False
            labels.append(data[off + 1:end])
            off = end
            if off - 12 > 255:
                return False
        if off + 4 > n:
            return False
        qtype_b = data[off:off + 4]
        if qtype_b == b"\x00\x01\x00\x01":       # A / IN
            qtype_val = 1
        elif qtype_b == b"\x00\x0c\x00\x01":     # PTR / IN
            qtype_val = 12
        else:
            return False
        q_end = off + 4
        edns = False
        payload = MAX_UDP_PAYLOAD
        if data[11]:
            # exactly one bare OPT: root name, TYPE 41, version 0, no
            # RDATA (EDNS options vary per packet and take the generic
            # path; so do nonzero versions)
            if q_end + 11 != n or data[q_end] != 0:
                return False
            otype, ocls = struct.unpack_from(">HH", data, q_end + 1)
            if otype != 41 or data[q_end + 6] != 0:
                return False
            if data[q_end + 9] or data[q_end + 10]:
                return False
            # same floor/clamp as Message.max_udp_payload — shared
            # constants so the copies cannot drift
            if ocls >= MAX_UDP_PAYLOAD:
                payload = min(ocls, MAX_EDNS_PAYLOAD)
            edns = True
        elif q_end != n:
            return False               # trailing bytes
        try:
            name = b".".join(labels).lower().decode("ascii")
        except UnicodeDecodeError:
            return False

        rd_flag = data[2] & 0x01
        udp_sem = (protocol == "udp"
                   or (protocol == "balancer" and client_transport != "tcp"))
        # the key layout must stay byte-for-byte with _on_query's
        key = (udp_sem, bool(rd_flag), qtype_val, 1, name, edns, payload)
        cache = self.zk_cache
        epoch = cache.epoch
        hit = self.answer_cache.get(key, epoch)
        if hit is not None:
            cached = hit[0]
            # patch in this requester's id AND question bytes: cached
            # wires store the question lowercased (see the put below), so
            # echoing the requester's own bytes keeps dns0x20 validators
            # happy; same name/qtype keyed -> identical section length
            wire = (data[:2] + cached[2:12] + data[12:q_end]
                    + cached[q_end:])
            send(wire)
            try:
                self._cache_hit_child.inc()
                self._lane_finish(data, src, protocol, start, wire,
                                  wire[3] & 0x0F, edns, hit[1], hit[2],
                                  qtype=qtype_val, cached=True)
                # promote-on-first-hit: the repeat proves the name hot;
                # hand it to the C fast path so the next repeat never
                # surfaces to Python
                if (udp_sem and self._fastpath is not None
                        and self._fastpath_active()):
                    claimed = self.answer_cache.take_push(key, epoch)
                    if claimed is not None:
                        qname_low = data[12:q_end - 4].lower()
                        ckey = _fastpath_key_parts(
                            bool(rd_flag), edns, payload, qtype_val, 1,
                            qname_low)
                        try:
                            _fastio.fastpath_put(
                                self._fastpath, ckey, qtype_val, epoch,
                                [v[0] for v in claimed[0]],
                                int(self.answer_cache.expiry_s * 1000),
                                qname_low)
                        except (TypeError, ValueError, MemoryError) as e:
                            self.log.debug("fastpath push skipped: %s",
                                           e)
            except Exception:
                # response already sent: never fall through to the
                # generic path (it would answer a second time)
                self.log.exception("raw lane post-send bookkeeping failed")
            return True

        # Mutation-time precompiled probe (the lane edition of
        # _serve_compiled): a dict probe + RD patch + the same id/case
        # splice as the hit path above, instead of the inline resolve
        # below.  Declines to the resolve on truncation overflow.
        comp = self.answer_cache.get_compiled(qtype_val, name, epoch)
        if comp is not None:
            (w0, w1, ans, add), rotatable, tag, negative = comp
            cw = w1 if edns else w0
            if not (udp_sem and len(cw) > payload):
                if rd_flag:
                    cw = patch_answer_wire(cw, rd=True)
                wire = (data[:2] + cw[2:12] + data[12:q_end]
                        + cw[q_end:])
                send(wire)
                try:
                    self._precompile_serve_child.inc()
                    self._lane_finish(data, src, protocol, start, wire,
                                      wire[3] & 0x0F, edns, ans, add,
                                      qtype=qtype_val, cached=True)
                    self.answer_cache.put(
                        key, epoch, (cw, ans, add), rotatable=rotatable,
                        tag=tag, negative=negative,
                        qkey=(qtype_val, name))
                except Exception:
                    # response already sent: never fall through to the
                    # generic path (it would answer a second time)
                    self.log.exception(
                        "raw lane post-send bookkeeping failed")
                return True

        # -- resolution --
        body = b""
        ancount = 0
        ans = []
        if qtype_val == 1:
            # mirrors Resolver.resolve ordering exactly
            rcode = 0
            node = None
            if not name.endswith(dd_suffix):
                rcode = Rcode.REFUSED  # not within dns domain suffix
            else:
                stripped = name[:-len(dd_suffix)]
                dd = self.resolver.dns_domain
                if (stripped == dd or stripped.endswith(dd_suffix)
                        or stripped == self._lane_dcsuff
                        or stripped.endswith("." + self._lane_dcsuff)):
                    rcode = Rcode.REFUSED  # doubled-up dns domain suffix
                elif not cache.is_ready():
                    self.log.error("no coordination-store session")
                    rcode = Rcode.SERVFAIL
                else:
                    node = cache.lookup(name)
                    if node is None:
                        if (self.resolver.recursion is not None
                                and rd_flag):
                            return False  # recursion handoff: generic
                        rcode = Rcode.REFUSED

            if rcode == 0 and node is not None:
                rec = node.rec
                if type(rec) is tuple:
                    # compact host-like (store/names.py): address and
                    # int TTLs by invariant, canonicality still checked
                    if rec[0] not in _LANE_HOST_TYPES:
                        return False
                    addr = rec[1]
                    ttl = _rec_ttl(rec)
                else:
                    rt = rec.get("type") if type(rec) is dict else None
                    if rt not in _LANE_HOST_TYPES:
                        return False   # service/database/invalid record
                    sub = rec.get(rt)
                    if type(sub) is not dict:
                        return False
                    addr = sub.get("address")
                    if type(addr) is not str:
                        return False
                    ttl = _lane_ttl(rec, sub)
                    if ttl is None:
                        return False   # store garbage: generic path
                try:
                    packed = _socket.inet_aton(addr)
                except (OSError, TypeError):
                    return False       # generic path SERVFAILs
                if _socket.inet_ntoa(packed) != addr:
                    return False       # non-canonical dotted quad
                body = (b"\xc0\x0c\x00\x01\x00\x01"
                        + struct.pack(">IH", ttl & 0xFFFFFFFF, 4)
                        + packed)
                ancount = 1
                # same string _summarize(ARecord) renders, through the
                # one redaction helper, without the record-object round
                # trip
                ans = [f"{strip_suffix(dd_suffix, name)} A {addr}"]
        else:
            # PTR: mirrors Resolver.resolve_ptr exactly — note there is
            # NO dnsDomain suffix policy on the reverse tree
            # (lib/server.js:67-134)
            rcode = 0
            ip = None
            parts = name.split(".")
            if len(parts) >= 2 and parts[-1] == "arpa" \
                    and parts[-2] == "ip6":
                # IPv6 reverse: strict canonical nibble parse (the
                # reverse map is keyed by canonical address strings);
                # malformed ip6.arpa names miss below
                ip = ip_from_reverse_name(name)
                if ip is None:
                    rcode = Rcode.REFUSED
            elif len(parts) < 2 or parts[-1] != "arpa" \
                    or parts[-2] != "in-addr":
                rcode = Rcode.REFUSED  # not an ip reverse name
            if rcode == 0 and not cache.is_ready():
                self.log.error("no coordination-store session")
                rcode = Rcode.SERVFAIL
            elif rcode == 0:
                if ip is None:
                    # no octet validation: an invalid address simply
                    # misses (comment at lib/server.js:79-83)
                    ip = ".".join(reversed(parts[:-2]))
                node = cache.reverse_lookup(ip)
                if node is None:
                    if self.resolver.recursion is not None and rd_flag:
                        return False   # recursion handoff: generic path
                    rcode = Rcode.REFUSED
                else:
                    rec = node.rec
                    if type(rec) is tuple:
                        ttl = _rec_ttl(rec)
                    else:
                        record = rec if type(rec) is dict else {}
                        rt = record.get("type")
                        sub = record.get(rt) if type(rt) is str else None
                        ttl = _lane_ttl(record, sub)
                        if ttl is None:
                            return False   # store garbage: generic path
                    target = node.domain
                    if target.endswith(".arpa"):
                        # the generic encoder could compress the target
                        # against the reverse qname; keep parity by
                        # declining the (absurd) overlap case
                        return False
                    # the one real name encoder enforces the label and
                    # 255-byte total bounds the generic path would
                    # SERVFAIL on; unencodable targets decline
                    tw = self._qname_wire(target)
                    if tw is None:
                        return False
                    body = (b"\xc0\x0c\x00\x0c\x00\x01"
                            + struct.pack(">IH", ttl & 0xFFFFFFFF,
                                          len(tw)) + tw)
                    ancount = 1
                    # the dict _summarize renders for PTR records,
                    # without the record-object round trip
                    ans = [{"type": "PTR", "name": name, "ttl": ttl,
                            "target": target}]

        flags_out = 0x8400 | (0x0100 if rd_flag else 0) | rcode
        wire = (data[:2]
                + struct.pack(">HHHHH", flags_out, 1, ancount, 0,
                              1 if edns else 0)
                + data[12:q_end] + body
                + (_OPT_ECHO_WIRE if edns else b""))
        if udp_sem and len(wire) > payload:
            # a long reverse qname + long target can exceed the UDP
            # ceiling; the generic path owns truncation semantics
            return False
        send(wire)
        try:
            self._lane_finish(data, src, protocol, start, wire, rcode,
                              edns, ans, [], qtype=qtype_val)
            if rcode != Rcode.SERVFAIL:
                # cache entries carry a lowercased question so hits can
                # splice in each requester's own case (generic hits do
                # the same via QueryCtx._echo_question_case).  The
                # native push happens at the entry's first hit above
                # (promote-on-first-hit), never on this cold path.
                q_sec = data[12:q_end]
                q_low = q_sec.lower()
                cache_wire = (wire if q_sec == q_low
                              else wire[:12] + q_low + wire[q_end:])
                # lane answers (hit, miss-REFUSED, suffix-REFUSED) all
                # depend on exactly this name; the qname doubles as the
                # dependency tag.  qkey carries the question identity as
                # re-render evidence — without it, churn on a name served
                # only by this lane would never reach the precompiler
                # (or the propagation tracer's render/install stages)
                self.answer_cache.put(
                    key, epoch, (cache_wire, ans, []), rotatable=False,
                    tag=name, qkey=(qtype_val, name))
        except Exception:
            # response already sent: never fall through to the generic
            # path (it would answer a second time)
            self.log.exception("raw lane post-send bookkeeping failed")
        return True

    def _lane_finish(self, data, src, protocol: str, start: float,
                     wire: bytes, rcode: int, edns: bool, ans, add,
                     qtype: int = 1, cached: bool = False) -> None:
        """Metrics + the slow-query warn for a lane-handled query
        (the lane equivalent of _on_after with queryLog off)."""
        lat_s = time.monotonic() - start
        ch = self._children_for(qtype)
        ch[0].inc()
        ch[1].observe(lat_s)
        ch[2].observe(len(wire))
        lat_ms = lat_s * 1000.0
        if lat_ms > SLOW_QUERY_MS:
            if self.recorder is not None:
                self.recorder.record(
                    "slow-query", trace=None, name="(raw-lane)",
                    qtype=Type.name(qtype), rcode=Rcode.name(rcode),
                    latency_ms=round(lat_ms, 3), stages={})
            log_event(self.log, logging.WARNING, "DNS query",
                      req_id=(data[0] << 8) | data[1], client=src[0],
                      port=f"{src[1]}/{protocol}", edns=edns,
                      cached=cached, rcode=Rcode.name(rcode),
                      answers=ans, additional=add, latency=lat_ms,
                      timers={})

    def _fold_engine_counters(self) -> None:
        # scrapes run on ThreadingHTTPServer threads: fold under the
        # shared lock or two concurrent scrapes double-count the delta
        with self._fp_fold_lock:
            delta = self.engine.tcp_cap_refusals - self._cap_folded
            if delta > 0:
                self._cap_refusal_child.inc(delta)
                self._cap_folded += delta
            snap = self.engine.tcp_stats.snapshot()
            folded = self._tcp_stats_folded
            for field, child in self._tcp_stat_children.items():
                d = snap[field] - folded.get(field, 0)
                if d > 0:
                    child.inc(d)
                    folded[field] = snap[field]
            if self._rrl is not None:
                rfolded = self._rrl_folded
                for field, child in self._rrl_children.items():
                    val = getattr(self._rrl, field)
                    d = val - rfolded.get(field, 0)
                    if d > 0:
                        child.inc(d)
                        rfolded[field] = val

    def _fold_fastpath_metrics(self) -> None:
        """Fold the C fast path's monotonic counters into the Prometheus
        collectors (registered as a pre-scrape hook).  Deltas are taken
        against the last fold under a lock — concurrent scrapes must not
        double-count."""
        with self._fp_fold_lock:
            # Snapshot inside the lock: with it outside, two concurrent
            # scrapes could fold in order new-then-old, regressing the
            # delta baseline and double-counting on the next fold.
            stats = _fastio.fastpath_stats(self._fastpath)
            self._fp_last_stats = stats   # shared with residency gauges
            last = self._fp_folded
            hits_delta = stats["hits"] - last.get("hits", 0)
            if hits_delta > 0:
                self._cache_hit_child.inc(hits_delta)
            last["hits"] = stats["hits"]
            zone_delta = stats.get("zone_hits", 0) - last.get("zone_hits", 0)
            if zone_delta > 0:
                self._zone_serve_child.inc(zone_delta)
            last["zone_hits"] = stats.get("zone_hits", 0)
            self._fp_inval_total = stats.get("invalidations", 0)
            for qtype, s in stats["per_qtype"].items():
                children = self._children_for(qtype)
                prev = last.get(qtype)
                count_delta = s["count"] - (prev["count"] if prev else 0)
                if count_delta > 0:
                    children[0].inc(count_delta)
                    children[1].merge(
                        [c - (prev["lat_cells"][i] if prev else 0)
                         for i, c in enumerate(s["lat_cells"])],
                        s["lat_sum"] - (prev["lat_sum"] if prev else 0.0))
                    children[2].merge(
                        [c - (prev["size_cells"][i] if prev else 0)
                         for i, c in enumerate(s["size_cells"])],
                        s["size_sum"] - (prev["size_sum"] if prev else 0.0))
                last[qtype] = s

    def _children_for(self, qtype: int):
        """Pre-resolved (counter, latency, size) metric handles for a
        qtype — label-sort once, not per query; shared by the after-hook
        and the fast-path fold."""
        children = self._metric_children.get(qtype)
        if children is None:
            # 0xFFFF is the C stats catch-all past its per-qtype slots
            labels = {"type": "other" if qtype == 0xFFFF
                      else Type.name(qtype)}
            children = (self.request_counter.labelled(labels),
                        self.latency_histogram.labelled(labels),
                        self.size_histogram.labelled(labels))
            self._metric_children[qtype] = children
        return children

    def _fastpath_active(self) -> bool:
        """The C path bypasses Python entirely, so it must stand down
        whenever every query has to surface: a probe consumer attached,
        per-query logging on WITHOUT the native log ring (with the
        ring armed, the C path produces the log lines itself), or
        response rate limiting actively shedding a flood (the limiter
        judges per-prefix in Python; serving cache hits in C would
        answer the flood before RRL could see it)."""
        return (not self.p_req_start.enabled
                and not self.p_req_done.enabled
                and (not self.query_log or self._log_ring)
                and (self._rrl is None or not self._rrl.hot()))

    # -- native query-log ring plumbing --

    def _find_json_handlers(self) -> list:
        """StreamHandlers with a JsonFormatter reachable from this
        server's logger (walking propagation like logging does) — the
        sinks the ring's pre-formatted lines are written to."""
        handlers = []
        lg: Optional[logging.Logger] = self.log
        while lg is not None:
            for h in lg.handlers:
                if (isinstance(h, logging.StreamHandler)
                        and isinstance(h.formatter, JsonFormatter)
                        and h.level <= logging.INFO):
                    handlers.append(h)
            if not lg.propagate:
                break
            lg = lg.parent
        return handlers

    def _native_log_prefix(self) -> bytes:
        """Constant head of every native log line, up to and including
        ``"time": "`` — rendered once from the logger's identity, so
        ring lines carry the same envelope as JsonFormatter's."""
        fmt = self._log_json_handlers[0].formatter
        head = {"name": fmt.name, "hostname": fmt.hostname,
                "pid": _os.getpid(), "level": 30,
                "component": self.log.name, "msg": "DNS query"}
        return (_json.dumps(head)[:-1] + ', "time": "').encode()

    @staticmethod
    def _log_frag(ctx: dict, rcode: int, ans, add) -> Optional[bytes]:
        """Pre-rendered middle of a log line (the answer-dependent
        fields) for one entry variant; None when it cannot be rendered
        or would exceed the native bound (the entry then declines to
        Python under logging, which is always correct)."""
        d = dict(ctx)
        d["rcode"] = Rcode.name(rcode)
        d["answers"] = ans
        d["additional"] = add
        try:
            frag = _json.dumps(d, default=str)[1:-1].encode()
        except (TypeError, ValueError):
            return None
        return frag if 0 < len(frag) <= 4096 else None

    @ACCOUNT.spans("udp.querylog")
    def _drain_native_log(self) -> None:
        """Write the ring's accumulated complete lines to the JSON log
        stream(s).  Called from the UDP drain loop (amortized over each
        batch) and from a periodic flusher covering the TCP/balancer
        lanes and idle tails."""
        try:
            block = _fastio.fastpath_log_drain(self._fastpath)
        except (TypeError, ValueError):
            return
        if not block:
            return
        text = None
        for h in self._log_json_handlers:
            try:
                h.acquire()
                try:
                    buf = getattr(h.stream, "buffer", None)
                    # bytes straight through ONLY when the text layer
                    # would have produced the same bytes: UTF-8-family
                    # encoding and no newline translation — otherwise
                    # ring lines and formatter lines would mix
                    # encodings/line-endings in one file
                    enc = (getattr(h.stream, "encoding", "") or "") \
                        .lower().replace("-", "")
                    nl = getattr(h.stream, "newlines", None)
                    if (buf is not None
                            and enc in ("utf8", "ascii", "usascii")
                            and nl in (None, "\n")):
                        # (flush the text layer first so lines the
                        # Python formatter wrote stay ordered)
                        h.stream.flush()
                        buf.write(block)
                        buf.flush()
                    else:
                        if text is None:
                            text = block.decode("utf-8", "replace")
                        h.stream.write(text)
                        h.flush()
                finally:
                    h.release()
            except Exception:
                pass   # a dead log sink must never take down serving

    async def _log_flush_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(0.1)
                self._drain_native_log()
        except asyncio.CancelledError:
            self._drain_native_log()
            raise

    # -- after hook: metrics + query log (lib/server.js:509-591) --

    def _on_after(self, query: QueryCtx) -> None:
        query.stamp("log-after")
        lat_ms = query.latency_ms()
        if self.p_req_done.enabled:
            self.p_req_done.fire(lambda: {
                "trace": query.trace_id,
                "id": query.request.id, "name": query.name(),
                "type": query.qtype_name(),
                "rcode": Rcode.name(query.rcode()),
                "latency_ms": round(lat_ms, 3), "bytes": query.bytes_sent,
                "stages": {k: round(v, 3)
                           for k, v in query.times.items()},
            })
        level = logging.WARNING if lat_ms > SLOW_QUERY_MS else logging.INFO
        if lat_ms > SLOW_QUERY_MS and self.recorder is not None:
            self.recorder.record(
                "slow-query", trace=query.trace_id, name=query.name(),
                qtype=query.qtype_name(), rcode=Rcode.name(query.rcode()),
                latency_ms=round(lat_ms, 3),
                stages={k: round(v, 3) for k, v in query.times.items()})

        children = self._children_for(query.qtype())
        children[0].inc()
        children[1].observe(lat_ms / 1000.0)
        children[2].observe(query.bytes_sent)
        for stage, ms in query.times.items():
            child = self._stage_children.get(stage)
            if child is None:
                child = self._stage_children[stage] = \
                    self.stage_histogram.labelled({"stage": stage})
            child.observe(ms / 1000.0)

        if not self.query_log and lat_ms <= SLOW_QUERY_MS:
            return
        if query.cached_summary is not None:
            ans, add = query.cached_summary
        else:
            ans = [self._summarize(r) for r in query.response.answers]
            add = [self._summarize(r) for r in query.response.additionals
                   if not isinstance(r, OPTRecord)]
        log_event(
            self.log, level, "DNS query",
            # request envelope built here, not per-query in _on_query:
            # most queries never log (queryLog off / fast), so the dict
            # work happens only on the slow/logged path
            trace=query.trace_id,
            req_id=query.request.id,
            client=query.src[0],
            port=f"{query.src[1]}/{query.protocol}",
            edns=query.request.edns is not None,
            **query.log_ctx,
            rcode=Rcode.name(query.rcode()),
            answers=ans,
            additional=add,
            latency=lat_ms,
            timers=query.times,
        )

    def _summarize(self, rec) -> object:
        if isinstance(rec, SRVRecord):
            return (f"SRV {strip_suffix('.' + self.dns_domain, rec.target)}"
                    f":{rec.port}")
        if isinstance(rec, ARecord):
            return (f"{strip_suffix('.' + self.dns_domain, rec.name)} "
                    f"A {rec.address}")
        d = {"type": Type.name(rec.rtype), "name": rec.name, "ttl": rec.ttl}
        if hasattr(rec, "target"):
            d["target"] = rec.target
        return d

    # -- lifecycle (lib/server.js:609-657) --

    #: ephemeral pair-bind redraws before giving up; each failure means
    #: the kernel-chosen UDP port was taken on TCP, so consecutive
    #: failures are near-independent draws from the ephemeral range
    _PAIR_BIND_ATTEMPTS = 16

    async def start(self) -> None:
        if self._precompiler is not None:
            # compile the already-mirrored names (mirrors built before
            # this server subscribed to invalidation events); mutation
            # events keep the table fresh from here on
            self._precompiler.seed_mirror()
        self._zone_fill()
        if self.balancer_socket:
            # join the balancer only with the whole zone mirrored: a
            # server restarted under it inherits its predecessor's
            # clients at once, and would answer them REFUSED or
            # SERVFAIL for every name its walk has not reached yet
            await self.engine.listen_balancer(
                self.balancer_socket, ready=self.zk_cache.synced)
        # UDP and TCP must share one port number (the reference serves
        # both on the same port, lib/server.js:643-653).  With port=0
        # the kernel picks the UDP port and any unrelated socket may
        # already hold that number on TCP — so the pair bind is a retry
        # loop: release the UDP draw and redraw instead of failing
        # (the observed CI flake: EADDRINUSE on the UDP-chosen port).
        for attempt in range(self._PAIR_BIND_ATTEMPTS):
            # announce only once the PAIR is secured: launchers watch
            # the "service started" lines for the port, and a line
            # printed for a draw that is then released and redrawn
            # advertises a dead port (observed as a CI dnsblast
            # connection-refused failure)
            try:
                udp_port = await self.engine.listen_udp(
                    self.host, self.port, announce=False,
                    reuse_port=self.reuse_port)
            except OSError:
                # a UDP bind failure (fixed port taken) must release
                # the balancer listener opened above, like the TCP path
                await self.engine.close()
                raise
            try:
                self.tcp_port = await self.engine.listen_tcp(
                    self.host, self.port if self.port else udp_port,
                    announce=False, reuse_port=self.reuse_port)
            except OSError as e:
                # the failed draw must be released even when re-raising:
                # callers treat start() as atomic and won't stop() a
                # server that never started
                self.engine.close_udp_listener(udp_port)
                # errno is None when asyncio aggregates several bind
                # failures (multi-address hosts) into one OSError — a
                # colliding draw must redraw in that shape too
                if (self.port == 0
                        and e.errno in (_errno.EADDRINUSE, None)
                        and attempt < self._PAIR_BIND_ATTEMPTS - 1):
                    continue
                # failed for good: release the balancer listener opened
                # above so the raise leaves no socket behind
                await self.engine.close()
                raise
            self.udp_port = udp_port
            if self.announce:
                self.engine.announce_udp(self.host, udp_port)
                self.engine.announce_tcp(self.host, self.tcp_port)
            break
        if self._log_ring and self._log_flush_task is None:
            # periodic drain for the lanes without a C drain loop of
            # their own (TCP/balancer serves) and for idle tails
            self._log_flush_task = asyncio.get_running_loop().create_task(
                self._log_flush_loop())
        if self._policy is not None and self._policy_task is None:
            self._policy_task = asyncio.get_running_loop().create_task(
                self._policy_tick_loop())
        if self._verify is not None:
            self._verify.start(asyncio.get_running_loop())

    async def stop(self) -> None:
        if self._verify is not None:
            await self._verify.stop()
        if self._policy_task is not None:
            self._policy_task.cancel()
            try:
                await self._policy_task
            except asyncio.CancelledError:
                pass
            self._policy_task = None
        if self._log_flush_task is not None:
            self._log_flush_task.cancel()
            try:
                await self._log_flush_task
            except asyncio.CancelledError:
                pass
            self._log_flush_task = None
        if self._log_ring:
            self._drain_native_log()
        await self.engine.close()


def create_server(**kwargs) -> BinderServer:
    return BinderServer(**kwargs)
