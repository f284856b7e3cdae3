"""Watch-driven in-memory mirror of the coordination-store tree.

Port of the reference's ZKCache/TreeNode (``lib/zk.js:20-228``): one node
per domain label, eagerly mirroring the whole subtree under the DNS domain
so the query path never touches the store (SURVEY §3.5 — "what makes §3.2
I/O-free").

Key behaviors preserved:
- ``domain_to_path``: ``a.foo.com → /com/foo/a`` (``lib/zk.js:225-228``).
- One watcher per znode; children diffs keep existing nodes, create+bind
  added ones, unbind removed subtrees (``lib/zk.js:120-138``).
- Full tree rebind on every session event (``lib/zk.js:45-47,68-76``);
  ``is_ready()`` is false only until the first session.
- Unparseable or non-object znode JSON is ignored, keeping prior data
  (``lib/zk.js:139-154``).
- Host-like record types maintain the IP → node reverse map for PTR
  (``lib/zk.js:172-193``).

Deliberate deviations (stale-reverse-entry hazards the reference survey
flags in §7.3; both strictly reduce wrong answers):
- The reverse map only drops an IP entry if it still points at the node
  being updated (the reference deletes unconditionally, clobbering an entry
  another node may now own, ``lib/zk.js:184-185``).
- ``unbind`` also removes the node's reverse entry; the reference leaks it,
  so PTR queries could resolve to hosts that left the tree
  (``lib/zk.js:195-208`` never touches ca_revLookup).

Production-zone-scale representation: nodes store COMPACT
records (``store/names.py`` — host-likes as 4-tuples, everything else
with interned keys) and interned domain strings; ``data`` is a property
that expands on demand so every consumer keeps reading parsed-JSON
shapes, while hot paths read ``TreeNode.rec`` directly.  The
session-event full rebuild is CHUNKED across event-loop passes
(time-budgeted) so a million-name re-mirror never stalls serving or
trips the loop-lag watchdog — the mirror keeps answering from its
existing nodes while the walk re-registers watchers underneath it.
"""
from __future__ import annotations

import asyncio
import ipaddress
import json
import logging
import time
from collections import deque
from typing import Dict, List, Optional

from binder_torch.introspect.loopacct import ACCOUNT
from binder_torch.store import names as _names
from binder_torch.store.interface import StoreClient

# Record types that represent a single addressable host: these maintain the
# reverse (PTR) map and are the types a service's children may carry
# (reference ``lib/zk.js:172-179``) — and exactly the types the compact
# tuple representation covers (the canonical set lives in store/names.py).
HOST_TYPES = _names.HOST_TYPES


def domain_to_path(domain: str) -> str:
    assert domain
    return "/" + "/".join(reversed(domain.split(".")))


def _rev_name(ip: Optional[str]) -> Optional[str]:
    """'10.1.2.3' -> '3.2.1.10.in-addr.arpa', '2001:db8::1' ->
    '...ip6.arpa' (the PTR qname an answer for this address is cached
    under); None for strings that are neither.  For IPv4, no
    canonicalization: the engine does not validate octets either, so a
    non-canonical stored address ('10.1.2.03') pairs with exactly the
    reverse qname a client would use to reach it.  IPv6 addresses are
    canonical by the time they reach here (``TreeNode.ip`` normalizes),
    matching ``wire.ip_from_reverse_name``'s canonical output."""
    if not ip:
        return None
    if ":" in ip:
        try:
            return ipaddress.IPv6Address(ip).reverse_pointer
        except (ValueError, ipaddress.AddressValueError):
            return None
    parts = ip.split(".")
    if len(parts) != 4 or not all(p.isdigit() for p in parts):
        return None
    return ".".join(reversed(parts)) + ".in-addr.arpa"


class TreeNode:
    """One mirrored znode == one domain label (reference TreeNode).

    Memory layout is the point at zone scale: six slots, the domain
    interned, ``kids`` allocated only for interior nodes (None for the
    million leaves), the record compact (``names.compact_record``), and
    ``name``/``path``/``data`` derived on demand instead of stored."""

    __slots__ = ("domain", "cache", "kids", "_rec")

    def __init__(self, cache: "MirrorCache", parent_domain: str,
                 name: str) -> None:
        domain = name if not parent_domain else name + "." + parent_domain
        # NOT pool-interned: each mirrored domain is unique, so the
        # nodes index itself is its canonical home (MirrorCache.canon);
        # pooling a million one-off strings would cost a pool entry per
        # name for zero dedup
        self.domain = domain.lower()
        self.cache = cache
        # labels of current children (a tuple, not a dict of nodes:
        # children resolve through the cache's node index on demand);
        # None for the leaf-heavy common case
        self.kids: Optional[tuple] = None
        self._rec = None
        cache.nodes[self.domain] = self

    @property
    def name(self) -> str:
        return self.domain.split(".", 1)[0]

    @property
    def path(self) -> str:
        return domain_to_path(self.domain)

    @property
    def log(self) -> logging.Logger:
        return self.cache.log

    @property
    def rec(self):
        """The stored record in its COMPACT form: a
        ``names.CompactRec`` tuple for host-like single-address
        records, else the parsed JSON shape.  The hot paths' accessor —
        no per-read allocation."""
        return self._rec

    @property
    def data(self):
        """The record as parsed JSON (dict/list/None) — expanded on
        demand from the compact form.  Equal (``==``) to what
        ``json.loads`` produced; identity is not preserved."""
        return _names.expand_record(self._rec)

    @property
    def ip(self) -> Optional[str]:
        """The address this node's record binds in the reverse map —
        derived from the record (was a stored slot; at a million
        names every slot counts)."""
        rec = self._rec
        addr = None
        if type(rec) is tuple:
            addr = rec[1] if rec[0] in HOST_TYPES else None
        elif isinstance(rec, dict):
            rtype = rec.get("type")
            if isinstance(rtype, str) and rtype in HOST_TYPES:
                sub = rec.get(rtype)
                if isinstance(sub, dict):
                    addr = sub.get("address")
        if addr and ":" in addr:
            # IPv6: the reverse map is keyed by canonical form so a
            # stored "2001:DB8:0::1" meets the canonical string
            # ip_from_reverse_name derives from an ip6.arpa qname
            try:
                return str(ipaddress.IPv6Address(addr))
            except (ValueError, ipaddress.AddressValueError):
                return None
        return addr

    def _kid_node(self, label: str) -> Optional["TreeNode"]:
        return self.cache.nodes.get((label + "." + self.domain).lower())

    @property
    def children(self) -> List["TreeNode"]:
        if not self.kids:
            return []
        out = []
        for label in self.kids:
            node = self._kid_node(label)
            if node is not None:
                out.append(node)
        return out

    # -- watch event handlers --

    def on_children_changed(self, kids: List[str]) -> None:
        cache = self.cache
        cache.bump_gen()
        if cache.m_watch_children is not None:
            cache.m_watch_children.inc()
        # answers that may change: this node's own (service answer sets
        # derive from children) and each newly appearing child's name
        # (a cached REFUSED for it is now wrong); removed subtrees emit
        # their own tags from unbind()
        tags = {self.domain}
        gone = set(self.kids or ())
        changed = False
        for kid in kids:
            if kid in gone:
                gone.discard(kid)       # survives: node stays as-is
            else:
                changed = True
                node = TreeNode(cache, self.domain, kid)
                tags.add(node.domain)
                node.rebind()
        self.kids = tuple(kids) or None
        for label in gone:
            changed = True
            removed = cache.nodes.get((label + "." + self.domain).lower())
            if removed is not None:
                removed.unbind()
        if changed:
            cache.invalidate(tags)
        # unchanged child set (every re-delivery during a session
        # rebuild walk): answers cannot have changed, so no
        # invalidation work — at a million names, per-node invalidation
        # during a re-mirror was the dominant rebuild cost (each event
        # walks the native cache table)

    def on_data_changed(self, data: bytes) -> None:
        cache = self.cache
        cache.bump_gen()
        if cache.m_watch_data is not None:
            cache.m_watch_data.inc()
        try:
            parsed = json.loads(data.decode("utf-8")) if data else None
        except (ValueError, UnicodeDecodeError) as e:
            self.log.warning("ignoring node %s: failed to parse data: %s",
                             self.path, e)
            if cache.m_parse_failures is not None:
                cache.m_parse_failures.inc()
            return                      # old data kept: answers unchanged
        # JS typeof-object check admits dicts, lists, and null
        # (lib/zk.js:149-154); anything else is ignored, keeping old data.
        if parsed is not None and not isinstance(parsed, (dict, list)):
            self.log.warning("ignoring node %s: parsed JSON is not an object",
                             self.path)
            return
        # reverse-map upkeep around the record swap: drop the entry we
        # own under the OLD address (never another node's — the
        # collision guard), install under the new one.  A record that
        # is no longer host-like simply yields ip None, so its entry
        # drops and PTR can't serve a stale mapping.  The unchanged
        # case (same address, entry already ours — every re-delivery
        # during a session rebuild) must NOT del+reinsert: a million
        # same-key delete/insert cycles force periodic O(zone) dict
        # compactions, which is exactly the loop stall the chunked
        # rebuild exists to avoid.
        rec = _names.compact_record(parsed)
        if rec == self._rec:
            # identical record re-delivered — the shape of EVERY data
            # event a session-rebuild walk fires: answers cannot have
            # changed, so skip the invalidation fan-out entirely (the
            # rebuild's epoch bump already revalidates every cached
            # lane; per-name invalidation here was the dominant
            # re-mirror cost at zone scale, one native-table walk per
            # event).  The OLD object is kept on purpose: replacing a
            # zone's worth of (gc-frozen) records with equal copies
            # seeds gen-2 with survivors, and the eventual collection
            # is a ~400 ms serving stall.
            return
        old_ip = self.ip
        self._rec = rec
        new_ip = self.ip
        rev = cache.rev_lookup
        if new_ip != old_ip:
            if old_ip and rev.get(old_ip) is self:
                del rev[old_ip]
            if new_ip:
                rev[new_ip] = self
        elif new_ip and rev.get(new_ip) is not self:
            rev[new_ip] = self          # re-claim a colliding entry

        # answers that may change: this name, the parent's (service
        # answer sets embed child data), and PTR answers for the old and
        # new address
        tags = {self.domain}
        if "." in self.domain:
            tags.add(self.domain.split(".", 1)[1])
        for rev in (_rev_name(old_ip), _rev_name(self.ip)):
            if rev is not None:
                tags.add(rev)
        cache.invalidate(tags)

    # -- lifecycle --

    def rebind(self) -> None:
        """(Re-)register watchers for this subtree (lib/zk.js:209-223).

        Kids that exist *before* re-registering need explicit rebinds; kids
        created during the (possibly synchronous) initial children delivery
        were already bound by on_children_changed and must not be rebound
        again — with a synchronous store that would compound to 2^depth
        redundant rebinds per session event.
        """
        existing = self.children
        self.cache.store.bind_node(self.path, self)
        for kid in existing:
            if self.cache.nodes.get(kid.domain) is kid:
                kid.rebind()

    def rebind_shallow(self, queue: deque) -> None:
        """One node's share of a CHUNKED session rebuild: re-register
        this node's watcher (new kids discovered by the resulting
        children diff still bind recursively — they are new content the
        mirror must pick up whole), then defer the surviving existing
        kids onto the walk queue instead of recursing."""
        existing = self.children
        self.cache.store.bind_node(self.path, self)
        for kid in existing:
            if self.cache.nodes.get(kid.domain) is kid:
                queue.append(kid)

    def unbind(self) -> None:
        self.cache.bump_gen()
        self.log.debug("unbinding node at %s", self.path)
        self.cache.store.unbind_node(self.path, self)
        for kid in self.children:
            kid.unbind()
        if self.cache.nodes.get(self.domain) is self:
            del self.cache.nodes[self.domain]
        tags = {self.domain}
        if "." in self.domain:
            tags.add(self.domain.split(".", 1)[1])
        rev = _rev_name(self.ip)
        if rev is not None:
            tags.add(rev)
        if self.ip and self.cache.rev_lookup.get(self.ip) is self:
            del self.cache.rev_lookup[self.ip]
        self.cache.invalidate(tags)


class MirrorCache:
    """The ZKCache equivalent: domain-keyed node index + reverse-IP index."""

    #: watch events within one STORM_WINDOW that flag a watch storm
    #: (a registrar gone wild or an ensemble replaying a large backlog —
    #: either way the mirror is churning far above steady state and the
    #: flight recorder should keep the evidence)
    STORM_THRESHOLD = 500
    STORM_WINDOW = 1.0

    #: chunked-rebuild pacing: one drain pass re-registers at least
    #: REBUILD_MIN_CHUNK nodes and keeps going until the time budget is
    #: spent, then yields the loop to serving.  The budget is checked
    #: EVERY node past the floor — a node's rebind cost varies by three
    #: orders of magnitude (leaf vs a parent with a thousand children),
    #: so a count-based batch would stall the loop on parent-dense
    #: stretches.  2 ms per pass keeps a million-name rebuild far under
    #: the loop-lag watchdog's 250 ms stall threshold while still
    #: converging in seconds.
    REBUILD_BUDGET_S = 0.002
    REBUILD_MIN_CHUNK = 1

    #: how often the first walk's watch looks whether the mirror holds
    #: the store's tree (the end of the ``walk`` boot phase)
    WALK_POLL_S = 0.02

    def __init__(self, store: StoreClient, domain: str,
                 log: Optional[logging.Logger] = None,
                 collector=None, recorder=None) -> None:
        self.store = store
        self.domain = _names.intern_name(domain.lower())
        self.log = log or logging.getLogger("binder.cache")
        self.recorder = recorder
        self.pool = _names.POOL
        self.nodes: Dict[str, TreeNode] = {}
        self.rev_lookup: Dict[str, TreeNode] = {}
        # offer the node index as the store's direct event routing
        # table (fake store / shard replica feed route synchronously
        # through it; the ZooKeeper client uses it for watch-event
        # dispatch and shared, batched wire watches)
        getattr(store, "bind_source", lambda nodes: False)(self.nodes)
        # staleness instrumentation: monotonic instants of the last
        # applied mutation and the last full rebuild.  While the store
        # session is down no watch events arrive, so the mutation age
        # IS the mirror's staleness bound — the quantity the status
        # endpoint and binder_mirror_staleness_seconds report.
        self.last_mutation_mono: Optional[float] = None
        self.last_rebuild_mono: Optional[float] = None
        # watch-storm window accounting
        self._storm_window_start = 0.0
        self._storm_count = 0
        self._storm_flagged = False
        # generation counter: bumped on every mirrored mutation; drives
        # the balancer's generation broadcast (its cache entries are
        # validated against the backend's advertised gen)
        self.gen = 0
        # epoch: bumped only on full rebuilds (session events), where
        # arbitrary unseen changes may stream in — the in-process answer
        # caches key their entries on this and rely on per-name
        # invalidation (below) for ordinary mutations, so one churning
        # record no longer evicts every cached answer
        self.epoch = 0
        # chunked-rebuild state: the walk queue (None when no rebuild
        # is in flight), a generation guard so a session churning
        # mid-rebuild restarts the walk instead of interleaving two,
        # and the introspection counters the zone-scale bench reads
        self._rebuild_queue: Optional[deque] = None
        self._rebuild_gen = 0
        self._rebuild_started: Optional[float] = None
        self.rebuild_chunks = 0
        self.last_rebuild_duration_s: Optional[float] = None
        # mutation subscribers (e.g. the balancer generation broadcast);
        # called synchronously on every bump — keep them cheap
        self._mutation_cbs: List = []
        # per-name invalidation subscribers: called with a set of
        # dependency tags (lookup domains / PTR qnames) whose answers a
        # mutation may have changed
        self._invalidate_cbs: List = []
        # optional propagation tracer (binder_torch/verify): bump_gen
        # opens each mutation's trace context, invalidate marks the
        # mirror-apply stage — both no-ops when unset
        self.tracer = None
        # store-mirror observability (the reference gets the analogous
        # client metrics by passing its artedi collector into zkstream,
        # lib/zk.js:26-38); all optional — tests build bare caches
        self.m_watch_children = self.m_watch_data = None
        self.m_parse_failures = self.m_rebuilds = None
        self._m_rebuild_chunks = None
        if collector is not None:
            self.m_watch_children = collector.counter(
                "binder_store_watch_events",
                "store watch events applied to the mirror").labelled(
                    {"kind": "children"})
            self.m_watch_data = collector.counter(
                "binder_store_watch_events", "").labelled({"kind": "data"})
            self.m_parse_failures = collector.counter(
                "binder_store_node_parse_failures",
                "znodes whose JSON could not be applied").labelled()
            self.m_rebuilds = collector.counter(
                "binder_store_session_rebuilds",
                "full mirror rebuilds triggered by store session events"
            ).labelled()
            collector.gauge(
                "binder_store_mirrored_nodes",
                "domain nodes currently mirrored from the store"
            ).set_function(lambda: len(self.nodes))
            collector.gauge(
                "binder_store_reverse_entries",
                "IP addresses in the PTR reverse index"
            ).set_function(lambda: len(self.rev_lookup))
            collector.gauge(
                "binder_store_generation",
                "mirror mutation generation counter"
            ).set_function(lambda: self.gen)
            collector.gauge(
                "binder_store_ready",
                "1 when the mirror has a live session and root node"
            ).set_function(lambda: 1.0 if self.is_ready() else 0.0)
            collector.gauge(
                "binder_mirror_staleness_seconds",
                "age of the last change applied to the store mirror "
                "(bounds answer staleness while the session is down)"
            ).set_function(lambda: self.staleness_seconds() or 0.0)
            # zone-scale family (docs/observability.md): every
            # figure the large-zone runbook sizes against is scrapeable
            collector.gauge(
                "binder_mirror_names",
                "names (domain nodes) resident in the mirror"
            ).set_function(lambda: float(len(self.nodes)))
            collector.gauge(
                "binder_mirror_interned_names",
                "canonical name/label objects in the interned-name pool"
            ).set_function(lambda: float(len(self.pool)))
            collector.gauge(
                "binder_mirror_rebuild_pending",
                "nodes awaiting re-bind in the chunked session rebuild "
                "(0 when no rebuild is in flight)"
            ).set_function(lambda: float(self.rebuild_pending()))
            collector.gauge(
                "binder_mirror_rebuild_seconds",
                "wall-clock duration of the last completed session "
                "rebuild").set_function(
                    lambda: self.last_rebuild_duration_s or 0.0)
            self._m_rebuild_chunks = collector.counter(
                "binder_mirror_rebuild_chunks",
                "event-loop passes spent draining chunked session "
                "rebuilds").labelled()
            self._m_rebuild_chunks.inc(0)
        store.on_session(self.rebuild)

    def on_mutation(self, cb) -> None:
        """Subscribe to generation bumps (any mirrored store mutation)."""
        self._mutation_cbs.append(cb)

    def on_invalidate(self, cb) -> None:
        """Subscribe to per-name invalidation: cb(tags) where tags is a
        set of lookup domains / PTR qnames whose answers may have
        changed (see TreeNode's watch handlers)."""
        self._invalidate_cbs.append(cb)

    def invalidate(self, tags) -> None:
        if not tags:
            return
        if self.tracer is not None:
            self.tracer.on_mirror_applied()
        for cb in self._invalidate_cbs:
            try:
                cb(tags)
            except Exception:  # noqa: BLE001 — a subscriber bug must
                self.log.exception("invalidate callback failed")  # not stop serving

    def bump_gen(self) -> None:
        self.gen += 1
        if self.tracer is not None:
            self.tracer.on_store_event(self.gen)
        now = time.monotonic()
        self.last_mutation_mono = now
        if self.recorder is not None:
            # watch-storm detection: count mutations per fixed window,
            # flag once per window when the threshold is crossed
            if now - self._storm_window_start > self.STORM_WINDOW:
                self._storm_window_start = now
                self._storm_count = 0
                self._storm_flagged = False
            self._storm_count += 1
            if (self._storm_count >= self.STORM_THRESHOLD
                    and not self._storm_flagged):
                self._storm_flagged = True
                self.recorder.record(
                    "watch-storm", events=self._storm_count,
                    window_s=self.STORM_WINDOW, generation=self.gen)
        for cb in self._mutation_cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001 — a subscriber bug must not
                self.log.exception("mutation callback failed")  # stop serving

    def is_ready(self) -> bool:
        return self.domain in self.nodes

    def synced(self) -> bool:
        """True once the mirror holds the store's tree: a session's
        walk has started, no rebuild chunk is pending, and the store
        has no fetch outstanding."""
        return (self.is_ready() and not self.rebuild_pending()
                and not self.store.syncing())

    def watch_first_walk(self, loop) -> asyncio.Task:
        """Record the ``walk`` boot phase (introspect/loopacct.py): from
        the store session's first establishment to the mirror holding
        the store's tree (:meth:`synced`).  Returns the task that
        records it and then ends."""
        started: list = []

        def on_session() -> None:
            if not started:
                started.append(ACCOUNT.phase_start())

        self.store.on_session(on_session)

        async def watch() -> None:
            while not started or not self.synced():
                await asyncio.sleep(self.WALK_POLL_S)
            ACCOUNT.phase_end("walk", started[0])

        # kept here: the loop holds its tasks weakly
        self._walk_task = loop.create_task(watch())
        return self._walk_task

    def staleness_seconds(self) -> Optional[float]:
        """Age of the last applied change (mutation or full rebuild).

        While the store session is live this is ordinary quiet time;
        with the session down it bounds how old the mirror's answers
        may be — the "silent aging" quantity a pure query-side view
        cannot see.  None when nothing was ever mirrored."""
        last = self.last_mutation_mono
        if last is None or (self.last_rebuild_mono is not None
                            and self.last_rebuild_mono > last):
            last = self.last_rebuild_mono
        if last is None:
            return None
        return time.monotonic() - last

    def lookup(self, domain: str) -> Optional[TreeNode]:
        return self.nodes.get(domain)

    def canon(self, name: str) -> str:
        """The canonical object for *name*: the mirror's own domain
        string when the name is mirrored (the nodes index is the
        canonical home for mirrored names), else the process-wide
        interned-name pool.  The answer cache's tag index and the
        compiled-answer table intern through this, so a name is ONE
        object no matter how many layers index it."""
        node = self.nodes.get(name)
        if node is not None:
            return node.domain
        return _names.intern_name(name)

    def reverse_lookup(self, ip: str) -> Optional[TreeNode]:
        return self.rev_lookup.get(ip)

    # -- traced entry points (per-stage attribution) --
    #
    # The resolver hands its QueryCtx in so the mirror probe gets its
    # own phase stamp ("store-lookup") on the query's attribution
    # timeline; the lookup itself is identical.  Kept as separate
    # methods so non-query callers (zone refresh, tests) pay nothing.

    def invalidate_all(self, reason: str = "") -> None:
        """Epoch bump OUTSIDE a rebuild: every answer cached anywhere
        (Python answer cache, compiled table, native C caches, the
        balancer) must revalidate.  Used by the degradation policy at
        state transitions — an answer rendered under one staleness mode
        must never be served under another (e.g. a fresh-rendered wire
        into exhaustion, or an unclamped TTL while stale-serving).

        Deliberately does NOT touch the staleness timestamps: the
        mirror's data did not change, only its permissibility — the
        staleness clock must keep aging."""
        self.epoch += 1
        if self.recorder is not None:
            self.recorder.record("cache-flush", reason=reason,
                                 epoch=self.epoch)
        for cb in self._mutation_cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001 — a subscriber bug must
                self.log.exception("mutation callback failed")  # not stop serving

    def lookup_traced(self, domain: str, query) -> Optional[TreeNode]:
        node = self.nodes.get(domain)
        query.stamp("store-lookup")
        return node

    def reverse_lookup_traced(self, ip: str, query) -> Optional[TreeNode]:
        node = self.rev_lookup.get(ip)
        query.stamp("store-lookup")
        return node

    # -- session rebuild (chunked at zone scale) --

    def rebuild(self) -> None:
        """Re-mirror from scratch-or-current on (re)session
        (lib/zk.js:68-76).

        The walk over EXISTING nodes is chunked: each event-loop pass
        re-registers a time-budgeted batch of watchers and yields, so
        serving (from the still-resident node data) continues and the
        loop-lag watchdog stays quiet through a million-name re-mirror.
        Brand-new subtrees discovered along the way still bind
        synchronously — they are unmirrored content.  Without a running
        loop (synchronous stores, tests, startup before serving) the
        drain runs inline to completion, preserving the historical
        fully-synchronous semantics."""
        if self.m_rebuilds is not None:
            self.m_rebuilds.inc()
        self.last_rebuild_mono = time.monotonic()
        if self.recorder is not None:
            self.recorder.record("mirror-rebuild", epoch=self.epoch + 1,
                                 nodes=len(self.nodes))
        # a (re)session may deliver arbitrary unseen changes while the
        # subtree re-syncs: conservatively invalidate every cached answer
        self.epoch += 1
        tn = self.nodes.get(self.domain)
        if tn is None:
            parts = self.domain.split(".")
            tn = TreeNode(self, ".".join(parts[1:]), parts[0])
        self._rebuild_gen += 1
        self._rebuild_started = time.perf_counter()
        self._rebuild_queue = deque((tn,))
        self._drain_rebuild(self._rebuild_gen)

    def rebuild_pending(self) -> int:
        """Nodes still awaiting re-bind in the in-flight chunked
        rebuild (0 when none is running)."""
        q = self._rebuild_queue
        return len(q) if q is not None else 0

    def rebuild_info(self) -> dict:
        """Introspection block for the /status mirror section."""
        return {
            "pending": self.rebuild_pending(),
            "chunks": self.rebuild_chunks,
            "last_duration_seconds": self.last_rebuild_duration_s,
        }

    @ACCOUNT.spans("boot.walk")
    def _drain_rebuild(self, gen: int) -> None:
        q = self._rebuild_queue
        while q and gen == self._rebuild_gen:
            t0 = time.perf_counter()
            n = 0
            self.rebuild_chunks += 1
            if self._m_rebuild_chunks is not None:
                self._m_rebuild_chunks.inc()
            while q and gen == self._rebuild_gen:
                node = q.popleft()
                if self.nodes.get(node.domain) is not node:
                    continue            # subtree left mid-walk
                node.rebind_shallow(q)
                n += 1
                if (n >= self.REBUILD_MIN_CHUNK
                        and time.perf_counter() - t0
                        >= self.REBUILD_BUDGET_S):
                    break
            if not q or gen != self._rebuild_gen:
                break
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                continue                # no loop: drain inline
            loop.call_soon(self._rebuild_tick, gen)
            return
        if gen != self._rebuild_gen:
            return                      # superseded by a newer rebuild
        self._rebuild_queue = None
        if self._rebuild_started is not None:
            self.last_rebuild_duration_s = (time.perf_counter()
                                            - self._rebuild_started)
            self._rebuild_started = None
        if self.recorder is not None:
            self.recorder.record(
                "mirror-rebuild-done", epoch=self.epoch,
                nodes=len(self.nodes), chunks=self.rebuild_chunks,
                duration_s=round(self.last_rebuild_duration_s or 0.0, 4))

    def _rebuild_tick(self, gen: int) -> None:
        if gen != self._rebuild_gen:
            return
        self._drain_rebuild(gen)

    def stop(self) -> None:
        self.store.close()
