"""Encoded-answer cache with per-name (tag) invalidation.

The modern incarnation of the reference's legacy cache flags (``-s size``
default 10000, ``-a expiry`` default 60000 ms — reference
``main.js:34-38``, ``README.md:40-44``): resolvers re-ask the same handful
of names continuously, so the fully-encoded response bytes are cached, keyed
on the decoded fields the response depends on (transport semantics,
RD, question, EDNS presence/payload — see ``BinderServer._on_query``;
raw-wire keying would let per-packet EDNS options mint unbounded keys).
Stored values are opaque to this class — the server stores ``(wire,
answers_summary, additional_summary)`` tuples so cache hits keep full
query-log detail.

Correctness properties:
- every entry records the mirror cache's *epoch* (bumped on full
  rebuilds/session events), so a hit can never survive a re-mirror;
- every entry carries a *dependency tag* — the store lookup domain (or
  PTR qname) its answer derives from; a mirrored mutation invalidates
  exactly the tags it touched (``MirrorCache.invalidate``), so one
  churning record no longer evicts every cached answer;
- round-robin is preserved: each miss stores another shuffle variant (up
  to ``variants_cap``), and hits cycle through the collected variants;
- entries expire after ``expiry_ms`` regardless (defense in depth);
- negative answers (NXDOMAIN, and NODATA — NOERROR with no answers) are
  cached like positives but accounted separately (``negative`` flag,
  ``neg_entries``/``neg_hits`` in ``stats()``), so a miss flood of
  nonexistent names is visibly absorbed here instead of hitting the
  resolver engine;
- SERVFAIL and recursion-produced responses are NEVER cached (the callers
  decide; see ``BinderServer._on_query`` — SERVFAIL means the store is
  unavailable or a record is garbage, conditions that must re-check on
  every query).

The **compiled-answer table** (``put_compiled``/``get_compiled``) is the
mutation-time precompiler's install target (``resolver/precompile.py``):
one entry per ``(qtype, qname)``, holding every rotation variant in both
EDNS postures, probed by the serve paths on a per-key miss.  Compiled
entries share the tag index — ``invalidate_tag`` drops them in the same
pass — and the epoch check, but do NOT time-expire: their staleness is
bounded by tag invalidation + the epoch (every change that could affect
them arrives as one or the other), and the table is size-bounded by
insertion-order eviction like the per-key side.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple

from binder_torch.store import names as _names

#: sentinel marking compiled-table keys inside the shared tag index
_COMPILED = object()


class AnswerCache:
    __slots__ = ("size", "compiled_size", "expiry_s", "variants_cap",
                 "_entries", "_compiled", "_by_tag", "hits", "misses",
                 "invalidations", "neg_hits", "compiled_serves",
                 "compiled_installs", "_intern")

    def __init__(self, size: int = 10000, expiry_ms: int = 60000,
                 variants_cap: int = 8,
                 compiled_size: Optional[int] = None,
                 intern=None) -> None:
        # canonicalizer for tag/qname strings entering the long-lived
        # indexes: query-decoded names dedup against the mirror's own
        # domain objects (MirrorCache.canon) or the process-wide pool,
        # so a name is ONE object no matter how many layers index it
        self._intern = intern if intern is not None \
            else _names.intern_name
        self.size = size
        #: compiled-table occupancy bound; defaults to the per-key size
        #: (entries derive 1:1-ish from mirrored names, so operators with
        #: a large zone raise it with the ``precompileSize`` config key)
        self.compiled_size = size if compiled_size is None else compiled_size
        self.expiry_s = expiry_ms / 1000.0
        self.variants_cap = variants_cap
        # key -> [epoch, created, next_variant_idx, [value, ...],
        #         complete, tag, pushed, negative, qkey]
        self._entries: Dict[object, list] = {}
        # (qtype, qname) -> [epoch, next_variant_idx, variants, rotatable,
        #                    tag, negative]
        self._compiled: Dict[Tuple[int, str], list] = {}
        # dependency tag -> keys whose answers derive from it (per-key
        # keys verbatim; compiled keys wrapped as (_COMPILED, qtype, name))
        self._by_tag: Dict[str, Set[object]] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.neg_hits = 0
        self.compiled_serves = 0
        self.compiled_installs = 0

    def _drop(self, key, e) -> None:
        del self._entries[key]
        self._drop_tag(e[5], key)

    def _drop_tag(self, tag, tag_key) -> None:
        keys = self._by_tag.get(tag)
        if keys is not None:
            keys.discard(tag_key)
            if not keys:
                del self._by_tag[tag]

    def get(self, key, epoch: int) -> Optional[object]:
        if self.size <= 0:
            return None
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        if e[0] != epoch or time.monotonic() - e[1] > self.expiry_s:
            self._drop(key, e)
            self.misses += 1
            return None
        variants = e[3]
        if not e[4] and len(variants) < self.variants_cap:
            # rotatable answer set: keep resolving until we've collected
            # enough shuffle variants for fair rotation
            self.misses += 1
            return None
        idx = e[2]
        e[2] = (idx + 1) % len(variants)
        self.hits += 1
        if e[7]:
            self.neg_hits += 1
        return variants[idx]

    def put(self, key, epoch: int, value: object,
            rotatable: bool = False, tag: Optional[str] = None,
            negative: bool = False, qkey: Optional[tuple] = None) -> bool:
        """Record a freshly resolved value.  ``tag`` is the store name
        the answer depends on (defaults handled by the caller);
        ``negative`` marks NXDOMAIN/NODATA answers for the separate
        accounting (never SERVFAIL — callers must not put those at
        all); ``qkey`` is the ``(qtype, qname)`` question identity, kept
        so tag invalidation can tell the precompiler exactly which
        question shapes it dropped.  Returns True exactly when the entry
        just became *complete* (non-rotatable, or the full variant set
        collected) — the signal the server uses to push the entry to the
        native fast path (see BinderServer._on_query)."""
        if self.size <= 0:
            return False
        e = self._entries.get(key)
        if e is not None and e[0] == epoch:
            if len(e[3]) < self.variants_cap:
                e[3].append(value)
                return not e[4] and len(e[3]) == self.variants_cap
            return False
        if e is not None:
            self._drop(key, e)          # stale epoch: replace cleanly
        if len(self._entries) >= self.size:
            # evict oldest insertion (dicts preserve insertion order)
            old_key = next(iter(self._entries))
            self._drop(old_key, self._entries[old_key])
        if tag is not None:
            tag = self._intern(tag)
        if qkey is not None:
            qkey = (qkey[0], self._intern(qkey[1]))
        self._entries[key] = [epoch, time.monotonic(), 0, [value],
                              not rotatable, tag, False, negative, qkey]
        self._by_tag.setdefault(tag, set()).add(key)
        return not rotatable

    def take_push(self, key, epoch: int):
        """Claim a complete entry for promotion to the native fast
        path: returns ``(variant_values, tag)`` exactly once (marking
        the entry pushed), else None.  Promotion happens on an entry's
        FIRST HIT, not at resolve time — one-shot names (the cache-cold
        workload) then never pay the native push cost, while any name
        asked twice is native from its third query on."""
        e = self._entries.get(key)
        if e is None or e[0] != epoch or e[6] or not (
                e[4] or len(e[3]) >= self.variants_cap):
            return None
        e[6] = True
        return e[3], e[5]

    # -- the compiled-answer table (mutation-time precompiler) --

    def put_compiled(self, qtype: int, qname: str, epoch: int,
                     variants: List[object], rotatable: bool,
                     tag: Optional[str], negative: bool = False,
                     evidence_at: Optional[float] = None) -> None:
        """Install (or replace) the precompiled answer set for one
        question.  ``variants`` is the full rotation set, rendered at
        mutation time — the entry is born complete, so the very next
        query for the name serves from it.

        ``evidence_at`` is the monotonic instant of the most recent
        QUERY evidence for this shape (propagated verbatim through
        drop→re-render cycles; refreshed only by an actual serve) —
        None for speculative installs (the startup seed).  Invalidation
        reports the shape for re-render only while that evidence is
        younger than the expiry window, so a name queried once on a
        hot-churning record stops being re-rendered one window later
        instead of forever."""
        if self.compiled_size <= 0 or not variants:
            return
        qname = self._intern(qname)
        if tag is not None:
            tag = self._intern(tag)
        ckey = (qtype, qname)
        old = self._compiled.get(ckey)
        if old is not None:
            self._drop_tag(old[4], (_COMPILED,) + ckey)
        elif len(self._compiled) >= self.compiled_size:
            old_key = next(iter(self._compiled))
            self._drop_compiled(old_key, self._compiled[old_key])
        self._compiled[ckey] = [epoch, 0, variants, rotatable, tag,
                                negative, evidence_at]
        self._by_tag.setdefault(tag, set()).add((_COMPILED,) + ckey)
        self.compiled_installs += 1

    def get_compiled(self, qtype: int, qname: str, epoch: int):
        """Probe the compiled table: ``(variant, rotatable, tag,
        negative)`` with the rotation cursor advanced, or None.  No time
        expiry — coherence comes from the tag index and the epoch."""
        e = self._compiled.get((qtype, qname))
        if e is None:
            return None
        if e[0] != epoch:
            self._drop_compiled((qtype, qname), e)
            return None
        variants = e[2]
        idx = e[1]
        e[1] = (idx + 1) % len(variants)
        e[6] = time.monotonic()   # fresh serving evidence
        self.compiled_serves += 1
        if e[5]:
            self.neg_hits += 1
        return variants[idx], e[3], e[4], e[5]

    def _drop_compiled(self, ckey, e) -> None:
        del self._compiled[ckey]
        self._drop_tag(e[4], (_COMPILED,) + ckey)

    def invalidate_tag(self, tag: str,
                       dropped: Optional[list] = None) -> int:
        """Drop every entry — per-key and compiled — whose answer
        derives from ``tag``; returns how many were dropped.  When
        ``dropped`` is given, ``(qtype, qname, evidence_at)`` triples
        for the dropped entries with QUERY EVIDENCE inside the expiry
        window are appended to it — the precompiler's re-render work
        list.  A per-key entry's evidence is its creation time (a query
        made it); a compiled entry carries its propagated evidence
        timestamp.  Shapes without recent evidence die silently — churn
        on names nobody queries must cost nothing."""
        keys = self._by_tag.pop(tag, None)
        if not keys:
            return 0
        n = 0
        now = time.monotonic() if dropped is not None else 0.0
        for key in keys:
            if (type(key) is tuple and len(key) == 3
                    and key[0] is _COMPILED):
                ckey = key[1:]
                e = self._compiled.pop(ckey, None)
                if e is not None:
                    n += 1
                    if (dropped is not None and e[6] is not None
                            and now - e[6] <= self.expiry_s):
                        dropped.append(ckey + (e[6],))
            else:
                e = self._entries.pop(key, None)
                if e is not None:
                    n += 1
                    if dropped is not None and e[8] is not None:
                        dropped.append(e[8] + (e[1],))
        self.invalidations += n
        return n

    def remaining_ttl_ms(self, key, epoch: int) -> Optional[float]:
        """Milliseconds until this entry's time expiry — a late-completed
        rotatable entry must carry its *remaining* lifetime into the
        native fast path, not a fresh full window."""
        e = self._entries.get(key)
        if e is None or e[0] != epoch:
            return None
        return max(0.0, (self.expiry_s - (time.monotonic() - e[1]))
                   * 1000.0)

    def stats(self) -> dict:
        """Occupancy + economics for the introspection snapshot
        (binder_torch/introspect/status.py `answer_cache` section)."""
        hits, misses = self.hits, self.misses
        total = hits + misses
        return {
            "size": self.size,
            "entries": len(self._entries),
            "hits": hits,
            "misses": misses,
            "hit_ratio": (hits / total) if total else 0.0,
            "invalidations": self.invalidations,
            "expiry_ms": self.expiry_s * 1000.0,
            "neg_hits": self.neg_hits,
            "compiled_entries": len(self._compiled),
            "compiled_serves": self.compiled_serves,
            "compiled_installs": self.compiled_installs,
        }

    def clear(self) -> None:
        self._entries.clear()
        self._compiled.clear()
        self._by_tag.clear()
