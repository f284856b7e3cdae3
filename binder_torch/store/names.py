"""Interned-name pool + compact node records: the million-name store
representation.

Every structure that touches a DNS name — the mirror's node index, the
reverse (PTR) map, the answer cache's dependency-tag index, the
compiled-answer table, the shard mutation log — used to hold its own
copy of the same strings, and every mirrored znode held a freshly
parsed JSON dict whose *keys* alone ("type", "host", "address")
dominated per-name RSS at scale (json.loads memoizes keys within one
document only; across a million parses each key exists a million
times).  "Parsing Millions of DNS Records per Second"
(arXiv:2411.12035) makes the general point: at record-set scale the
representation, not the parser, is what falls over.

Two tools, shared process-wide through the module-level :data:`POOL`:

- :class:`NamePool` — one canonical ``str``/``bytes`` object per
  label/name/tag.  Interning is a dict probe; a sweep pass (triggered
  by growth, refcount-based) drops names nothing references anymore,
  so a churning zone can't grow the pool without bound.
- ``compact_record`` / ``expand_record`` — the dominant znode shape
  (a host-like record: ``{"type": t, t: {"address": a}}`` with
  optional integer TTLs) collapses to a 4-tuple
  ``(rtype, address, ttl, sub_ttl)``; everything else keeps its parsed
  form with interned keys.  ``expand_record`` reconstructs an equal
  dict on demand (``TreeNode.data`` is a property), so every existing
  consumer — engine, zone pushes, shard snapshot frames — reads the
  same shape it always did, while hot paths read the tuple directly
  via ``TreeNode.rec``.

Measured (tools/zone_probe.py): the dict-per-node mirror cost
~2.1 KB/name at 100k names; the interned + compact representation is
a ≥5x cut.
"""
from __future__ import annotations

import sys
from typing import Optional, Tuple

#: compact record: (rtype, address, ttl, sub_ttl) — ttls None when the
#: record did not carry them (DEFAULT_TTL applies at resolve time)
CompactRec = Tuple[str, str, Optional[int], Optional[int]]

#: pool size below which the sweep never runs (tiny test zones)
_SWEEP_FLOOR = 4096


class NamePool:
    """Canonical-object pool for names, labels, and wire-format names.

    ``intern``/``intern_bytes`` return THE process-wide object for a
    value; callers drop their private copy on the floor.  Dead entries
    (nothing but the pool referencing them) are reclaimed by a sweep
    pass that runs opportunistically when the pool has doubled since
    the last sweep — amortized O(1) per intern, so the mutation path
    never pays a full pass at a bad time.
    """

    __slots__ = ("_strs", "_bytes", "hits", "sweeps", "_next_sweep")

    def __init__(self) -> None:
        self._strs: dict = {}
        self._bytes: dict = {}
        self.hits = 0
        self.sweeps = 0
        self._next_sweep = _SWEEP_FLOOR

    def intern(self, s: str) -> str:
        c = self._strs.get(s)
        if c is not None:
            self.hits += 1
            return c
        self._strs[s] = s
        if len(self._strs) + len(self._bytes) >= self._next_sweep:
            self.sweep()
        return s

    def intern_bytes(self, b: bytes) -> bytes:
        c = self._bytes.get(b)
        if c is not None:
            self.hits += 1
            return c
        self._bytes[b] = b
        if len(self._strs) + len(self._bytes) >= self._next_sweep:
            self.sweep()
        return b

    def sweep(self) -> int:
        """Drop entries nothing outside the pool references; returns
        how many were dropped.  A pooled value's refcount is 3 when
        only the pool holds it (dict key + dict value + the getrefcount
        argument), so anything above that is live somewhere."""
        getref = sys.getrefcount
        dropped = 0
        for pool in (self._strs, self._bytes):
            # key snapshot: an intern from another thread (a shard
            # replica's blocking snapshot reader) must not blow up the
            # sweep's iteration
            dead = [s for s in list(pool) if getref(s) <= 5]
            # <= 5: pool key + value + snapshot list + iteration
            # variable + the getrefcount argument
            for s in dead:
                pool.pop(s, None)
            dropped += len(dead)
        self.sweeps += 1
        self._next_sweep = max(_SWEEP_FLOOR,
                               2 * (len(self._strs) + len(self._bytes)))
        return dropped

    def __len__(self) -> int:
        return len(self._strs) + len(self._bytes)

    def stats(self) -> dict:
        return {
            "interned": len(self._strs) + len(self._bytes),
            "interned_str": len(self._strs),
            "interned_bytes": len(self._bytes),
            "hits": self.hits,
            "sweeps": self.sweeps,
        }


#: THE pool.  One per process on purpose: the mirror, the answer
#: cache's tag index, the compiled-answer table, and a shard worker's
#: replica feed all intern through here, which is what makes a name
#: ONE object no matter how many layers index it.
POOL = NamePool()

intern_name = POOL.intern
intern_wire = POOL.intern_bytes

#: keys a compactable record may carry, nothing else (an extra field
#: must survive round-trips verbatim, so records carrying one keep
#: their dict form)
_SUB_KEYS = frozenset(("address", "ttl"))

#: the record types that compact: exactly the host-like single-address
#: types (the canonical list, re-exported as ``store.cache.HOST_TYPES``).
#: Service/database/unknown types always keep their dict form so every
#: consumer branch that special-cases them sees the shape it expects.
HOST_TYPES = frozenset({
    "db_host", "host", "load_balancer", "moray_host",
    "redis_host", "ops_host", "rr_host",
})


def compact_record(parsed):
    """Compact a parsed znode value.  Host-like single-address records
    become a ``CompactRec`` tuple (a shape JSON can never produce, so
    ``type(rec) is tuple`` is an unambiguous representation marker);
    every other dict keeps its structure with interned keys; lists and
    None pass through."""
    if type(parsed) is not dict:
        return parsed
    rtype = parsed.get("type")
    if type(rtype) is str and rtype in HOST_TYPES:
        sub = parsed.get(rtype)
        if (type(sub) is dict and len(parsed) <= 3
                and type(sub.get("address")) is str
                and _SUB_KEYS.issuperset(sub)):
            ttl = parsed.get("ttl")
            sttl = sub.get("ttl")
            extra = len(parsed) - 2 - (ttl is not None)
            if (extra == 0 and (ttl is None or type(ttl) is int)
                    and (sttl is None or type(sttl) is int)):
                # the rtype recurs across the whole zone (intern); the
                # address is unique per host — pooling it would cost a
                # pool entry per name for zero dedup (the reverse map
                # shares this same object naturally).  The dominant
                # TTL-less shape packs to a 2-tuple.
                if ttl is None and sttl is None:
                    return (intern_name(rtype), sub["address"])
                return (intern_name(rtype), sub["address"], ttl, sttl)
    return _intern_keys(parsed)


def _intern_keys(obj):
    """Intern every dict key (and short ``type``-ish string values stay
    as-is — values are high-cardinality, keys are not) through the
    nested structure of a non-compactable record, in place where
    possible."""
    if type(obj) is dict:
        return {intern_name(k) if type(k) is str else k: _intern_keys(v)
                for k, v in obj.items()}
    if type(obj) is list:
        return [_intern_keys(v) for v in obj]
    if type(obj) is str and len(obj) <= 32:
        return intern_name(obj)
    return obj


def rec_parts(rec: tuple) -> CompactRec:
    """Uniform ``(rtype, address, ttl, sub_ttl)`` view of a compact
    record (the TTL-less shape is stored as a 2-tuple)."""
    if len(rec) == 4:
        return rec
    return (rec[0], rec[1], None, None)


def expand_record(rec):
    """The inverse of ``compact_record`` for the tuple form: rebuild an
    equal dict (``==`` to the original parse; key order is not part of
    the contract).  Non-tuples pass through untouched."""
    if type(rec) is not tuple:
        return rec
    rtype, addr, ttl, sttl = rec_parts(rec)
    sub = {"address": addr}
    if sttl is not None:
        sub["ttl"] = sttl
    out = {"type": rtype, rtype: sub}
    if ttl is not None:
        out["ttl"] = ttl
    return out
