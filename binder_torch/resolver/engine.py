"""Query-resolution engine — the business logic of the DNS service.

Port of the reference's ``lib/server.js`` ``resolve()`` (:136-429) and
``resolvePtr()`` (:67-134), preserving its deliberate, failover-oriented
rcode policy exactly (SURVEY §7.3 calls these "behaviorally load-bearing"):

- Names outside the DNS domain, invalid names, SRV-shaped names that don't
  parse, and cache misses (without recursion) are **REFUSED**, not
  NXDOMAIN/NODATA, so downstream resolvers fail over to their next
  nameserver instead of erroring out (comment at ``lib/server.js:227-241``).
- The store being unavailable is **SERVFAIL** (``lib/server.js:186-192``).
- An SRV query for a name we own that isn't a service gets NOERROR +
  SOA authority (NODATA with negative-caching TTL, ``lib/server.js:276-292``).
- An SRV query whose service/proto labels don't match the registered ones
  is **NXDOMAIN** (``lib/server.js:334-345``).
- TTL precedence is three-level, deepest-object-wins: default 30s ←
  record.ttl ← record[type].ttl, plus the nested ``service.service`` case
  (``lib/server.js:262-274,326-332``) and min(service-ttl, member-ttl) for
  plain-A service answers (``lib/server.js:403-414``).

Known deviation: the reference's "doubled-up dns domain suffix" REFUSED
check (``lib/server.js:167-175``) is dead code — its ``stripSuffix`` helper
appends ``'...'`` to the stripped name, so the subsequent ``isSuffix`` never
matches.  We implement the evident intent (refuse ``x.foo.com.foo.com`` and
``x.foo.com.<dc>.foo.com``); the externally visible rcode is REFUSED either
way (the reference would miss the cache and refuse too), but we skip the
pointless recursion attempt the reference would make.
"""
from __future__ import annotations

import logging
import random
import re
from typing import Optional
from urllib.parse import urlparse

from binder_torch.dns.query import QueryCtx
from binder_torch.dns.wire import (
    ARecord,
    PTRRecord,
    Rcode,
    SOARecord,
    SRVRecord,
    Type,
    ip_from_reverse_name,
)
from binder_torch.store.cache import MirrorCache
from binder_torch.store.names import rec_parts as _rec_parts

SRV_RE = re.compile(r"^(_[^_.]*)\.(_[^_.]*)\.(.*)$")
NAME_RE = re.compile(r"[^a-z0-9_.-]")

# Child record types eligible to back a service answer
# (lib/server.js:352-360 — note: plain 'host' and 'db_host' are excluded).
SERVICE_CHILD_TYPES = frozenset({
    "load_balancer", "moray_host", "ops_host", "rr_host", "redis_host",
})

# Record types the engine answers with a single A from the record's own
# address (lib/server.js:306-320) — also exactly the types the compact
# tuple representation fast-paths.
HOST_LIKE_TYPES = frozenset({
    "db_host", "host", "load_balancer", "moray_host", "redis_host",
    "ops_host", "rr_host",
})

DEFAULT_TTL = 30  # reference lib/server.js:270 (the ZK session timeout)


def _is_suffix(suffix: str, s: str) -> bool:
    return s.endswith(suffix)


def _record_ttl(record: dict, sub: dict, default: int = DEFAULT_TTL) -> int:
    """Deepest-object-wins TTL precedence (lib/server.js:262-274)."""
    ttl = default
    if isinstance(record, dict) and record.get("ttl") is not None:
        ttl = record["ttl"]
    if isinstance(sub, dict) and sub.get("ttl") is not None:
        ttl = sub["ttl"]
    return ttl


def _valid_record(record) -> bool:
    """Record must be a dict with a string type and an object sub-record
    (lib/server.js:251-259)."""
    return (isinstance(record, dict)
            and isinstance(record.get("type"), str)
            and isinstance(record.get(record["type"]), dict))


class AnswerPlan:
    """Outcome of PURE resolution for one question — no transport, no
    RD/EDNS posture, no QueryCtx.  The plan/render split exists so the
    same resolution logic serves two callers:

    - the query path (``Resolver.resolve``/``resolve_ptr``): plan, then
      apply to the live QueryCtx (shuffle rotatable groups, respond);
    - the mutation-time precompiler (``resolver/precompile.py``): plan
      once per affected name when the mirror changes, render every
      rotation variant to wire, and install the finished answers so
      post-churn queries never pay a resolve.

    ``groups`` is the rotation unit list: each element is
    ``(answers, additionals)`` for one service member (or the single
    answer for non-service shapes).  The query path shuffles groups
    (round-robin); the precompiler renders cyclic rotations of them.

    Known deviation from the pre-split engine: a service with an
    invalid member record still answers SERVFAIL, but with an empty
    answer section (the old code kept the members it had already
    shuffled past — answer content on SERVFAIL is not load-bearing and
    SERVFAIL is never cached).
    """

    __slots__ = ("rcode", "groups", "authorities", "rotatable",
                 "dep_domain", "miss", "reason", "log_query", "stale")

    def __init__(self) -> None:
        self.rcode = Rcode.NOERROR
        self.groups: list = []        # [(answers, additionals)] per unit
        self.authorities: list = []
        self.rotatable = False
        self.dep_domain: Optional[str] = None
        #: the mirror had no node for the name — the recursion-candidate
        #: shape (rcode is REFUSED; the query path may forward instead)
        self.miss = False
        self.reason: Optional[str] = None      # log_ctx["reason"]
        self.log_query: Optional[dict] = None  # log_ctx["query"]
        #: resolved from a stale mirror (degradation policy: session
        #: down, within maxStalenessSeconds, TTLs clamped)
        self.stale = False

    @property
    def negative(self) -> bool:
        """NXDOMAIN or NODATA (NOERROR with an empty answer section) —
        the shapes the answer cache accounts separately (and SERVFAIL
        is never cached at all)."""
        return (self.rcode == Rcode.NXDOMAIN
                or (self.rcode == Rcode.NOERROR and not self.groups))


class Resolver:
    """Stateless resolution engine over a mirror cache (+ optional
    recursion)."""

    def __init__(self, zk_cache: MirrorCache, dns_domain: str,
                 datacenter_name: str = "",
                 recursion=None,
                 log: Optional[logging.Logger] = None,
                 rng: Optional[random.Random] = None) -> None:
        self.cache = zk_cache
        self.dns_domain = dns_domain.lower() if dns_domain else ""
        self.datacenter_name = datacenter_name
        self.recursion = recursion
        self.log = log or logging.getLogger("binder.resolver")
        self.rng = rng or random.Random()
        # degradation policy engine hooks, assigned by BinderServer
        # (binder_torch/policy): `policy` gates stale serving (TTL clamp /
        # withhold past the cap), `admission` rate-limits the
        # recursion-triggering shape per client.  None = classic
        # behavior (serve the mirror forever, forward every miss).
        self.policy = None
        self.admission = None

    # -- entry point used by the server engine (lib/server.js:491-506) --
    #
    # Synchronous: cache-served queries complete inline (the hot path);
    # only the recursion handoff returns an awaitable for the caller to
    # drive (cross-DC network I/O).

    def handle(self, query: QueryCtx):
        qt = query.qtype()
        if qt in (Type.A, Type.SRV):
            return self.resolve(query)
        if qt == Type.PTR:
            return self.resolve_ptr(query)
        # anything unsupported we tell the client the truth
        query.set_error(Rcode.NOTIMP)
        query.respond()
        return None

    # -- forward resolution (lib/server.js:136-429) --
    #
    # resolve() = plan() + apply: plan is the PURE resolution (also the
    # mutation-time precompiler's entry point); apply handles the live
    # query's concerns — log context, attribution stamps, the recursion
    # handoff (RD-dependent, so it cannot live in the plan), round-robin
    # shuffle, and the respond.

    def resolve(self, query: QueryCtx):
        plan = self.plan(query.name(), query.qtype())
        return self._finish(query, plan)

    def plan(self, qname: str, qtype: int) -> AnswerPlan:
        """Pure resolution of an A/SRV question against the mirror."""
        p = AnswerPlan()
        domain = qname

        service = protocol = None
        if qtype == Type.SRV:
            m = SRV_RE.match(domain)
            if not m or len(m.group(3)) < 1:
                p.reason = "not a valid SRV lookup domain"
                p.rcode = Rcode.REFUSED
                return p
            service, protocol, domain = m.group(1), m.group(2), m.group(3)

        if self.dns_domain:
            if _is_suffix("." + self.dns_domain, domain):
                stripped = domain[:-(len(self.dns_domain) + 1)]
            else:
                p.reason = "not within dns domain suffix"
                p.rcode = Rcode.REFUSED
                return p
            dcsuff = self.dns_domain + "." + self.datacenter_name
            if (stripped == self.dns_domain
                    or _is_suffix("." + self.dns_domain, stripped)
                    or stripped == dcsuff
                    or _is_suffix("." + dcsuff, stripped)):
                p.reason = "doubled-up dns domain suffix"
                p.rcode = Rcode.REFUSED
                return p

        p.log_query = {
            "srv": f"{service}.{protocol}" if service else None,
            "name": domain,
            "type": Type.name(qtype),
        }

        if not self.cache.is_ready():
            self.log.error("no coordination-store session")
            p.rcode = Rcode.SERVFAIL
            return p

        if len(domain) < 1:
            p.rcode = Rcode.REFUSED
            return p

        domain = domain.lower()
        if NAME_RE.search(domain):
            p.reason = "invalid name"
            p.rcode = Rcode.REFUSED
            return p

        # degradation gate (docs/degradation.md): past the staleness
        # cap the mirror's data may no longer be served at all; within
        # it, answers flow with clamped TTLs (_apply_stale at the
        # positive returns below)
        mode = self._policy_mode()
        if mode == "stale-exhausted":
            return self._withhold(p, domain)
        stale = mode == "stale-serving"

        # dependency tag for the answer caches: whatever this lookup
        # yields (including a miss-REFUSED) changes when `domain`
        # mutates in the store — note for SRV this is the *service node*
        # domain, not the _svc._proto-prefixed qname
        p.dep_domain = domain
        node = self.cache.lookup(domain)

        if node is None:
            # REFUSED, not NXDOMAIN: clients must fail over to their next
            # nameserver (lib/server.js:227-241).  The query path may
            # forward to recursion instead (RD-dependent, see _finish).
            p.miss = True
            p.rcode = Rcode.REFUSED
            return p

        rec = node.rec
        if type(rec) is tuple and rec[0] in HOST_LIKE_TYPES:
            # compact host-like record (store/names.py): the dominant
            # zone shape, resolved without materializing its dict form.
            # Exactly the single-A / SRV-on-non-service outcomes of the
            # generic branch below, same TTL precedence.
            rtype, addr, rttl, rsttl = _rec_parts(rec)
            ttl = rsttl if rsttl is not None else (
                rttl if rttl is not None else DEFAULT_TTL)
            if service is not None:
                # SRV on a non-service name we own: NODATA + SOA for
                # negative caching (lib/server.js:276-292)
                p.authorities.append(SOARecord(
                    name=domain, ttl=ttl, mname=self.dns_domain,
                    minimum=ttl))
                return self._apply_stale(p, stale)
            p.groups.append(([ARecord(name=domain, ttl=ttl,
                                      address=addr)], []))
            return self._apply_stale(p, stale)

        record = node.data
        if not _valid_record(record):
            self.log.error("invalid store record at %s: %r", domain, record)
            p.rcode = Rcode.SERVFAIL
            return p

        sub = record[record["type"]]
        ttl = _record_ttl(record, sub)

        if service is not None and record["type"] != "service":
            # SRV on a non-service name we own: NODATA + SOA for negative
            # caching (lib/server.js:276-292)
            p.authorities.append(SOARecord(
                name=domain, ttl=ttl, mname=self.dns_domain, minimum=ttl))
            return self._apply_stale(p, stale)

        rtype = record["type"]
        if rtype == "database":
            addr = urlparse(sub.get("primary", "")).hostname
            p.groups.append(([ARecord(name=domain, ttl=ttl, address=addr)],
                             []))
        elif rtype in HOST_LIKE_TYPES:
            p.groups.append(([ARecord(name=domain, ttl=ttl,
                                      address=sub.get("address"))], []))
        elif rtype == "service":
            self._plan_service(p, node, record, qname, domain,
                               service, protocol, ttl)
        else:
            self.log.error("record type %r in store is unknown", rtype)
        return self._apply_stale(p, stale)

    # -- degradation-policy plumbing (binder_torch/policy/degrade.py) --

    def _policy_mode(self) -> str:
        return "fresh" if self.policy is None else self.policy.mode()

    def _withhold(self, p: AnswerPlan, domain: str) -> AnswerPlan:
        """The stale-exhausted shape: the mirror is older than
        maxStalenessSeconds and its data may not be served.  Per
        config: SERVFAIL (clients fail over, the engine's standing
        policy for a broken store) or NODATA + SOA (negative-cacheable
        at the clamp TTL)."""
        pol = self.policy
        pol.note_withheld()
        p.reason = "stale beyond maxStalenessSeconds"
        p.dep_domain = domain
        if pol.exhausted_action == "nodata":
            ttl = pol.stale_ttl_clamp_s
            p.authorities.append(SOARecord(
                name=domain, ttl=ttl, mname=self.dns_domain,
                minimum=ttl))
        else:
            p.rcode = Rcode.SERVFAIL
        return p

    def _apply_stale(self, p: AnswerPlan, stale: bool) -> AnswerPlan:
        """Mark and TTL-clamp a plan resolved from a stale mirror
        (RFC 8767 §5: low TTLs so clients re-ask and converge fast
        after recovery)."""
        if stale:
            clamp = self.policy.stale_ttl_clamp_s
            for answers, additionals in p.groups:
                for rec in answers:
                    rec.ttl = min(rec.ttl, clamp)
                for rec in additionals:
                    rec.ttl = min(rec.ttl, clamp)
            for rec in p.authorities:
                rec.ttl = min(rec.ttl, clamp)
            p.stale = True
            self.policy.note_stale_served()
        return p

    def _plan_service(self, p: AnswerPlan, node, record: dict, qname: str,
                      domain: str, service: Optional[str],
                      protocol: Optional[str], ttl: int) -> None:
        s = record["service"]
        if isinstance(s.get("service"), dict):
            # nested historical format; TTL may live here too
            s = s["service"]
        if s.get("ttl") is not None:
            ttl = s["ttl"]

        if service is not None and (service != s.get("srvce")
                                    or protocol != s.get("proto")):
            # SRV for a service/proto that doesn't match the registered
            # one: we own the name, so NXDOMAIN (lib/server.js:334-345)
            p.rcode = Rcode.NXDOMAIN
            return

        # explicit NOERROR so an empty service doesn't fall through
        # (lib/server.js:347-351)
        p.rcode = Rcode.NOERROR

        kids = []
        for k in node.children:
            kr = k.rec
            if type(kr) is tuple:
                if kr[0] in SERVICE_CHILD_TYPES:
                    kids.append(k)
            elif isinstance(kr, dict) \
                    and kr.get("type") in SERVICE_CHILD_TYPES:
                kids.append(k)

        for knode in kids:
            kr = knode.rec
            if type(kr) is tuple:
                # compact member: address always present, no ports key
                _kt, addr, kttl, ksttl = _rec_parts(kr)
                ports = [s.get("port")]
                rttl = ksttl if ksttl is not None else (
                    kttl if kttl is not None else ttl)
            else:
                krec = kr
                if not _valid_record(krec):
                    p.rcode = Rcode.SERVFAIL
                    p.groups = []
                    self.log.error("bad store info under %s", domain)
                    return
                ksub = krec[krec["type"]]
                addr = ksub.get("address")
                if addr is None:
                    continue
                ports = ksub.get("ports")
                if not ports:
                    ports = [s.get("port")]
                rttl = _record_ttl(krec, ksub, ttl)

            if service is not None:
                nm = f"{knode.name}.{domain}"
                answers = [SRVRecord(
                    name=qname, ttl=ttl, priority=0, weight=10,
                    port=prt, target=nm) for prt in ports]
                p.groups.append(
                    (answers, [ARecord(name=nm, ttl=rttl, address=addr)]))
            else:
                # plain A for a service: membership AND address — use the
                # smaller of the two TTLs (lib/server.js:403-414)
                p.groups.append(([ARecord(name=domain, ttl=min(ttl, rttl),
                                          address=addr)], []))
        p.rotatable = len(p.groups) > 1

    def _finish(self, query: QueryCtx, plan: AnswerPlan):
        """Apply a plan to a live query: log context, the store-lookup
        attribution stamp, the RD-dependent recursion handoff, group
        shuffle (round-robin), and the respond."""
        if plan.log_query is not None:
            query.log_ctx["query"] = plan.log_query
        if plan.reason is not None:
            query.log_ctx["reason"] = plan.reason
        if plan.dep_domain is not None:
            query.dep_domain = plan.dep_domain
        if plan.stale:
            query.log_ctx["stale"] = True
        # decode→policy→mirror probe→plan, on the attribution timeline
        query.stamp("store-lookup")
        if plan.miss and self.recursion is not None and query.rd():
            adm = self.admission
            if adm is not None and not adm.allow_recursion(query.src[0]):
                # recursion-triggering floods are shed per client
                # BEFORE any upstream work (docs/degradation.md):
                # well-formed REFUSED, clients fail over.  The shed is
                # a PER-CLIENT transient — it must never enter the
                # shared answer cache, or one client's flood poisons
                # the name with REFUSED for everyone until expiry
                query.no_store = True
                query.set_error(Rcode.REFUSED)
                query.log_ctx["reason"] = "recursion rate limit"
                query.stamp("pre-resp")
                query.respond()
                return None
            # recursion answers belong to another DC's store — no
            # cache layer may keep them (query.no_store reaches the
            # balancer as the do-not-store transport marker)
            query.no_store = True
            return self.recursion.resolve(query)
        query.set_error(plan.rcode)
        groups = plan.groups
        if plan.rotatable:
            groups = list(groups)
            self.rng.shuffle(groups)
        for answers, additionals in groups:
            for rec in answers:
                query.add_answer(rec)
            for rec in additionals:
                query.add_additional(rec)
        for rec in plan.authorities:
            query.add_authority(rec)
        query.stamp("pre-resp")
        query.respond()

    # -- reverse resolution (lib/server.js:67-134) --

    def resolve_ptr(self, query: QueryCtx):
        plan = self.plan_ptr(query.name())
        return self._finish(query, plan)

    def plan_ptr(self, qname: str) -> AnswerPlan:
        """Pure resolution of a PTR question against the reverse map."""
        p = AnswerPlan()
        parts = list(reversed(qname.split(".")))
        if len(parts) >= 2 and parts[0] == "arpa" and parts[1] == "ip6":
            # IPv6 reverse: strict canonical nibble parse — the reverse
            # map is keyed by the canonical address string, and a
            # malformed ip6.arpa name simply misses (REFUSED below)
            ip = ip_from_reverse_name(qname.lower())
            if ip is None:
                p.reason = "not a valid ip6 reverse name"
                p.rcode = Rcode.REFUSED
                return p
        elif (len(parts) < 2 or parts[0] != "arpa"
                or parts[1] != "in-addr"):
            p.reason = "not an ipv4 reverse name"
            p.rcode = Rcode.REFUSED
            return p
        else:
            # No octet validation: an invalid address simply misses the
            # cache and is REFUSED, so the client tries its next NS
            # (comment at lib/server.js:79-83)
            ip = ".".join(parts[2:])

        if not self.cache.is_ready():
            self.log.error("no coordination-store session")
            p.rcode = Rcode.SERVFAIL
            return p

        p.log_query = {"ip": ip, "type": Type.name(Type.PTR)}

        # degradation gate, same policy as the forward tree
        mode = self._policy_mode()
        if mode == "stale-exhausted":
            return self._withhold(p, qname.lower())

        # dependency tag: mutations touching this address emit the
        # normalized reverse qname (store/cache.py _rev_name)
        p.dep_domain = qname.lower()
        node = self.cache.reverse_lookup(ip)
        if node is None:
            p.miss = True
            p.rcode = Rcode.REFUSED
            return p

        rec = node.rec
        if type(rec) is tuple:
            _rt, _addr, rttl, rsttl = _rec_parts(rec)
            ttl = rsttl if rsttl is not None else (
                rttl if rttl is not None else DEFAULT_TTL)
        else:
            record = rec if isinstance(rec, dict) else {}
            rtype = record.get("type")
            sub = record.get(rtype) if isinstance(rtype, str) else None
            ttl = _record_ttl(record, sub if isinstance(sub, dict) else {})
        p.groups.append(([PTRRecord(name=qname, ttl=ttl,
                                    target=node.domain)], []))
        return self._apply_stale(p, mode == "stale-serving")
