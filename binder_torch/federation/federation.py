"""The serving-plane half of multi-DC federation.

Foreign names already route through the recursion layer (qname's DC
label -> that DC's binders, ``lib/recursion.js:287-354``); federation
supplies the routing table from the watched ``/dcs`` registry and adds
the two things the reference never had:

- a **per-query upstream-work budget** (NXNSAttack, arXiv:2005.09107:
  unbounded cross-resolver fan-out is an amplification vector — a
  single PTR query must not be allowed to touch every binder of every
  DC at once), and
- a **foreign-answer cache with stale-serve** (Resolver-Less DNS,
  arXiv:1908.04574: a previously delivered answer beats a timeout):
  every successful forward deposits the validated upstream wire; when
  the owning DC goes dark (transport-level failure, not a negative
  answer), the cached answer is re-served with its TTL clamped, up to a
  staleness cap — past the cap the query is *withheld* with a
  well-formed denial, mirroring the local degradation policy
  (binder_torch/policy/degrade.py).  A dark DC never turns into a
  client-visible timeout.

Dark vs alive is decided per-forward: any DNS response (even REFUSED or
NXDOMAIN) proves the peer alive and passes through; only transport
failure (timeout, socket death, all breakers open) reaches the stale
path.  Foreign negative answers therefore stay ordinary negative
answers — see ``UpstreamError.got_response``.
"""
from __future__ import annotations

import asyncio
import logging
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from binder_torch.dns.wire import Message, Rcode, WireError
from binder_torch.federation.registry import DcRegistry
from binder_torch.recursion.recursion import ResolverSource

#: federation config defaults (config key ``federation``)
DEFAULTS = {
    "maxStalenessSeconds": 300.0,   # foreign stale-serve cap
    "staleTtlClampSeconds": 30,     # TTL on stale-served answers
    "exhaustedAction": "servfail",  # or "refused": past-cap denial shape
    "upstreamBudget": 8,            # per-query upstream-work ceiling
    "cacheSize": 4096,              # foreign-answer cache entries
}


class _ForeignCache:
    """Bounded LRU of validated upstream answer wire, keyed
    (qname, qtype).  Values are the raw bytes as received — decoding is
    deferred to the rare dark-serve path; the hot path only appends."""

    def __init__(self, max_entries: int) -> None:
        self.max_entries = max(16, int(max_entries))
        self._d: "OrderedDict[Tuple[str, int], Tuple[bytes, float, str]]" \
            = OrderedDict()

    def put(self, key: Tuple[str, int], wire: bytes, dc: str) -> None:
        d = self._d
        if key in d:
            del d[key]
        elif len(d) >= self.max_entries:
            d.popitem(last=False)
        d[key] = (wire, time.monotonic(), dc)

    def get(self, key: Tuple[str, int]
            ) -> Optional[Tuple[bytes, float, str]]:
        ent = self._d.get(key)
        if ent is not None:
            self._d.move_to_end(key)
        return ent

    def __len__(self) -> int:
        return len(self._d)


class _RegistrySource(ResolverSource):
    """Feeds the recursion routing table from the DC registry — the
    whole breaker/hedge/splice machinery is reused unchanged."""

    def __init__(self, federation: "Federation") -> None:
        self._fed = federation

    async def list_resolvers(self, region_name: str) -> List[Dict[str, str]]:
        return [{"datacenter": zone, "ip": peer}
                for zone, peers in
                self._fed.registry.foreign_zone_map().items()
                for peer in peers]


class Federation:
    """One binder cluster's view of the federated namespace."""

    def __init__(self, *, store, dns_domain: str, datacenter_name: str,
                 config: Optional[dict] = None, collector=None,
                 recorder=None, log: Optional[logging.Logger] = None
                 ) -> None:
        cfg = dict(DEFAULTS)
        cfg.update(config or {})
        self.log = log or logging.getLogger("binder.federation")
        self.recorder = recorder
        self.dns_domain = dns_domain.lower()
        self.datacenter_name = datacenter_name
        self.max_staleness = float(cfg["maxStalenessSeconds"])
        self.ttl_clamp = int(cfg["staleTtlClampSeconds"])
        self.exhausted_action = str(cfg["exhaustedAction"]).lower()
        self.upstream_budget = (None if cfg["upstreamBudget"] in
                                (None, 0, "0") else int(cfg["upstreamBudget"]))
        self.cache = _ForeignCache(int(cfg["cacheSize"]))
        self.registry = DcRegistry(
            store, self_name=datacenter_name,
            path=str(cfg.get("dcsPath", "/dcs")),
            static_records=cfg.get("dcs"),
            log=self.log, recorder=recorder)
        self.registry.on_change(self._membership_changed)
        self.recursion = None
        #: dc name -> {"dark", "since", "first_fail", "stale_served"}
        self._health: Dict[str, dict] = {}
        #: most recent failover convergence: first failed forward to a
        #: newly-dark DC -> first stale-served answer for it (seconds)
        self.last_convergence_s: Optional[float] = None
        self.forwards = 0
        self._register_metrics(collector)

    def _register_metrics(self, collector) -> None:
        if collector is None:
            class _Nop:
                def inc(self, by=1.0):
                    pass
            nop = _Nop()
            self._m_forward_family = None
            self.m_forwards_all = nop
            self.m_hits = self.m_stale = self.m_withheld = nop
            self.m_budget = self.m_failovers = nop
            self._m_forward_children = {}
            return
        collector.gauge(
            "binder_federation_dcs",
            "datacenters currently in the /dcs registry"
        ).set_function(lambda: float(len(self.registry.records)))
        collector.gauge(
            "binder_federation_convergence_seconds",
            "latest failover convergence: first failed forward to a "
            "newly-dark DC until its first stale-served answer"
        ).set_function(lambda: float(self.last_convergence_s or 0.0))
        fam = collector.counter(
            "binder_federation_forwards_total",
            "cross-DC forwards dispatched, by destination datacenter")
        self._m_forward_family = fam
        # "(all)" pins the family (and the dc label) from scrape 1
        self.m_forwards_all = fam.labelled({"dc": "(all)"})
        self.m_forwards_all.inc(0)
        self._m_forward_children: Dict[str, object] = {}
        # .labelled() children: the Counter family object itself has no
        # inc(); the no-label child is the one-series-per-process handle
        self.m_hits = collector.counter(
            "binder_federation_foreign_hits_total",
            "dark-DC queries answered from the foreign-answer cache "
            "(stale-served or withheld)").labelled()
        self.m_stale = collector.counter(
            "binder_federation_foreign_stale_served_total",
            "foreign answers served stale (TTL-clamped) for a dark DC"
        ).labelled()
        self.m_withheld = collector.counter(
            "binder_federation_foreign_withheld_total",
            "foreign answers withheld past the staleness cap").labelled()
        self.m_budget = collector.counter(
            "binder_federation_budget_clamped_total",
            "queries whose upstream fan-out hit the per-query budget"
        ).labelled()
        self.m_failovers = collector.counter(
            "binder_federation_failovers_total",
            "DC dark transitions observed by the forwarding plane"
        ).labelled()
        for m in (self.m_hits, self.m_stale, self.m_withheld,
                  self.m_budget, self.m_failovers):
            m.inc(0)

    # -- lifecycle / wiring --

    def start(self) -> None:
        self.registry.start()

    def resolver_source(self) -> ResolverSource:
        return _RegistrySource(self)

    def attach(self, recursion) -> None:
        """Cross-wire with the recursion plane: it consults us on
        forward success/failure, we push membership changes into its
        routing table and set its upstream budget."""
        self.recursion = recursion
        recursion.federation = self
        if self.upstream_budget is not None:
            recursion.upstream_budget = self.upstream_budget

    def _membership_changed(self) -> None:
        rec = self.recursion
        if rec is None:
            return
        # re-pull the routing table NOW — convergence is watch-delivery
        # latency, not the 5-minute discovery poll
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return      # pre-loop setup: wait_ready()'s refresh covers it
        rec._spawn(rec.refresh())

    # -- forward-outcome feed (called by the recursion plane) --

    def _zone_of(self, domain: str) -> Optional[str]:
        if not domain.endswith(self.dns_domain):
            return None
        prefix = domain[:len(domain) - len(self.dns_domain) - 1]
        return prefix[prefix.rfind(".") + 1:]

    def _dc_for(self, domain: str) -> str:
        zone = self._zone_of(domain)
        if zone is None:
            return "(other)"
        return self.registry.zone_owner(zone) or zone

    def note_forward(self, domain: str) -> None:
        """A cross-DC forward is being dispatched."""
        self.forwards += 1
        self.m_forwards_all.inc()
        if self._m_forward_family is not None:
            dc = self._dc_for(domain)
            child = self._m_forward_children.get(dc)
            if child is None:
                if len(self._m_forward_children) < 64:   # label cardinality
                    child = self._m_forward_family.labelled({"dc": dc})
                    self._m_forward_children[dc] = child
                else:
                    child = self.m_forwards_all
            child.inc()

    def note_success(self, domain: str, qtype: int,
                     raw_up: Optional[bytes]) -> None:
        """A forward got a DNS response (any rcode): the DC is alive;
        deposit positive answers in the foreign cache."""
        dc = self._dc_for(domain)
        h = self._health.get(dc)
        if h is not None:
            if h["dark"]:
                h.update(dark=False, since=time.monotonic(),
                         stale_served=False)
                self._event("dc-recovered", dc=dc)
            h["first_fail"] = None
        if (raw_up is not None and len(raw_up) >= 12
                and ((raw_up[6] << 8) | raw_up[7]) > 0
                and (raw_up[3] & 0x0F) == Rcode.NOERROR):
            self.cache.put((domain, qtype), bytes(raw_up), dc)

    def _note_failure(self, domain: str) -> str:
        dc = self._dc_for(domain)
        now = time.monotonic()
        h = self._health.setdefault(
            dc, {"dark": False, "since": now, "first_fail": None,
                 "stale_served": False})
        if h["first_fail"] is None:
            h["first_fail"] = now
        if not h["dark"]:
            h.update(dark=True, since=now, stale_served=False)
            self.m_failovers.inc()
            self._event("dc-dark", dc=dc)
            self.log.warning("federation: datacenter %s is dark "
                             "(transport-level forward failure); foreign "
                             "answers served stale up to %.0fs", dc,
                             self.max_staleness)
        return dc

    def serve_dark(self, query, domain: str) -> bool:
        """A forward failed at transport level (no DNS response at
        all).  Serve the cached foreign answer per the degradation
        policy, or withhold; returns False when there is nothing cached
        — the ordinary REFUSED path then owns the query.  Never leaves
        the client waiting."""
        dc = self._note_failure(domain)
        ent = self.cache.get((domain, query.qtype()))
        if ent is None:
            return False
        self.m_hits.inc()
        wire, stored, _dc = ent
        age = time.monotonic() - stored
        if age <= self.max_staleness:
            try:
                answers = Message.decode(wire).answers
            except WireError:
                return False
            rebuild = (self.recursion._rebuild if self.recursion is not None
                       else lambda _d, _r: None)
            served = False
            for rec in answers:
                rebuilt = rebuild(domain, rec)
                if rebuilt is not None:
                    rebuilt.ttl = min(rebuilt.ttl, self.ttl_clamp)
                    query.add_answer(rebuilt)
                    served = True
            if not served:
                return False
            self.m_stale.inc()
            query.log_ctx["federation"] = "stale"
            h = self._health.get(dc)
            if h is not None and h["dark"] and not h["stale_served"]:
                h["stale_served"] = True
                first = h["first_fail"] or h["since"]
                self.last_convergence_s = time.monotonic() - first
                self._event("federation-failover", dc=dc,
                            convergence_ms=round(
                                self.last_convergence_s * 1000.0, 1))
            query.stamp("foreign-stale")
            query.respond()
            return True
        # past the staleness cap: withheld — a well-formed denial,
        # never a timeout (same posture as the local policy's
        # stale-exhausted state)
        self.m_withheld.inc()
        query.log_ctx["federation"] = "withheld"
        query.set_error(Rcode.REFUSED if self.exhausted_action == "refused"
                        else Rcode.SERVFAIL)
        query.stamp("foreign-withheld")
        query.respond()
        return True

    # -- observability --

    def _event(self, kind: str, **fields) -> None:
        if self.recorder is not None:
            try:
                self.recorder.record(kind, **fields)
            except Exception:  # noqa: BLE001 — observability never fatal
                pass

    def dark_dcs(self) -> List[str]:
        return sorted(dc for dc, h in self._health.items() if h["dark"])

    def introspect(self) -> dict:
        now = time.monotonic()
        health = {}
        for dc, h in sorted(self._health.items()):
            health[dc] = {
                "dark": h["dark"],
                "age_seconds": now - h["since"],
                "stale_served_since_dark": h["stale_served"],
            }
        return {
            "datacenter": self.datacenter_name,
            "registry": self.registry.introspect(),
            "zone_map": self.registry.foreign_zone_map(),
            "health": health,
            "dark": self.dark_dcs(),
            "forwards": self.forwards,
            "foreign_cache": {
                "entries": len(self.cache),
                "max_entries": self.cache.max_entries,
            },
            "policy": {
                "max_staleness_seconds": self.max_staleness,
                "stale_ttl_clamp_seconds": self.ttl_clamp,
                "exhausted_action": self.exhausted_action,
                "upstream_budget": self.upstream_budget,
            },
            "last_convergence_seconds": self.last_convergence_s,
        }
