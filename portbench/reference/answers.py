"""binder's answer semantics over a zone, worked out from the zone alone.

The plain reference of every cell.  It is given the znodes the benchmark
generated (``[(path, data)]``, as the ZooKeeper stand-in loads them) and
the log of the churn writes the stand-in acknowledged, and says which
replies are right.  The rules are those of the upstream binder
(``lib/server.js``), written out again from its description:

- a name is the reversed znode path under the DNS domain; a name the
  zone lacks, or outside the domain, is REFUSED;
- a host-like record (one holding ``address``) answers A with its
  address; TTL 30 unless the record or its sub-record sets ``ttl``
  (the deeper one wins);
- a service answers A with the address of every member (a child of
  type load_balancer, moray_host, ops_host, rr_host or redis_host), at
  the smaller of the service's and the member's TTL, in any order;
- ``_srvce._proto.<service>`` SRV answers one record per member
  (priority 0, weight 10, the service's port, the member's name as
  target) with the member's A as additional; a service or protocol
  other than the registered one is NXDOMAIN;
- PTR of a host-like record's address answers its name.
"""
from __future__ import annotations

import bisect
import json

from portbench.reference import dnswire

DEFAULT_TTL = 30
SERVICE_CHILD_TYPES = frozenset({
    "load_balancer", "moray_host", "ops_host", "rr_host", "redis_host"})


def _ttl(record: dict, sub: dict, default: int = DEFAULT_TTL) -> int:
    ttl = default
    if record.get("ttl") is not None:
        ttl = record["ttl"]
    if isinstance(sub, dict) and sub.get("ttl") is not None:
        ttl = sub["ttl"]
    return ttl


class Expected:
    """One right reply, up to record order: ``rcode``, and the answers
    and additionals as sets of ``(name, type, ttl, value)``."""

    __slots__ = ("rcode", "answers", "additionals")

    def __init__(self, rcode, answers=(), additionals=()):
        self.rcode = rcode
        self.answers = frozenset(answers)
        self.additionals = frozenset(additionals)


class ZoneReference:
    """The zone's answers.  ``churn`` maps each churned name to its
    :class:`ChurnLog`; a reply for such a name is judged against what
    the store held around the query's time."""

    def __init__(self, domain: str, nodes):
        self.domain = domain.lower()
        self.records = {}
        self.children = {}
        root = "/" + "/".join(reversed(self.domain.split(".")))
        for path, data in nodes:
            if not path.startswith(root + "/"):
                continue
            name = ".".join(reversed(path[1:].split("/")))
            parent = ".".join(reversed(path[1:].split("/")[:-1]))
            self.children.setdefault(parent, []).append(name)
            if data[:1] == b"{":
                self.records[name] = json.loads(data)
        self.reverse = {}
        for name, rec in self.records.items():
            addr = self._address(rec)
            if addr is not None:
                self.reverse[addr] = name

    @staticmethod
    def _address(rec: dict):
        sub = rec.get(rec.get("type"))
        return sub.get("address") if isinstance(sub, dict) else None

    def in_domain(self, name: str) -> bool:
        return name.endswith("." + self.domain)

    def expect(self, qname: str, qtype: int, records=None) -> Expected:
        """The right reply to ``qname``/``qtype``; ``records`` overrides
        the zone's record of some names (a churned name's value)."""
        qname = qname.lower()
        recs = self.records if records is None else _Overlay(
            self.records, records)
        if qtype == dnswire.PTR:
            name = self.reverse.get(_ptr_addr(qname))
            if name is None:
                return Expected(dnswire.REFUSED)
            rec = recs[name]
            return Expected(dnswire.NOERROR, [
                (qname, dnswire.PTR, _ttl(rec, rec.get(rec["type"])),
                 name)])
        service = protocol = None
        domain = qname
        if qtype == dnswire.SRV:
            parts = qname.split(".", 2)
            if len(parts) < 3 or not parts[0].startswith("_") \
                    or not parts[1].startswith("_"):
                return Expected(dnswire.REFUSED)
            service, protocol, domain = parts
        if not self.in_domain(domain) or domain not in recs:
            return Expected(dnswire.REFUSED)
        rec = recs[domain]
        sub = rec.get(rec["type"])
        ttl = _ttl(rec, sub)
        if rec["type"] != "service":
            if service is not None:
                raise ValueError("SRV of a host: not in any mix")
            return Expected(dnswire.NOERROR, [
                (domain, dnswire.A, ttl, self._address(rec))])
        s = sub["service"] if isinstance(sub.get("service"), dict) else sub
        if s.get("ttl") is not None:
            ttl = s["ttl"]
        if service is not None and (service != s.get("srvce")
                                    or protocol != s.get("proto")):
            return Expected(dnswire.NXDOMAIN)
        answers, additionals = [], []
        for member in self.children.get(domain, ()):
            mrec = recs.get(member)
            if mrec is None or mrec.get("type") not in SERVICE_CHILD_TYPES:
                continue
            msub = mrec[mrec["type"]]
            addr = msub.get("address")
            if addr is None:
                continue
            mttl = _ttl(mrec, msub, ttl)
            if service is None:
                answers.append((domain, dnswire.A, min(ttl, mttl), addr))
                continue
            for port in msub.get("ports") or [s.get("port")]:
                answers.append((qname, dnswire.SRV, ttl,
                                (port, member, 0, 10)))
            additionals.append((member, dnswire.A, mttl, addr))
        return Expected(dnswire.NOERROR, answers, additionals)


class _Overlay(dict):
    """The zone's records with some names' records replaced."""

    def __init__(self, base, over):
        super().__init__()
        self.base, self.over = base, over

    def __contains__(self, name):
        return name in self.over or name in self.base

    def __getitem__(self, name):
        return self.over[name] if name in self.over else self.base[name]

    def get(self, name, default=None):
        return self[name] if name in self else default


def _ptr_addr(qname: str):
    parts = qname.split(".")
    if len(parts) != 6 or parts[-2:] != ["in-addr", "arpa"]:
        return None
    return ".".join(reversed(parts[:4]))


class ChurnLog:
    """The writes of one churned name: each ``(t_sent, t_ack, data)``
    on the monotonic clock, in order, after the first value."""

    def __init__(self, first: bytes):
        self.first = first
        self.sent, self.acked, self.data = [], [], []

    def add(self, t_sent: float, t_ack: float, data: bytes) -> None:
        self.sent.append(t_sent)
        self.acked.append(t_ack)
        self.data.append(data)

    def allowed(self, t_query: float, t_reply: float, fresh_limit: float):
        """The values a reply may carry: any value the name held from
        ``fresh_limit`` seconds before the query was sent (the
        freshness guarantee) to the reply's arrival (a write sent before
        it may already be served)."""
        # the newest write acknowledged before the freshness horizon
        lo = bisect.bisect_right(self.acked, t_query - fresh_limit) - 1
        # every write sent before the reply arrived
        hi = bisect.bisect_left(self.sent, t_reply)
        vals = [self.first] if lo < 0 else []
        vals += self.data[max(lo, 0):hi]
        return vals
