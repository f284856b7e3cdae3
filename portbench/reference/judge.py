"""The verdict on one reply: right, or why not."""
from __future__ import annotations

import json

from portbench.reference import dnswire
from portbench.reference.answers import ZoneReference


def verdict(data: bytes, qid, qname: str, qtype: int, choices) -> str:
    """Empty when ``data`` is a right reply to query ``qid`` (None: an
    id the caller has matched already) for ``qname``/``qtype``, one of
    ``choices`` (each an ``Expected``); else the reason."""
    try:
        r = dnswire.Reply(data)
    except (dnswire.WireError, UnicodeDecodeError, ValueError) as e:
        return f"malformed: {e}"
    if (qid is not None and r.qid != qid) or not r.qr or r.opcode != 0:
        return f"header: id {r.qid} qr {r.qr} opcode {r.opcode}"
    if r.tc:
        return "TC=1"
    if r.qname != qname.lower() or r.qtype != qtype:
        return f"question {r.qname} {r.qtype}"
    answers = frozenset(r.answers)
    additionals = frozenset(r.additionals)
    why = ""
    for want in choices:
        if r.rcode != want.rcode:
            why = f"rcode {r.rcode}, expected {want.rcode}"
        elif len(answers) != len(r.answers) or answers != want.answers:
            why = f"answers {sorted(map(str, r.answers))[:4]}"
        elif (len(additionals) != len(r.additionals)
              or additionals != want.additionals):
            why = f"additionals {sorted(map(str, r.additionals))[:4]}"
        elif r.authorities:
            why = f"authorities {len(r.authorities)}"
        else:
            return ""
    return why


class Judge:
    """Judges the replies of one run against the zone and the churn
    writes the stand-in acknowledged; ``fresh_limit`` is the freshness
    guarantee in seconds."""

    def __init__(self, ref: ZoneReference, churn_logs, fresh_limit: float):
        self.ref = ref
        self.churn = churn_logs
        self.fresh_limit = fresh_limit
        self._static = {}

    def choices(self, qname: str, qtype: int, t_sent: float,
                t_reply: float):
        log = self.churn.get(qname.lower()) if qtype == dnswire.A else None
        if log is None:
            key = (qname, qtype)
            got = self._static.get(key)
            if got is None:
                got = self._static[key] = [self.ref.expect(qname, qtype)]
            return got
        return [self.ref.expect(qname, qtype, {qname.lower(): _record(v)})
                for v in log.allowed(t_sent, t_reply, self.fresh_limit)]

    def __call__(self, data: bytes, qid, qname: str, qtype: int,
                 t_sent: float, t_reply: float) -> str:
        return verdict(data, qid, qname, qtype,
                       self.choices(qname, qtype, t_sent, t_reply))


def _record(data: bytes) -> dict:
    return json.loads(data)

