"""The one traffic generator: a mix file's parameters and the run's seed
in, the client's query templates, schedule and source addresses out.

A mix (``portbench/mixes/<name>.json``) holds:

- ``loop``: ``open`` (queries due at fixed times, whatever the server
  does) or ``closed`` (``inflight`` queries outstanding at all times);
- ``rate_qps`` (open loop): the offered rate;
- ``inflight`` (closed loop), ``client_procs``;
- ``sources``: how many client addresses, one per /24 of 127/8 from
  127.1.0.1 on, each its own socket;
- ``queries``: the kinds of question and their shares, ``names``: how
  names are drawn within a kind (``uniform`` or ``{"zipf": s}``);
- ``check_sample``: how many of the window's replies the reference
  judges, drawn from the seed;
- ``retry_s``, ``grace_s``, ``warmup_s``;
- ``churn``: the registrar's writes and the freshness probe.

Every seed gives the same number of queries of each kind and the same
number of arrivals in the window, in another order and at other times,
so that seeds change the data and not the work.
"""
from __future__ import annotations

import struct

import numpy as np

from portbench.harness import zone as zonemod
from portbench.reference import dnswire

ENTRY_DTYPE = np.dtype([("due", "<f8"), ("tmpl", "<u4"), ("source", "<u4"),
                        ("flags", "<u4")])

#: the question kinds a mix may name, each with how many templates it has
KINDS = ("host_a", "ptr", "service_a", "service_srv", "unknown")

#: a closed loop cycles through a schedule of this many queries
CLOSED_ENTRIES = 1 << 20

#: substreams of the seed (the zone draws from the seed itself)
STREAM_WINDOW, STREAM_WARMUP = 1, 2


def source_addr(k: int) -> str:
    """Client address ``k``: the first host of its own /24 of 127/8."""
    if not 0 <= k < 254 * 256:
        raise ValueError("too many client sources")
    return f"127.{1 + (k >> 8)}.{k & 255}.1"


class Templates:
    """The query wires of a mix over one zone: ``wires[t]`` for template
    ``t``, ``question[t]`` its ``(qname, qtype)``; each kind has the
    block ``blocks[kind] = (first, count)``."""

    def __init__(self, mix: dict, zone: zonemod.Zone):
        self.question = []
        self.blocks = {}
        for q in mix["queries"]:
            kind = q["kind"]
            if kind not in KINDS:
                raise ValueError(f"unknown query kind {kind!r}")
            first = len(self.question)
            if kind == "host_a":
                self.question += [(zone.host_name(i), dnswire.A)
                                  for i in range(zone.hosts)]
            elif kind == "ptr":
                self.question += [(dnswire.reverse_name(zone.addr[i]),
                                   dnswire.PTR) for i in range(zone.hosts)]
            elif kind == "service_a":
                self.question.append((f"{q['name']}.{zone.domain}",
                                      dnswire.A))
            elif kind == "service_srv":
                self.question.append((f"{q['name']}.{zone.domain}",
                                      dnswire.SRV))
            else:
                self.question += [(f"u{i:06d}.unknown.{zone.domain}",
                                   dnswire.A) for i in range(q["count"])]
            self.blocks[kind] = (first, len(self.question) - first)
        self.wires = [dnswire.encode_query(n, t) for n, t in self.question]

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            for w in self.wires:
                f.write(struct.pack(">H", len(w)) + w)


def _names(rng, spec, count: int, n: int):
    """``n`` indices into a block of ``count`` names."""
    if spec == "uniform" or count == 1:
        return rng.integers(0, count, n)
    s = float(spec["zipf"])
    p = 1.0 / np.arange(1, count + 1) ** s
    ranked = rng.permutation(count)     # which name has which rank
    return ranked[rng.choice(count, n, p=p / p.sum())]


def schedule(mix: dict, templates: Templates, seed: int, seconds: float,
             stream: int = STREAM_WINDOW):
    """The client's schedule for a window of ``seconds``: one entry a
    query.  An open loop gets exactly ``rate_qps * seconds`` arrivals,
    uniform over the window (a Poisson process given its count); a
    closed loop :data:`CLOSED_ENTRIES` entries that it cycles through.
    Every reply is kept: the judge draws its sample after the window."""
    rng = np.random.default_rng([seed, stream])
    if mix["loop"] == "open":
        n = int(round(mix["rate_qps"] * seconds))
        due = np.sort(rng.random(n) * seconds)
    else:
        n = CLOSED_ENTRIES
        due = np.zeros(n)
    shares = np.array([q["share"] for q in mix["queries"]], np.float64)
    counts = np.floor(shares / shares.sum() * n).astype(np.int64)
    counts[0] += n - counts.sum()
    tmpl = np.empty(n, np.uint32)
    at = 0
    for q, c in zip(mix["queries"], counts):
        first, size = templates.blocks[q["kind"]]
        tmpl[at:at + c] = first + _names(rng, mix.get("names", "uniform"),
                                         size, int(c))
        at += c
    out = np.zeros(n, ENTRY_DTYPE)
    out["due"] = due
    out["tmpl"] = rng.permutation(tmpl)
    sources = int(mix["sources"])
    if sources % int(mix["client_procs"]):
        raise ValueError("sources must divide among the client processes")
    out["source"] = np.arange(n) % sources
    out["flags"] = 1
    return out
