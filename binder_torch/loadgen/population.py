#!/usr/bin/env python3
"""Population-grade DNS traffic model (million-client realism).

The port's counterpart of ``tools/population.py``: the same cohorts,
samplers, pacing and report, on ``binder_torch.dns.wire``.

``hostile.py`` answers "does binder survive the open internet?"
with an *adversarial* mix — but its flows are still a few dozen
sockets, each one client.  Real authoritative traffic has a different
shape, and the RRL false-positive question is invisible without it:

- **Hundreds of thousands of distinct client identities.**  Identities
  are logical — what the server *sees* is the source address they
  query through, which is the whole point: behind a NAT'd resolver
  farm, thousands of real clients share a handful of addresses in a
  couple of /24s, so per-prefix RRL judges the farm, not the client.
  Client-side per-identity accounting (answered / refused / timeout,
  keyed by qid attribution) is what makes the collateral damage — the
  RRL false-positive rate — a measured number instead of a guess.
- **Zipf-distributed popularity.**  Both the name a query asks for and
  the identity that asks are drawn from Zipf(s) samplers: a few names
  take most of the load, a few heavy clients dominate each farm, and
  the long tail sends one query each — the distribution every cache
  and every rate limiter actually faces.
- **Realistic qtype/EDNS mixes** (A-heavy with AAAA/SRV/TXT/PTR,
  EDNS payload sizes from none to 4096) and answer-TTL observation.
- **Ramped offered load**: qps climbs linearly from a floor to a peak
  over the run, so the report shows *where* degradation starts, not
  just whether it happened at one arbitrary rate.
- **TCP retry on slip/timeout.**  A real client whose UDP query is
  dropped or answered TC=1 retries over TCP from the same source
  address.  That retry is exactly the liveness proof RRL v2's adaptive
  buckets feed on (``note_tcp``): run the same population against
  adaptive and static configs and the false-positive delta is the
  measured value of the mechanism.
- **Spoofed overlay** (optional): a concurrent spoofed-source flood
  from the SAME hostile prefixes ``hostile.py`` uses, so the
  report shows RRL clamping abuse while the NAT'd farms earn their
  way out.

Synchronous selectors loop (the hostile.py discipline): the model is
the measurement instrument.  Exported JSON carries the population
shape (identities, prefixes, zipf_s, nat_fan_in) so a bench axis or a
smoke can assert against a *described* population, not a folklore one.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import random
import selectors
import socket
import struct
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from binder_torch.dns.wire import make_query
from binder_torch.loadgen import SourceBindError, bind_source
from binder_torch.loadgen.hostile import (HOSTILE_PREFIXES, QTYPE_MIX,
                                          _classify)

#: NAT'd resolver-farm /24s: few prefixes, high aggregate qps — the
#: cohort per-prefix RRL is most likely to false-positive on
FARM_PREFIXES = ("127.77.1", "127.77.2")

#: eyeball cohort /24s: one identity per source address, spread wide
DIRECT_PREFIXES = tuple(f"127.10.{i}" for i in range(16))

#: EDNS posture mix (payload size or None = no OPT; weights)
EDNS_MIX = ((None, 20), (512, 5), (1232, 60), (4096, 15))

DEFAULT_IDENTITIES = 200_000
DEFAULT_ZIPF_S = 1.1


class ZipfSampler:
    """Draw ranks 1..n with P(k) proportional to 1/k^s (precomputed CDF,
    O(log n) per sample)."""

    def __init__(self, n: int, s: float) -> None:
        self.n = max(1, int(n))
        self.s = float(s)
        cdf: List[float] = []
        acc = 0.0
        for k in range(1, self.n + 1):
            acc += k ** -self.s
            cdf.append(acc)
        self._cdf = cdf
        self._total = acc

    def sample(self, rng: random.Random) -> int:
        """0-based rank (0 = most popular)."""
        return bisect.bisect_left(self._cdf, rng.random() * self._total)


class Identity:
    """One logical client: the accounting unit for the FP question."""

    __slots__ = ("sent", "answered", "refused", "slipped", "timeouts",
                 "tcp_retries", "tcp_ok")

    def __init__(self) -> None:
        self.sent = 0
        self.answered = 0
        self.refused = 0
        self.slipped = 0
        self.timeouts = 0
        self.tcp_retries = 0
        self.tcp_ok = 0


class Endpoint:
    """One UDP source address (socket): what the server sees.  Farm
    endpoints carry many identities; direct endpoints exactly one."""

    __slots__ = ("sock", "src_ip", "cohort", "pending", "next_qid")

    def __init__(self, server: Tuple[str, int], src_ip: str,
                 cohort: str) -> None:
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setblocking(False)
        bind_source(self.sock, src_ip)
        self.sock.connect(server)
        self.src_ip = src_ip
        self.cohort = cohort
        #: qid -> (identity_index, name, qtype) awaiting attribution
        self.pending: Dict[int, Tuple[int, str, int]] = {}
        self.next_qid = 1

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class _TcpRetry:
    """One in-flight TCP retry from the identity's own source address
    (non-blocking connect -> length-framed query -> reply)."""

    __slots__ = ("sock", "ident", "wire", "rbuf", "deadline", "state")

    def __init__(self, server: Tuple[str, int], src_ip: str,
                 wire: bytes, ident: int, timeout: float) -> None:
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setblocking(False)
        # the retry must come from the identity's own address: it is
        # the evidence RRL credits to that address's prefix
        bind_source(self.sock, src_ip)
        try:
            self.sock.connect(server)
        except BlockingIOError:
            pass
        self.ident = ident
        self.wire = struct.pack(">H", len(wire)) + wire
        self.rbuf = bytearray()
        self.deadline = time.monotonic() + timeout
        self.state = "connecting"

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def run_population(host: str, port: int, *,
                   duration: float = 10.0,
                   names: Optional[Sequence[str]] = None,
                   domain: str = "foo.com",
                   identities: int = DEFAULT_IDENTITIES,
                   farms: int = 4,
                   ips_per_farm: int = 8,
                   direct_clients: int = 48,
                   zipf_s: float = DEFAULT_ZIPF_S,
                   qps_floor: int = 300,
                   qps_peak: int = 2000,
                   spoof_share: float = 0.2,
                   reply_timeout: float = 1.0,
                   tcp_parallel: int = 16,
                   seed: int = 7) -> Dict[str, object]:
    """Drive the population model for *duration* seconds; returns the
    accounting report (see module docstring for the shape's meaning).

    ``identities`` is the NAT'd-farm population size (logical clients
    split evenly across ``farms``); ``direct_clients`` eyeballs each
    get their own source address on top.  Offered load ramps linearly
    ``qps_floor`` -> ``qps_peak``; ``spoof_share`` of sends (0..1) is
    a concurrent spoofed flood from the hostile prefixes, outside the
    legit accounting."""
    rng = random.Random(seed)
    names = list(names or [f"w{i}.{domain}" for i in range(8)])
    server = (host, port)

    # -- population layout --
    farms = max(1, int(farms))
    per_farm = max(1, int(identities) // farms)
    idents: List[Identity] = [Identity() for _ in range(per_farm * farms
                                                       + direct_clients)]
    name_zipf = ZipfSampler(len(names), zipf_s)
    ident_zipf = ZipfSampler(per_farm, zipf_s)

    endpoints: List[Endpoint] = []

    def endpoint(src_ip: str, cohort: str) -> Endpoint:
        try:
            ep = Endpoint(server, src_ip, cohort)
        except OSError:
            for other in endpoints:
                other.close()
            raise
        endpoints.append(ep)
        return ep

    #: farm f -> its endpoints (identities behind the NAT share these)
    farm_eps: List[List[Endpoint]] = []
    for f in range(farms):
        eps = []
        for j in range(ips_per_farm):
            pfx = FARM_PREFIXES[(f * ips_per_farm + j)
                                % len(FARM_PREFIXES)]
            eps.append(endpoint(
                f"{pfx}.{(f * ips_per_farm + j) % 253 + 2}", "farm"))
        farm_eps.append(eps)
    direct_eps: List[Endpoint] = []
    for i in range(direct_clients):
        pfx = DIRECT_PREFIXES[i % len(DIRECT_PREFIXES)]
        direct_eps.append(endpoint(
            f"{pfx}.{i // len(DIRECT_PREFIXES) + 2}", "direct"))
    spoof_eps: List[Endpoint] = []
    if spoof_share > 0:
        for i, pfx in enumerate(HOSTILE_PREFIXES):
            spoof_eps.append(endpoint(f"{pfx}.{i + 2}", "spoof"))

    sel = selectors.DefaultSelector()
    for ep in endpoints:
        sel.register(ep.sock, selectors.EVENT_READ, ep)

    cohorts = {c: {"sent": 0, "answered": 0, "refused": 0, "slipped": 0,
                   "timeouts": 0, "tcp_retries": 0, "tcp_ok": 0}
               for c in ("farm", "direct", "spoof")}
    ttl_seen: List[int] = [0, 0, 0]        # count, sum, max
    #: FIFO of (deadline, endpoint, qid) — reply_timeout is constant so
    #: append order IS deadline order
    expiry: collections.deque = collections.deque()
    tcp_live: List[_TcpRetry] = []
    tcp_queue: collections.deque = collections.deque()

    def account_reply(ep: Endpoint, reply: bytes) -> None:
        if len(reply) < 2:
            return
        qid = (reply[0] << 8) | reply[1]
        entry = ep.pending.pop(qid, None)
        if entry is None:
            return          # late reply past its timeout, or spoof echo
        ident_i, name, qtype = entry
        ident = idents[ident_i]
        row = cohorts[ep.cohort]
        verdict = _classify(reply)
        if verdict == "slipped":
            ident.slipped += 1
            row["slipped"] += 1
            _queue_tcp(ep.src_ip, name, qtype, ident_i)
        elif verdict == "refused":
            ident.refused += 1
            row["refused"] += 1
        else:
            ident.answered += 1
            row["answered"] += 1
            if len(reply) >= 12 and ((reply[6] << 8) | reply[7]):
                ttl = _first_ttl(reply)
                if ttl is not None:
                    ttl_seen[0] += 1
                    ttl_seen[1] += ttl
                    ttl_seen[2] = max(ttl_seen[2], ttl)

    def _queue_tcp(src_ip: str, name: str, qtype: int,
                   ident_i: int) -> None:
        ident = idents[ident_i]
        ident.tcp_retries += 1
        ep_cohort = "farm" if src_ip.rsplit(".", 1)[0] in FARM_PREFIXES \
            else "direct"
        cohorts[ep_cohort]["tcp_retries"] += 1
        wire = make_query(name, qtype, qid=(ident_i % 65535) + 1).encode()
        tcp_queue.append((src_ip, wire, ident_i))

    def pump_tcp(now: float) -> None:
        while tcp_queue and len(tcp_live) < tcp_parallel:
            src_ip, wire, ident_i = tcp_queue.popleft()
            try:
                tr = _TcpRetry(server, src_ip, wire, ident_i,
                               reply_timeout * 2)
            except SourceBindError:
                raise
            except OSError:
                continue
            tcp_live.append(tr)
        for tr in list(tcp_live):
            if now > tr.deadline:
                tr.close()
                tcp_live.remove(tr)
                continue
            try:
                if tr.state == "connecting":
                    try:
                        tr.sock.send(tr.wire)
                        tr.state = "sent"
                    except (BlockingIOError, InterruptedError):
                        continue
                chunk = tr.sock.recv(4096)
                if chunk:
                    tr.rbuf.extend(chunk)
                if len(tr.rbuf) >= 2:
                    (ln,) = struct.unpack_from(">H", tr.rbuf)
                    if len(tr.rbuf) >= 2 + ln:
                        reply = bytes(tr.rbuf[2:2 + ln])
                        ident = idents[tr.ident]
                        if _classify(reply) == "answered":
                            ident.tcp_ok += 1
                            row = "farm" if tr.ident < per_farm * farms \
                                else "direct"
                            cohorts[row]["tcp_ok"] += 1
                        tr.close()
                        tcp_live.remove(tr)
                elif not chunk and tr.state == "sent":
                    tr.close()
                    tcp_live.remove(tr)
            except (BlockingIOError, InterruptedError):
                continue
            except OSError:
                tr.close()
                tcp_live.remove(tr)

    def drain(timeout: float) -> None:
        for key, _ in sel.select(timeout):
            ep: Endpoint = key.data
            for _ in range(64):
                try:
                    reply = ep.sock.recv(65535)
                except (BlockingIOError, InterruptedError, OSError):
                    break
                account_reply(ep, reply)

    def expire(now: float) -> None:
        while expiry and expiry[0][0] <= now:
            _, ep, qid = expiry.popleft()
            entry = ep.pending.pop(qid, None)
            if entry is None:
                continue
            ident_i, name, qtype = entry
            idents[ident_i].timeouts += 1
            cohorts[ep.cohort]["timeouts"] += 1
            if ep.cohort != "spoof":
                # a real client retries a dead query over TCP — the
                # liveness proof adaptive RRL feeds on
                _queue_tcp(ep.src_ip, name, qtype, ident_i)

    def build_and_send(now: float) -> None:
        r = rng.random()
        if spoof_eps and r < spoof_share:
            ep = rng.choice(spoof_eps)
            ident_i = len(idents) - 1          # spoof rides one bucket
            cohort = "spoof"
        elif r < spoof_share + 0.15 and direct_eps:
            ep = rng.choice(direct_eps)
            ident_i = per_farm * farms + direct_eps.index(ep)
            cohort = "direct"
        else:
            f = rng.randrange(farms)
            ident_i = f * per_farm + ident_zipf.sample(rng)
            ep = rng.choice(farm_eps[f])
            cohort = "farm"
        name = names[name_zipf.sample(rng)]
        qtype = rng.choices([t for t, _ in QTYPE_MIX],
                            weights=[w for _, w in QTYPE_MIX])[0]
        payload = rng.choices([p for p, _ in EDNS_MIX],
                              weights=[w for _, w in EDNS_MIX])[0]
        qid = ep.next_qid
        ep.next_qid = (ep.next_qid % 65535) + 1
        wire = make_query(name, qtype, qid=qid,
                          edns_payload=payload).encode()
        try:
            ep.sock.send(wire)
        except OSError:
            return
        if cohort != "spoof":
            idents[ident_i].sent += 1
            ep.pending[qid] = (ident_i, name, qtype)
            expiry.append((now + reply_timeout, ep, qid))
        cohorts[cohort]["sent"] += 1

    # -- the ramped load loop --
    t0 = time.monotonic()
    deadline = t0 + duration
    credit = 0.0
    last = t0
    while True:
        now = time.monotonic()
        if now >= deadline:
            break
        frac = (now - t0) / duration
        qps = qps_floor + (qps_peak - qps_floor) * frac
        credit = min(credit + (now - last) * qps, qps * 0.05 + 32)
        last = now
        sent_this_spin = 0
        while credit >= 1.0 and sent_this_spin < 64:
            build_and_send(now)
            credit -= 1.0
            sent_this_spin += 1
        expire(now)
        pump_tcp(now)
        drain(0.0 if credit >= 1.0 else min(1.0 / max(qps, 1.0),
                                            deadline - now))
    # grace: serve out stragglers and the TCP retry tail
    grace_end = time.monotonic() + max(reply_timeout, 0.5)
    while time.monotonic() < grace_end:
        now = time.monotonic()
        drain(0.05)
        expire(now)
        pump_tcp(now)
        if not tcp_live and not tcp_queue and not expiry:
            break
    elapsed = time.monotonic() - t0

    # -- per-identity outcome distribution + FP measurement --
    active = fully = degraded = starved = 0
    farm_lost = farm_sent = 0
    n_farm_idents = per_farm * farms
    for i, ident in enumerate(idents):
        if ident.sent == 0:
            continue
        active += 1
        lost = ident.timeouts + ident.slipped - ident.tcp_ok
        lost = max(0, lost)
        if lost == 0:
            fully += 1
        elif ident.answered + ident.tcp_ok > 0:
            degraded += 1
        else:
            starved += 1
        if i < n_farm_idents:
            farm_sent += ident.sent
            farm_lost += lost
    fp_rate = round(farm_lost / farm_sent, 4) if farm_sent else 0.0

    for ep in endpoints:
        sel.unregister(ep.sock)
        ep.close()
    sel.close()
    for tr in tcp_live:
        tr.close()

    farm_row = cohorts["farm"]
    goodput = (farm_row["answered"] + farm_row["tcp_ok"]) \
        / farm_row["sent"] if farm_row["sent"] else 0.0
    return {
        "population": {
            "identities": len(idents),
            "prefixes": len(set(ep.src_ip.rsplit(".", 1)[0]
                                for ep in endpoints)),
            "zipf_s": zipf_s,
            "nat_fan_in": per_farm // max(1, ips_per_farm),
        },
        "offered": {"qps_floor": qps_floor, "qps_peak": qps_peak,
                    "duration_s": round(elapsed, 3),
                    "spoof_share": spoof_share},
        "cohorts": cohorts,
        "identity_outcomes": {"active": active, "fully_answered": fully,
                              "degraded": degraded, "starved": starved},
        "farm_goodput_ratio": round(goodput, 4),
        "rrl_false_positive_rate": fp_rate,
        "ttl_observed": {"count": ttl_seen[0],
                         "mean": round(ttl_seen[1] / ttl_seen[0], 1)
                         if ttl_seen[0] else None,
                         "max": ttl_seen[2]},
    }


def _first_ttl(reply: bytes) -> Optional[int]:
    """TTL of the first answer RR (name-skip only; best-effort)."""
    try:
        off = 12
        while reply[off]:          # skip question name
            if reply[off] & 0xC0:
                off += 1
                break
            off += reply[off] + 1
        off += 1 + 4               # null + qtype/qclass
        while reply[off]:          # skip answer owner name
            if reply[off] & 0xC0:
                off += 1
                break
            off += reply[off] + 1
        off += 1 + 4               # null/pointer tail + type/class
        return int.from_bytes(reply[off:off + 4], "big")
    except IndexError:
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="population-grade DNS traffic model")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--identities", type=int, default=DEFAULT_IDENTITIES)
    ap.add_argument("--farms", type=int, default=4)
    ap.add_argument("--ips-per-farm", type=int, default=8)
    ap.add_argument("--direct", type=int, default=48)
    ap.add_argument("--zipf-s", type=float, default=DEFAULT_ZIPF_S)
    ap.add_argument("--qps-floor", type=int, default=300)
    ap.add_argument("--qps-peak", type=int, default=2000)
    ap.add_argument("--spoof-share", type=float, default=0.2)
    ap.add_argument("--domain", default="foo.com")
    ap.add_argument("--names", default=None,
                    help="comma-separated realistic name population")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    names = args.names.split(",") if args.names else None
    report = run_population(
        args.host, args.port, duration=args.duration, names=names,
        domain=args.domain, identities=args.identities, farms=args.farms,
        ips_per_farm=args.ips_per_farm, direct_clients=args.direct,
        zipf_s=args.zipf_s, qps_floor=args.qps_floor,
        qps_peak=args.qps_peak, spoof_share=args.spoof_share,
        seed=args.seed)
    json.dump(report, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
