"""Adversarial multi-flow DNS load harness (the ZDNS-style client).

The port's counterpart of ``tools/hostile.py``: the same categories,
mix, frames, flow layout and report, on ``binder_torch.dns.wire``.

A benchmark client such as ``dnsblast`` is a *friendly* client: one
source address, well-formed queries, qids it waits on.  This harness
is the unfriendly one:

- **Many distinct client flows.**  Every flow is its own UDP socket
  bound to its own loopback source address (Linux accepts any
  127.0.0.0/8 address unconfigured), so each carries a distinct
  4-tuple: ``SO_REUSEPORT`` shard hashing spreads them like real
  clients, and per-client/per-prefix token buckets are exercised
  honestly instead of seeing one mega-client.  A source the host
  will not bind raises :class:`~binder_torch.loadgen.SourceBindError`.
- **Configurable traffic mix** over six categories: realistic
  queries (``legit``), cache-missing random names (``random``), the
  malformed-frame corpus (``malformed``), EDNS edge cases (``edns``),
  oversized frames (``oversized``), and a spoofed-source flood
  (``spoof``) where flows sit in attacker prefixes distinct from the
  legit client's.
- **Per-category accounting**: answered / refused / formerr /
  slipped (TC=1, empty: the RRL slip) / dropped (no reply), so the
  server's shed-vs-refuse split is attributable from the client side
  and can be cross-checked against ``binder_shed_total`` /
  ``binder_rrl_*``.

The malformed corpus generator here reproduces the checked-in corpus
(``tests/data/malformed_corpus.bin``) byte for byte; ``python -m
binder_torch.loadgen.hostile --write-corpus <path>`` writes it.

Synchronous by design (selectors, not asyncio): the harness is the
measurement instrument, and per-packet event-loop overhead would cap
the flood it can represent.  Run the flood in its own process
(``python -m binder_torch.loadgen.hostile --port P ...``) next to a
``legit_probe`` measurement loop.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import selectors
import socket
import struct
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from binder_torch.dns.wire import Type, make_query
from binder_torch.loadgen import bind_source

CATEGORIES = ("legit", "random", "malformed", "edns", "oversized",
              "spoof")

#: default mix (fractions; normalized at parse time)
DEFAULT_MIX = {"legit": 0.25, "random": 0.20, "malformed": 0.15,
               "edns": 0.10, "oversized": 0.05, "spoof": 0.25}

#: realistic qtype distribution for the legit/spoof categories
QTYPE_MIX = ((Type.A, 70), (Type.AAAA, 15), (Type.SRV, 10),
             (Type.TXT, 3), (Type.PTR, 2))

#: loopback /24s the harness draws source addresses from.  The legit
#: measurement client lives at 127.0.0.1 (prefix 127.0.0/24); hostile
#: flows deliberately live elsewhere so per-prefix RRL isolates them.
HOSTILE_PREFIXES = ("127.66.7", "127.66.8", "127.99.1", "127.99.2")

CORPUS_DEFAULT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              os.pardir, os.pardir, "tests", "data",
                              "malformed_corpus.bin")


# ---------------------------------------------------------------------------
# Malformed-frame corpus (deterministic; the checked-in corpus is this)


def malformed_frames(seed: int = 1337) -> List[Tuple[str, bytes]]:
    """Deterministic (label, frame) corpus of malformed DNS wires.

    Every frame here must produce FORMERR-or-drop on every serve lane —
    never an exception, never a cache/precompile deposit.  Structured
    cases first (one per decoder failure mode), then seeded random fuzz
    for the failure modes nobody thought to enumerate."""
    out: List[Tuple[str, bytes]] = []
    hdr = struct.pack(">HHHHHH", 0x1234, 0x0100, 1, 0, 0, 0)

    def q(name_wire: bytes, tail: bytes = b"\x00\x01\x00\x01") -> bytes:
        return hdr + name_wire + tail

    out.append(("empty", b""))
    out.append(("one-byte", b"\x00"))
    out.append(("truncated-header", hdr[:11]))
    out.append(("header-only-but-counts", hdr))          # qd=1, no body
    out.append(("label-past-end", q(b"\x3fzz", tail=b"")))
    out.append(("name-unterminated", hdr + b"\x03foo"))
    out.append(("pointer-self", q(b"\xc0\x0c")))
    out.append(("pointer-forward", q(b"\xc0\x20")))
    out.append(("pointer-truncated", hdr + b"\xc0"))
    out.append(("reserved-label-type", q(b"\x40a\x00")))
    out.append(("label-type-0x80", q(b"\x80a\x00")))
    out.append(("question-truncated", hdr + b"\x01a\x00\x00\x01"))
    out.append(("trailing-bytes",
                q(b"\x01a\x03foo\x03com\x00") + b"JUNKJUNK"))
    # name assembled past 255 bytes via chained max labels
    out.append(("name-too-long", q((b"\x3f" + b"a" * 63) * 5 + b"\x00")))
    # an answer record whose rdlen runs past the end
    ans_hdr = struct.pack(">HHHHHH", 0x1234, 0x8100, 1, 1, 0, 0)
    out.append(("rdata-past-end",
                ans_hdr + b"\x01a\x00\x00\x01\x00\x01"
                + b"\x01a\x00\x00\x01\x00\x01\x00\x00\x00\x3c\x00\xff"
                + b"\x7f"))
    out.append(("srv-rdata-short",
                ans_hdr + b"\x01a\x00\x00\x21\x00\x01"
                + b"\x01a\x00\x00\x21\x00\x01\x00\x00\x00\x3c\x00\x02"
                + b"\x00\x00"))
    out.append(("soa-rdata-short",
                ans_hdr + b"\x01a\x00\x00\x06\x00\x01"
                + b"\x01a\x00\x00\x06\x00\x01\x00\x00\x00\x3c\x00\x03"
                + b"\x00\x00\x00"))
    out.append(("txt-string-past-rdata",
                ans_hdr + b"\x01a\x00\x00\x10\x00\x01"
                + b"\x01a\x00\x00\x10\x00\x01\x00\x00\x00\x3c\x00\x02"
                + b"\x08a"))
    out.append(("qdcount-huge",
                struct.pack(">HHHHHH", 1, 0x0100, 0xFFFF, 0, 0, 0)
                + b"\x01a\x00\x00\x01\x00\x01"))
    out.append(("arcount-huge",
                struct.pack(">HHHHHH", 1, 0x0100, 1, 0, 0, 0xFFFF)
                + b"\x01a\x03foo\x03com\x00\x00\x01\x00\x01"))
    out.append(("bad-utf8-label", q(b"\x04\xff\xfe\xfd\xfc\x00")))
    out.append(("null-bytes-64", b"\x00" * 64))
    out.append(("all-0xff-64", b"\xff" * 64))
    # seeded fuzz: random frames across the size range the UDP lane
    # accepts; deterministic so the checked-in corpus never drifts
    rng = random.Random(seed)
    for i in range(200):
        n = rng.choice((3, 7, 11, 12, 13, 17, 25, 40, 80, 200, 512))
        out.append((f"fuzz-{i:03d}",
                    bytes(rng.randrange(256) for _ in range(n))))
    # fuzz variants that keep a plausible header so count-walking code
    # is reached with garbage bodies
    for i in range(100):
        body = bytes(rng.randrange(256)
                     for _ in range(rng.randrange(1, 64)))
        counts = struct.pack(">HHHH", rng.randrange(4), rng.randrange(3),
                             rng.randrange(3), rng.randrange(3))
        out.append((f"fuzz-hdr-{i:03d}",
                    struct.pack(">HH", rng.randrange(65536), 0x0100)
                    + counts + body))
    return out


def write_corpus(path: str, seed: int = 1337) -> int:
    """Write the corpus as length-prefixed frames plus a .manifest
    sidecar of labels (one per line, same order)."""
    frames = malformed_frames(seed)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        for _, frame in frames:
            f.write(struct.pack(">H", len(frame)) + frame)
    with open(path + ".manifest", "w") as f:
        for label, _ in frames:
            f.write(label + "\n")
    return len(frames)


def read_corpus(path: str) -> List[Tuple[str, bytes]]:
    labels: List[str] = []
    manifest = path + ".manifest"
    if os.path.exists(manifest):
        with open(manifest) as f:
            labels = [ln.strip() for ln in f if ln.strip()]
    frames: List[bytes] = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + 2 <= len(data):
        (n,) = struct.unpack_from(">H", data, off)
        off += 2
        frames.append(data[off:off + n])
        off += n
    return [(labels[i] if i < len(labels) else f"frame-{i}", fr)
            for i, fr in enumerate(frames)]


# ---------------------------------------------------------------------------
# Frame builders for the non-malformed categories


def _edns_edge_frames(domain: str, rng: random.Random) -> List[bytes]:
    """EDNS edge cases: legal-but-weird OPT postures.  All must be
    answered (possibly FORMERR/REFUSED) without exceptions."""
    frames = []
    name = f"edns.{domain}"
    for payload in (0, 1, 511, 512, 1232, 4096, 65535):
        msg = make_query(name, Type.A, qid=rng.randrange(1, 65536),
                         edns_payload=None)
        wire = bytearray(msg.encode())
        # hand-assembled OPT so we control every field: root name,
        # TYPE=41, class=payload, ttl carries ext-rcode/version/DO
        wire[10:12] = struct.pack(">H", 1)  # arcount=1
        wire += b"\x00" + struct.pack(">HHI", 41, payload, 0) + b"\x00\x00"
        frames.append(bytes(wire))
    # EDNS version 1 (BADVERS territory), DO bit, unknown option
    for ttl, opts in ((0x00010000, b""), (0x00008000, b""),
                      (0, b"\x00\x0a\x00\x04zzzz")):
        msg = make_query(name, Type.A, qid=rng.randrange(1, 65536),
                         edns_payload=None)
        wire = bytearray(msg.encode())
        wire[10:12] = struct.pack(">H", 1)
        wire += (b"\x00" + struct.pack(">HHI", 41, 1232, ttl)
                 + struct.pack(">H", len(opts)) + opts)
        frames.append(bytes(wire))
    # two OPT records (illegal per RFC 6891 — server may FORMERR)
    msg = make_query(name, Type.A, qid=rng.randrange(1, 65536),
                     edns_payload=None)
    wire = bytearray(msg.encode())
    wire[10:12] = struct.pack(">H", 2)
    opt = b"\x00" + struct.pack(">HHI", 41, 1232, 0) + b"\x00\x00"
    wire += opt + opt
    frames.append(bytes(wire))
    return frames


_B32 = "abcdefghijklmnopqrstuvwxyz234567"


def _rand_name(rng: random.Random, domain: str) -> str:
    label = "".join(rng.choice(_B32) for _ in range(12))
    return f"{label}.{domain}"


# ---------------------------------------------------------------------------
# Flows


class Flow:
    """One client flow: a UDP socket bound to its own source address
    (distinct 4-tuple), connected to the server so send() is one
    syscall, with per-qid category tracking for reply attribution."""

    __slots__ = ("sock", "src", "category", "qids", "next_qid")

    def __init__(self, server: Tuple[str, int], src_ip: str,
                 category: str) -> None:
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setblocking(False)
        bind_source(self.sock, src_ip)
        self.sock.connect(server)
        self.src = self.sock.getsockname()
        self.category = category
        self.qids: Dict[int, str] = {}
        self.next_qid = 1

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _new_report() -> Dict[str, Dict[str, int]]:
    return {cat: {"sent": 0, "answered": 0, "refused": 0, "formerr": 0,
                  "slipped": 0, "dropped": 0} for cat in CATEGORIES}


def _classify(reply: bytes) -> str:
    if len(reply) < 12:
        return "answered"   # weird but it IS a reply
    flags = (reply[2] << 8) | reply[3]
    rcode = flags & 0xF
    ancount = (reply[6] << 8) | reply[7]
    if (flags & 0x0200) and ancount == 0 and rcode == 0:
        return "slipped"    # TC=1, empty: the RRL slip
    if rcode == 1:
        return "formerr"
    if rcode == 5:
        return "refused"
    return "answered"


def blast(host: str, port: int, *, duration: float = 10.0,
          flows: int = 64, mix: Optional[Dict[str, float]] = None,
          names: Optional[Sequence[str]] = None,
          domain: str = "foo.com", qps: int = 0,
          seed: int = 7, corpus: Optional[List[Tuple[str, bytes]]] = None,
          ) -> Dict[str, object]:
    """Run the hostile load for *duration* seconds; returns the report.

    ``qps=0`` means unpaced (as fast as the box sends).  ``names`` is
    the realistic name population for the legit/spoof categories
    (defaults to ``w{0..7}.{domain}``)."""
    mix = dict(mix or DEFAULT_MIX)
    total_w = sum(mix.get(c, 0.0) for c in CATEGORIES) or 1.0
    weights = [mix.get(c, 0.0) / total_w for c in CATEGORIES]
    rng = random.Random(seed)
    names = list(names or [f"w{i}.{domain}" for i in range(8)])
    corpus_frames = [fr for _, fr in (corpus or malformed_frames())]
    edns_frames = _edns_edge_frames(domain, rng)
    server = (host, port)

    # flow population: spoof flows get hostile-prefix sources; the
    # rest draw from a wider 127/8 spread (distinct 4-tuples but not
    # concentrated in one prefix, like real eyeballs)
    flow_objs: List[Flow] = []
    n_spoof = max(1, int(flows * weights[CATEGORIES.index("spoof")])) \
        if weights[CATEGORIES.index("spoof")] > 0 else 0
    for i in range(flows):
        if i < n_spoof:
            pfx = HOSTILE_PREFIXES[i % len(HOSTILE_PREFIXES)]
            src = f"{pfx}.{(i % 253) + 2}"
            cat = "spoof"
        else:
            src = f"127.{(i % 31) + 100}.{(i // 31) % 256}." \
                  f"{(i % 253) + 2}"
            cat = "any"
        try:
            flow_objs.append(Flow(server, src, cat))
        except OSError:
            for fl in flow_objs:
                fl.close()
            raise

    sel = selectors.DefaultSelector()
    for fl in flow_objs:
        sel.register(fl.sock, selectors.EVENT_READ, fl)

    report = _new_report()
    sent_total = 0
    t0 = time.monotonic()
    deadline = t0 + duration
    next_send = t0
    interval = (1.0 / qps) if qps > 0 else 0.0
    burst = 32
    other_cats = [c for c in CATEGORIES if c != "spoof"]
    other_w = [mix.get(c, 0.0) for c in other_cats]
    if sum(other_w) <= 0:
        other_w = [1.0] * len(other_cats)
    fi = 0

    def build(cat: str, fl: Flow) -> bytes:
        if cat in ("legit", "spoof"):
            qtype = rng.choices([t for t, _ in QTYPE_MIX],
                                weights=[w for _, w in QTYPE_MIX])[0]
            name = rng.choice(names)
            qid = fl.next_qid
            fl.next_qid = (fl.next_qid % 65535) + 1
            fl.qids[qid] = cat
            return make_query(name, qtype, qid=qid,
                              edns_payload=(1232 if rng.random() < 0.8
                                            else None)).encode()
        if cat == "random":
            qid = fl.next_qid
            fl.next_qid = (fl.next_qid % 65535) + 1
            fl.qids[qid] = cat
            return make_query(_rand_name(rng, domain), Type.A,
                              qid=qid).encode()
        if cat == "malformed":
            frame = rng.choice(corpus_frames)
            if len(frame) >= 2:
                fl.qids[(frame[0] << 8) | frame[1]] = cat
            return frame
        if cat == "edns":
            frame = rng.choice(edns_frames)
            fl.qids[(frame[0] << 8) | frame[1]] = cat
            return frame
        # oversized: a junk datagram far over MAX_EDNS_PAYLOAD
        return b"\x13\x37" + b"\xab" * 8190

    def drain(timeout: float = 0.0) -> None:
        for key, _ in sel.select(timeout):
            fl: Flow = key.data
            for _ in range(64):
                try:
                    reply = fl.sock.recv(65535)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    break
                cat = "oversized"
                if len(reply) >= 2:
                    qid = (reply[0] << 8) | reply[1]
                    cat = fl.qids.pop(qid, None) or \
                        ("spoof" if fl.category == "spoof" else "legit")
                report[cat][_classify(reply)] += 1

    while True:
        now = time.monotonic()
        if now >= deadline:
            break
        if interval and now < next_send:
            drain(min(next_send - now, deadline - now))
            continue
        for _ in range(burst):
            fl = flow_objs[fi]
            fi = (fi + 1) % len(flow_objs)
            if fl.category == "spoof":
                cat = "spoof"
            else:
                cat = rng.choices(other_cats, weights=other_w)[0]
            frame = build(cat, fl)
            try:
                fl.sock.send(frame)
            except OSError:
                continue    # buffer full / oversized rejected locally
            report[cat]["sent"] += 1
            sent_total += 1
            if interval:
                next_send += interval
        drain(0.0)
    # grace drain for stragglers
    end = time.monotonic() + 0.25
    while time.monotonic() < end:
        drain(0.05)
    elapsed = time.monotonic() - t0

    for cat, row in report.items():
        row["dropped"] = max(0, row["sent"] - row["answered"]
                             - row["refused"] - row["formerr"]
                             - row["slipped"])
    prefixes = len({fl.src[0].rsplit(".", 1)[0] for fl in flow_objs})
    for fl in flow_objs:
        sel.unregister(fl.sock)
        fl.close()
    sel.close()
    return {
        "duration_s": round(elapsed, 3),
        "flows": flows,
        "mix": {c: round(w, 4) for c, w in zip(CATEGORIES, weights)},
        "hostile_qps": round(sent_total / elapsed, 1) if elapsed else 0.0,
        "sent": sent_total,
        # population shape (same keys population.py exports, so
        # consumers can describe ANY harness run uniformly): hostile
        # flows are one identity per socket, uniform name draw, no NAT
        "population": {"identities": flows, "prefixes": prefixes,
                       "zipf_s": None, "nat_fan_in": 1},
        "categories": report,
    }


def legit_probe(host: str, port: int, *, duration: float = 5.0,
                names: Optional[Sequence[str]] = None,
                domain: str = "foo.com", timeout: float = 0.5,
                qps: int = 0) -> Dict[str, float]:
    """Closed-loop legit client from 127.0.0.1 (NOT a hostile prefix):
    one query at a time, waits for each answer — the goodput
    measurement the hostile bench axis compares against its no-flood
    control.  ``qps`` paces the offered load (0 = as fast as answers
    come back); pace it *below* the server's RRL per-prefix limit, or
    the probe measures its own rate limiting instead of the flood's
    collateral damage.  Returns {qps, answered, sent, timeouts,
    answered_ratio}."""
    names = list(names or [f"w{i}.{domain}" for i in range(8)])
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.connect((host, port))
    sock.settimeout(timeout)
    sent = answered = timeouts = 0
    qid = 1
    t0 = time.monotonic()
    deadline = t0 + duration
    interval = (1.0 / qps) if qps > 0 else 0.0
    next_send = t0
    try:
        while True:
            now = time.monotonic()
            if now >= deadline:
                break
            if interval and now < next_send:
                time.sleep(min(next_send - now, deadline - now))
                continue
            next_send += interval
            name = names[sent % len(names)]
            wire = make_query(name, Type.A, qid=qid).encode()
            qid = (qid % 65535) + 1
            sock.send(wire)
            sent += 1
            try:
                reply = sock.recv(65535)
            except socket.timeout:
                timeouts += 1
                continue
            if len(reply) >= 12 and (reply[3] & 0xF) == 0:
                answered += 1
    finally:
        sock.close()
    elapsed = time.monotonic() - t0
    return {"qps": round(answered / elapsed, 1) if elapsed else 0.0,
            "sent": sent, "answered": answered, "timeouts": timeouts,
            "answered_ratio": round(answered / sent, 4) if sent else 0.0}


def parse_mix(text: str) -> Dict[str, float]:
    mix: Dict[str, float] = {}
    for part in text.split(","):
        if not part.strip():
            continue
        cat, _, w = part.partition("=")
        if cat.strip() not in CATEGORIES:
            raise ValueError(f"unknown category {cat.strip()!r} "
                             f"(have {', '.join(CATEGORIES)})")
        mix[cat.strip()] = float(w or 1.0)
    return mix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="adversarial multi-flow DNS load harness")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--flows", type=int, default=64)
    ap.add_argument("--qps", type=int, default=0,
                    help="paced send rate (0 = unpaced)")
    ap.add_argument("--mix", type=parse_mix, default=None,
                    help="e.g. legit=0.2,spoof=0.5,malformed=0.3")
    ap.add_argument("--domain", default="foo.com")
    ap.add_argument("--names", default=None,
                    help="comma-separated realistic name population")
    ap.add_argument("--names-file", default=None,
                    help="the name population, one name per line (for "
                         "populations too large for one argument)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--write-corpus", metavar="PATH", default=None,
                    help="write the malformed corpus + manifest and exit")
    args = ap.parse_args(argv)

    if args.write_corpus:
        n = write_corpus(args.write_corpus)
        print(f"wrote {n} frames to {args.write_corpus}", file=sys.stderr)
        return 0
    if args.port is None:
        ap.error("--port is required")
    names = args.names.split(",") if args.names else None
    if args.names_file:
        with open(args.names_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    report = blast(args.host, args.port, duration=args.duration,
                   flows=args.flows, mix=args.mix, names=names,
                   domain=args.domain, qps=args.qps, seed=args.seed)
    json.dump(report, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
