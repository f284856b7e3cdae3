"""Response rate limiting (RRL): per-client-prefix slip/drop on UDP.

The admission layer (`admission.py`) bounds the *expensive* work a
client can trigger — recursion forwards, in-flight table growth.  It
deliberately never touches the cheap mirror-served path, which is why
a spoofed-source UDP flood sails straight through it: every spoofed
packet is a fresh "client", every answer is a cache hit, and binder
happily becomes a reflection amplifier while legitimate traffic
starves behind the flood in the socket buffer.

RRL is the classic countermeasure (BIND/NSD ship the same shape): rate
limit *responses* per client network prefix, and for a fraction of
limited traffic send a truncated (TC=1) echo — the "slip" — instead of
silence.  A real client behind a rate-limited prefix retries over TCP
and gets a full answer; a spoofed victim receives a tiny TC packet
(smaller than the query — negative amplification) and nothing else.

Mechanics, mirroring `AdmissionControl`'s house style:

- Token bucket per prefix (``/24`` v4, ``/56`` v6 by default — one
  host of a spoofed 64-bit-IID v6 flood must not mint one bucket per
  packet).  Buckets live in an insertion-ordered LRU capped at
  ``maxBuckets``; an evicted prefix restarts with a full bucket, so
  the table bounds memory under arbitrary source diversity.
- Every ``slipRatio``-th limited response slips (TC echo); the rest
  drop silently.  ``slipRatio=0`` means pure drop, ``1`` slips
  everything.
- Drops count into ``binder_shed_total{reason="response-ratelimit"}``
  through the admission layer's `_note_shed` (same rate-limited
  ``query-shed`` flight event); the limiter additionally keeps its own
  fold-ready plain-int counters (``binder_rrl_*``) and emits a
  rate-limited ``hostile-flood`` flight event when limiting starts.
- ``hot()`` reports "limiting happened recently".  BinderServer
  couples it into the native fastpath gate: while a flood is being
  shed, every packet must surface to Python so the limiter can judge
  it — the C drain loop answers cache hits before RRL could see them.
  Costing the flood window the fastpath is the honest trade; the
  limiter then sheds at its own (cheap, decode-free) ingress.
- Detection under the fastpath: a cache-hit flood answered entirely
  in C would never reach `decide()` to trip ``hot()`` in the first
  place.  The batched UDP reader therefore **samples by packet
  count** while the gate is open: one ``recv_batch`` drains through
  Python with ``sample_cost`` set to ``FASTPATH_SAMPLE_EVERY``, and
  each packet so judged lets the C drain serve
  ``FASTPATH_SAMPLE_EVERY - 1`` more, so each sampled packet charges
  its prefix what the unsampled stream would have.  Counting packets
  rather than readiness events means a burst that lands in a single
  event is sampled like the same burst spread over many.  A flooded
  prefix overdraws within a bucket-burst of sampled traffic →
  ``hot()`` → gate shut → full per-packet judgment until the flood
  subsides.

The limiter judges the packet *before* decode on the UDP lane, so
malformed floods are shed at the same price as well-formed ones.

v2 adds the two production escape hatches the base mechanism lacks
(docs/operations.md "Binder is under attack"):

- **Allowlists** — config-driven source prefixes that are never
  limited.  Judged inside `decide()` (pre-decode, raw-bytes cost) via
  a per-full-IP verdict cache, so an allowlisted monitoring host or
  anycast peer pays one prefix match ever; allowlisted sources never
  mint buckets, so they cannot be evicted into limiting by a spray.
- **Adaptive buckets** — the NAT'd-resolver-farm fix.  A /24 hiding
  thousands of real clients overdraws its bucket at aggregate qps and
  every one of those drops is a false positive.  But the TC=1 slip is
  a built-in liveness probe: a *real* client retries the slipped query
  over TCP (spoofed floods never complete a handshake).  The stream
  lane reports completed TCP serves via `note_tcp()`; a prefix that
  keeps completing TCP retries *while being limited* accumulates
  evidence and earns a doubled rate multiplier (up to
  ``adaptMaxMultiplier``), converging on just enough headroom that
  limiting stops.  Limited responses charged to a prefix before it
  proved real are attributed to ``false_positives`` — making the RRL
  false-positive rate a measured number, not a guess.
"""
from __future__ import annotations

import logging
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

DEFAULT_RESPONSES_PER_SECOND = 200.0
DEFAULT_BURST = 400.0
DEFAULT_SLIP_RATIO = 2          # every 2nd limited response slips TC
DEFAULT_PREFIX_V4 = 24
DEFAULT_PREFIX_V6 = 56
#: prefixes tracked at once (LRU) — bounds memory under spoofing
DEFAULT_MAX_BUCKETS = 8192
#: adaptive sizing: rate-multiplier ceiling a TCP-proven prefix can earn
DEFAULT_ADAPT_MAX_MULTIPLIER = 16.0
#: completed TCP serves (while limited) per doubling step
DEFAULT_ADAPT_EVIDENCE = 3

#: decide() verdicts
SEND, SLIP, DROP = 0, 1, 2

#: slip replies echo the request; anything larger than a classic UDP
#: payload is not worth echoing (and drops carry no amplification risk)
_SLIP_MAX_ECHO = 512


class ResponseRateLimiter:
    SEND = SEND
    SLIP = SLIP
    DROP = DROP

    #: hostile-flood flight events are rate-limited to one per window
    FLOOD_EVENT_WINDOW_S = 5.0
    #: hot() stays true this long after the last limited response —
    #: long enough to hold the fastpath gate shut across flood bursts,
    #: short enough that the gate reopens promptly once the flood ends
    HOT_HOLD_S = 2.0
    #: while the fastpath gate is open, 1 in this many UDP packets
    #: surfaces to Python so the limiter samples the C-served stream
    #: (each sampled packet charged this many tokens)
    FASTPATH_SAMPLE_EVERY = 8
    #: adapted-prefix records tracked at once — entries exist only for
    #: prefixes that completed a TCP serve while limited, so spoofed
    #: floods (which never complete a handshake) cannot mint them
    ADAPT_MAX_TRACKED = 1024

    def __init__(self, *, enabled: bool = True,
                 responses_per_second: float = DEFAULT_RESPONSES_PER_SECOND,
                 burst: float = DEFAULT_BURST,
                 slip_ratio: int = DEFAULT_SLIP_RATIO,
                 prefix_v4: int = DEFAULT_PREFIX_V4,
                 prefix_v6: int = DEFAULT_PREFIX_V6,
                 max_buckets: int = DEFAULT_MAX_BUCKETS,
                 allowlist: Sequence[str] = (),
                 adaptive: bool = True,
                 adapt_max_multiplier: float = DEFAULT_ADAPT_MAX_MULTIPLIER,
                 adapt_evidence: int = DEFAULT_ADAPT_EVIDENCE,
                 note_shed: Optional[Callable] = None,
                 recorder=None,
                 log: Optional[logging.Logger] = None) -> None:
        self.enabled = bool(enabled)
        self.responses_per_second = float(responses_per_second)
        self.burst = float(burst)
        self.slip_ratio = int(slip_ratio)
        self.prefix_v4 = int(prefix_v4)
        self.prefix_v6 = int(prefix_v6)
        self.max_buckets = int(max_buckets)
        self.adaptive = bool(adaptive)
        self.adapt_max_multiplier = float(adapt_max_multiplier)
        self.adapt_evidence = max(1, int(adapt_evidence))
        self.note_shed = note_shed     # AdmissionControl._note_shed
        self.recorder = recorder
        self.log = log or logging.getLogger("binder.rrl")
        # prefix -> (tokens, last_refill_mono, limited_count);
        # insertion-ordered LRU like admission's client buckets
        self._buckets: Dict[str, Tuple[float, float, int]] = {}
        # full source ip -> prefix string; computing a v6 prefix per
        # packet would be the flood's cost, not the flooder's
        self._prefix_cache: Dict[str, str] = {}
        # allowlist: (packed_network, nbytes, tailmask) per family;
        # per-full-IP verdicts cached so the match runs once per source
        self.allowlist: Tuple[str, ...] = tuple(allowlist or ())
        self._allow_nets_v4: List[Tuple[bytes, int, int]] = []
        self._allow_nets_v6: List[Tuple[bytes, int, int]] = []
        for entry in self.allowlist:
            parsed = self._parse_network(entry)
            if parsed is None:
                self.log.warning("rrl: ignoring bad allowlist entry %r",
                                 entry)
                continue
            (self._allow_nets_v6 if parsed[3] else
             self._allow_nets_v4).append(parsed[:3])
        self._allow_cache: Dict[str, bool] = {}
        # adaptive sizing: prefix -> [multiplier, evidence, limited_cum]
        # — separate from the bucket LRU so a spray that evicts the
        # bucket cannot erase an earned multiplier
        self._adapted: Dict[str, List] = {}
        self._hot_until = 0.0
        self._flood_event_last = 0.0
        #: tokens one decide() charges; the batched UDP reader raises
        #: it to FASTPATH_SAMPLE_EVERY for the batches it samples so
        #: the sampled stream approximates the true per-prefix rate
        self.sample_cost = 1.0
        # fold-ready plain-int counters (scrape-time fold pattern)
        self.responses = 0     # decisions taken (SEND verdicts)
        self.slipped = 0
        self.dropped = 0
        self.evictions = 0
        self.allowlisted = 0   # responses passed by allowlist match
        self.adaptations = 0   # multiplier doubling steps taken
        #: limited responses charged to a prefix *before* it proved
        #: real via TCP completion — the measured false-positive count
        self.false_positives = 0

    @classmethod
    def from_config(cls, config: Optional[dict], *,
                    note_shed=None, recorder=None,
                    log=None) -> Optional["ResponseRateLimiter"]:
        """Build from the ``rrl`` config block; None (or
        ``enabled: false``) disables the layer entirely — the engine
        sees ``rrl=None`` and the UDP lane pays nothing.  An empty
        block means "on, defaults" (the admission-layer convention)."""
        if config is None or not config.get("enabled", True):
            return None
        return cls(
            responses_per_second=config.get(
                "responsesPerSecond", DEFAULT_RESPONSES_PER_SECOND),
            burst=config.get("burst", DEFAULT_BURST),
            slip_ratio=config.get("slipRatio", DEFAULT_SLIP_RATIO),
            prefix_v4=config.get("prefixV4", DEFAULT_PREFIX_V4),
            prefix_v6=config.get("prefixV6", DEFAULT_PREFIX_V6),
            max_buckets=config.get("maxBuckets", DEFAULT_MAX_BUCKETS),
            allowlist=config.get("allowlist", ()),
            adaptive=config.get("adaptive", True),
            adapt_max_multiplier=config.get(
                "adaptMaxMultiplier", DEFAULT_ADAPT_MAX_MULTIPLIER),
            adapt_evidence=config.get(
                "adaptEvidence", DEFAULT_ADAPT_EVIDENCE),
            note_shed=note_shed, recorder=recorder, log=log)

    # -- allowlist --

    @staticmethod
    def _parse_network(entry: str) -> Optional[Tuple[bytes, int, int, bool]]:
        """``"10.0.0.0/8"`` → (packed_network, whole_bytes, tail_mask,
        is_v6); a bare address gets the full-length prefix.  None on
        garbage — config typos must not crash the serve stack."""
        try:
            text, _, bits_s = str(entry).partition("/")
            v6 = ":" in text
            fam = socket.AF_INET6 if v6 else socket.AF_INET
            raw = socket.inet_pton(fam, text.strip())
            width = len(raw) * 8
            bits = int(bits_s) if bits_s else width
            if not 0 <= bits <= width:
                return None
        except (OSError, ValueError):
            return None
        nbytes, rem = divmod(bits, 8)
        tail_mask = (0xFF00 >> rem) & 0xFF if rem else 0
        network = raw[:nbytes + (1 if rem else 0)]
        if rem:
            network = network[:-1] + bytes([network[-1] & tail_mask])
        return (network, nbytes, tail_mask, v6)

    def _allowed(self, ip: str) -> bool:
        """Pre-decode allowlist check: one inet_pton + linear match per
        *new* source IP, a dict hit thereafter.  The verdict cache is
        bounded like every other table here."""
        cached = self._allow_cache.get(ip)
        if cached is not None:
            return cached
        v6 = ":" in ip
        nets = self._allow_nets_v6 if v6 else self._allow_nets_v4
        verdict = False
        if nets:
            try:
                raw = socket.inet_pton(
                    socket.AF_INET6 if v6 else socket.AF_INET, ip)
            except OSError:
                raw = None
            if raw is not None:
                for network, nbytes, tail_mask in nets:
                    if raw[:nbytes] != network[:nbytes]:
                        continue
                    if tail_mask and (raw[nbytes] & tail_mask
                                      != network[nbytes]):
                        continue
                    verdict = True
                    break
        if len(self._allow_cache) >= self.max_buckets:
            self._allow_cache.pop(next(iter(self._allow_cache)))
        self._allow_cache[ip] = verdict
        return verdict

    # -- prefix mapping --

    def _prefix(self, ip: str) -> str:
        cached = self._prefix_cache.get(ip)
        if cached is not None:
            return cached
        if ":" in ip:
            # v6: mask to prefix_v6 bits without the ipaddress module
            # (this runs per flood packet)
            try:
                import socket as _socket
                raw = _socket.inet_pton(_socket.AF_INET6, ip)
                bits = self.prefix_v6
                nbytes, rem = divmod(bits, 8)
                masked = bytearray(raw[:nbytes] + b"\x00" * (16 - nbytes))
                if rem and nbytes < 16:
                    masked[nbytes] = raw[nbytes] & (0xFF00 >> rem & 0xFF)
                prefix = masked.hex() + f"/{bits}"
            except OSError:
                prefix = ip
        else:
            # v4: /24 (or configured) by octet split — no parsing
            keep = max(1, min(4, self.prefix_v4 // 8))
            prefix = ".".join(ip.split(".")[:keep]) + f"/{self.prefix_v4}"
        if len(self._prefix_cache) >= self.max_buckets:
            self._prefix_cache.pop(next(iter(self._prefix_cache)))
        self._prefix_cache[ip] = prefix
        return prefix

    # -- the per-packet decision --

    def decide(self, ip: str) -> int:
        """Charge one response against *ip*'s prefix bucket.

        Returns SEND (answer normally), SLIP (send the TC echo built
        by `slip_reply`), or DROP (silence).  Counts and flight events
        are handled here; the caller only routes the verdict."""
        if not self.enabled:
            return SEND
        if ((self._allow_nets_v4 or self._allow_nets_v6)
                and self._allowed(ip)):
            # never limited, never minting a bucket slot — the spray
            # cannot evict an allowlisted peer into limiting
            self.allowlisted += 1
            return SEND
        now = time.monotonic()
        prefix = self._prefix(ip)
        # TCP-proven prefixes run with an earned rate multiplier; the
        # dict is empty until the first note_tcp() adaptation, so the
        # common path pays one truthiness check
        adapted = self._adapted.get(prefix) if self._adapted else None
        mult = adapted[0] if adapted is not None else 1.0
        burst = self.burst * mult
        entry = self._buckets.pop(prefix, None)
        if entry is None:
            if len(self._buckets) >= self.max_buckets:
                self._buckets.pop(next(iter(self._buckets)))
                self.evictions += 1
            tokens, limited = burst, 0
        else:
            tokens, last, limited = entry
            tokens = min(burst, tokens + (now - last)
                         * self.responses_per_second * mult)
        if tokens >= 1.0:
            self._buckets[prefix] = (tokens - self.sample_cost, now, 0)
            self.responses += 1
            return SEND
        # limited: slip every slip_ratio-th, drop the rest
        limited += 1
        self._buckets[prefix] = (tokens, now, limited)
        if adapted is not None:
            # candidate false positive: this prefix has completed TCP
            # serves before; attributed when the next adaptation lands
            adapted[2] += 1
        self._hot_until = now + self.HOT_HOLD_S
        if (self.recorder is not None
                and now - self._flood_event_last
                >= self.FLOOD_EVENT_WINDOW_S):
            self._flood_event_last = now
            self.recorder.record(
                "hostile-flood", prefix=prefix,
                slipped=self.slipped, dropped=self.dropped,
                buckets=len(self._buckets))
        if self.slip_ratio > 0 and limited % self.slip_ratio == 0:
            self.slipped += 1
            return SLIP
        self.dropped += 1
        if self.note_shed is not None:
            self.note_shed("response-ratelimit", prefix=prefix)
        return DROP

    # -- adaptive sizing (TCP liveness evidence) --

    def note_tcp(self, ip: str) -> None:
        """A TCP query from *ip* was served to completion.

        Called by the stream lane after a successful TCP serve.  While
        a prefix is being limited, each completed TCP serve is proof a
        real client sits behind it — a spoofed source cannot finish the
        handshake the TC=1 slip invites.  ``adapt_evidence`` proofs buy
        one doubling of the prefix's rate multiplier (capped at
        ``adapt_max_multiplier``), and the limited responses the prefix
        absorbed before each doubling are attributed to
        ``false_positives``.  Off the limited path this is one dict
        lookup; evidence only accrues while the prefix's bucket shows
        active limiting, so adapted farms stop growing once they have
        just enough headroom."""
        if not self.enabled or not self.adaptive:
            return
        prefix = self._prefix(ip)
        adapted = self._adapted.get(prefix)
        bucket = self._buckets.get(prefix)
        limiting = bucket is not None and (bucket[0] < 1.0 or bucket[2] > 0)
        if adapted is None:
            if not limiting:
                return      # ordinary TCP traffic, nothing to prove
            if len(self._adapted) >= self.ADAPT_MAX_TRACKED:
                self._adapted.pop(next(iter(self._adapted)))
            # seed the false-positive ledger with the limited streak
            # that pushed this client to TCP in the first place
            adapted = self._adapted[prefix] = [1.0, 0, bucket[2]]
        elif not limiting:
            return
        adapted[1] += 1
        if (adapted[1] < self.adapt_evidence
                or adapted[0] >= self.adapt_max_multiplier):
            return
        adapted[1] = 0
        adapted[0] = min(self.adapt_max_multiplier, adapted[0] * 2.0)
        self.adaptations += 1
        self.false_positives += adapted[2]
        fp = adapted[2]
        adapted[2] = 0
        if self.recorder is not None:
            self.recorder.record(
                "rrl-adapt", prefix=prefix, multiplier=adapted[0],
                false_positives=fp)
        self.log.info("rrl: adapted %s to %.0fx (%d limited responses "
                      "attributed as false positives)",
                      prefix, adapted[0], fp)

    def adapted_count(self) -> int:
        """Prefixes currently holding an earned multiplier > 1 — the
        ``binder_rrl_adapted_buckets`` gauge."""
        return sum(1 for v in self._adapted.values() if v[0] > 1.0)

    @staticmethod
    def slip_reply(data: bytes) -> Optional[bytes]:
        """TC=1 echo of the request — the RRL slip.

        Byte-2 keeps opcode+RD, sets QR|TC, clears AA; byte-3 zeroes
        RA/Z/rcode.  The body is echoed verbatim, so the reply is never
        larger than the query (negative amplification) and a legit
        client's resolver sees its own question with TC and retries
        over TCP.  None (caller drops) for headerless or oversized
        frames — nothing legitimate sends either."""
        if len(data) < 12 or len(data) > _SLIP_MAX_ECHO:
            return None
        b = bytearray(data)
        b[2] = 0x80 | (b[2] & 0x79) | 0x02
        b[3] = 0x00
        return bytes(b)

    # -- state for the fastpath gate coupling --

    def hot(self) -> bool:
        """True while limiting happened within HOT_HOLD_S — the signal
        BinderServer uses to keep the C fastpath gate shut so every
        packet surfaces to Python for per-prefix judgment."""
        return time.monotonic() < self._hot_until

    # -- introspection (status.py `policy.rrl`) --

    def introspect(self) -> dict:
        return {
            "enabled": self.enabled,
            "responses_per_second": self.responses_per_second,
            "burst": self.burst,
            "slip_ratio": self.slip_ratio,
            "prefix_v4": self.prefix_v4,
            "prefix_v6": self.prefix_v6,
            "max_buckets": self.max_buckets,
            "buckets": len(self._buckets),
            "hot": self.hot(),
            "responses": self.responses,
            "slipped": self.slipped,
            "dropped": self.dropped,
            "evictions": self.evictions,
            "allowlist": list(self.allowlist),
            "allowlisted": self.allowlisted,
            "adaptive": self.adaptive,
            "adapted_buckets": self.adapted_count(),
            "adaptations": self.adaptations,
            "false_positives": self.false_positives,
        }
