"""Per-query context: request, response-under-construction, timers.

The mname-equivalent query object handed to the resolution layer (reference
mname's query, consumed at ``lib/server.js:471-507``).  Carries:

- the decoded request and the response being assembled,
- the client address (which for balancer-socket queries is the *original*
  client, not the balancer — SURVEY §2.2 L1),
- per-phase timers (reference ``query._stamp``, ``lib/server.js:476-483``),
- the structured-log context dict.

``respond()`` hands the finished response to the transport callback exactly
once; the server engine then emits the ``after`` event for metrics/logging
(reference ``lib/server.js:509-591``).
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Dict, Optional, Tuple

from binder_torch.dns.wire import (
    Message,
    OPTRecord,
    Record,
    Type,
)

_ECHO_OPT = OPTRecord(name="", ttl=0, udp_payload_size=1232)

# Per-query trace IDs: "<pid hex>-<seq hex>", unique within a process
# for the life of the counter and distinguishable across the N-process
# deployment unit.  itertools.count.__next__ is a single C call, so
# concurrent allocation (scrape threads, tests) can never hand two
# queries the same sequence number.
_TRACE_SEQ = itertools.count(1)
_TRACE_PREFIX = f"{os.getpid():x}-"


def next_trace_id() -> str:
    """Allocate a process-unique query trace ID (the attribution key
    carried through probes, phase stamps, and the query log)."""
    return _TRACE_PREFIX + format(next(_TRACE_SEQ), "x")


class QueryCtx:
    __slots__ = ("request", "response", "src", "protocol",
                 "client_transport", "_send", "_responded", "bytes_sent",
                 "start", "_last_stamp", "times", "log_ctx", "raw", "wire",
                 "cached_summary", "no_store", "dep_domain",
                 "want_log_detail", "trace_id", "after_done")

    def __init__(self, request: Message,
                 src: Tuple[str, int],
                 protocol: str,
                 send: Callable[[bytes], None],
                 client_transport: Optional[str] = None,
                 raw: Optional[bytes] = None) -> None:
        self.request = request
        self.raw = raw          # request wire bytes (answer-cache key)
        self.wire: Optional[bytes] = None   # encoded response after respond()
        # (answers, additional) log summaries on an answer-cache hit, so
        # the query log keeps record detail for cached responses
        self.cached_summary: Optional[Tuple[list, list]] = None
        self.src = src
        self.protocol = protocol  # 'udp' | 'tcp' | 'balancer'
        # For balancer queries: the transport the client used to reach the
        # balancer ('udp'|'tcp') — decides truncation semantics.
        self.client_transport = client_transport
        self._send = send
        # set by the recursion handoff: this response is rebuilt from
        # another DC's data, and no cache layer may keep it (the
        # balancer-socket transport propagates it as the do-not-store
        # marker, docs/balancer-protocol.md)
        self.no_store = False
        # set by the resolver at its store-lookup points: the mirrored
        # name this query's answer derives from (service node domain for
        # SRV, reverse qname for PTR) — the answer cache's per-name
        # invalidation tag
        self.dep_domain: Optional[str] = None
        # set by the server when per-query logging is on: response paths
        # that shortcut record decoding (the recursion raw splice) must
        # instead take the decoding path so log lines keep full answer
        # summaries
        self.want_log_detail = False
        self._responded = False
        # latched by the engine's _after: a query that was SHED (overload
        # admission responded for it) must not be metered again when its
        # original completion path finally runs
        self.after_done = False
        self.bytes_sent = 0
        self.start = time.monotonic()
        self._last_stamp = self.start
        self.times: Dict[str, float] = {}
        self.log_ctx: Dict[str, object] = {}
        # attribution identity: carried by probes, the query log, and
        # the per-stage stamps so one query's hops correlate across
        # layers (the reference correlates dtrace op-req-start/done by
        # the lazily-built JSON args; here the ID is explicit)
        self.trace_id = next_trace_id()

        self.response = Message(
            id=request.id, qr=True, opcode=request.opcode, aa=True,
            rd=request.rd, ra=False, questions=list(request.questions))
        opt = request.edns
        if opt is not None:
            # echo EDNS back with our payload ceiling; the OPT instance is
            # shared across queries — nothing on the serve path mutates
            # records, only the additionals *list* (which is per-query)
            self.response.additionals.append(_ECHO_OPT)

    # -- request accessors --

    def name(self) -> str:
        return self.request.questions[0].name if self.request.questions else ""

    def qtype(self) -> int:
        return (self.request.questions[0].qtype
                if self.request.questions else 0)

    def qtype_name(self) -> str:
        return Type.name(self.qtype())

    def rd(self) -> bool:
        return self.request.rd

    # -- response construction (mname addAnswer/addAuthority/addAdditional) --

    def set_error(self, rcode: int) -> None:
        self.response.rcode = rcode

    def rcode(self) -> int:
        return self.response.rcode

    def add_answer(self, record: Record) -> None:
        self.response.answers.append(record)

    def add_authority(self, record: Record) -> None:
        self.response.authorities.append(record)

    def add_additional(self, record: Record) -> None:
        self.response.additionals.append(record)

    def reset_sections(self) -> None:
        """Drop any half-built (possibly unencodable) answer set while
        KEEPING the EDNS echo: error responses (SERVFAIL after a
        handler failure, overload REFUSED) must carry the query's EDNS
        posture — a bare `additionals.clear()` silently stripped the
        OPT and broke EDNS conformance on every error path."""
        self.response.answers.clear()
        self.response.authorities.clear()
        self.response.additionals.clear()
        if self.request.edns is not None:
            self.response.additionals.append(_ECHO_OPT)

    # -- timers (lib/server.js:476-483) --

    def stamp(self, name: str) -> None:
        """Record the time (ms) since the previous stamp under ``name``
        and advance the cursor — consecutive stamps decompose the
        query's latency into non-overlapping phases (monotonic clock, so
        every recorded delta is >= 0)."""
        now = time.monotonic()
        self.times[name] = (now - self._last_stamp) * 1000.0
        self._last_stamp = now

    def record_phase(self, name: str, ms: float) -> None:
        """Record an externally measured phase duration (ms) WITHOUT
        moving the stamp cursor — for spans another layer timed itself
        (upstream RTT measured by the DNS client, event-loop wait
        measured at callback entry) that overlap the stamp timeline."""
        self.times[name] = ms

    def latency_ms(self) -> float:
        return (time.monotonic() - self.start) * 1000.0

    def last_phase(self) -> Optional[str]:
        """Name of the most recently recorded phase — the in-flight
        table's "where is this query right now" column (a query parked
        between stamps is in whatever follows its last one)."""
        try:
            return next(reversed(self.times))
        except StopIteration:
            return None

    # -- completion --

    @property
    def udp_semantics(self) -> bool:
        """True when the response travels to the client as a UDP datagram
        (directly, or via the balancer fronting a UDP client) and so must
        honor truncation.  The answer cache keys on this too — keep them
        in lockstep."""
        return (self.protocol == "udp"
                or (self.protocol == "balancer"
                    and self.client_transport != "tcp"))

    def _echo_question_case(self, wire: bytes) -> bytes:
        """dns0x20 (draft-vixie-dnsext-dns0x20): echo the requester's
        original question bytes — the encoder emits lowercase, but 0x20
        validators (including our own upstream DNS client) require the
        exact case mask back.  Declines (returns the wire unchanged) for
        any shape it can't prove safe: no raw request, multi-question,
        compressed qname, or a question that differs beyond case."""
        raw = self.raw
        if raw is None or len(raw) < 17 or raw[4:6] != b"\x00\x01" \
                or wire[4:6] != b"\x00\x01":
            return wire
        off = 12
        try:
            while True:
                ll = raw[off]
                if ll == 0:
                    off += 1
                    break
                if ll & 0xC0:
                    return wire          # compressed qname in request
                off += 1 + ll
        except IndexError:
            return wire
        q_end = off + 4
        if q_end > len(raw) or q_end > len(wire):
            return wire
        req_q = raw[12:q_end]
        if wire[12:q_end] == req_q:
            return wire                  # already identical
        if wire[12:q_end].lower() != req_q.lower():
            return wire                  # different question: leave it
        return wire[:12] + req_q + wire[q_end:]

    def respond(self) -> None:
        if self._responded:
            return
        # encode BEFORE marking responded: an encode failure must leave the
        # fallback SERVFAIL path able to answer
        if self.udp_semantics:
            wire = self.response.encode(max_size=self.request.max_udp_payload())
        else:
            wire = self.response.encode()
        wire = self._echo_question_case(wire)
        self._responded = True
        self.wire = wire
        self.bytes_sent = len(wire)
        self._send(wire)

    def respond_raw(self, wire: bytes) -> None:
        """Send a pre-encoded response (answer-cache hit), patching in
        this request's id and the requester's question case."""
        if self._responded:
            return
        wire = self.request.id.to_bytes(2, "big") + wire[2:]
        wire = self._echo_question_case(wire)
        self._responded = True
        self.wire = wire
        self.bytes_sent = len(wire)
        self._send(wire)

    @property
    def responded(self) -> bool:
        return self._responded
