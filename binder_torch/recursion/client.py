"""Async DNS client for upstream queries (mname-client equivalent).

The reference forwards cross-DC queries with mname-client's DnsClient
(``lib/recursion.js:64-79,253-279``): bounded concurrency across the
resolver list, 3s timeout, first NOERROR response wins, and for PTR
fan-out an error threshold equal to the whole resolver list.  This module
reimplements that surface on asyncio with our own wire codec.

Resolvers may be given as ``"ip"`` (port 53) or ``"ip:port"`` (tests,
non-standard deployments).
"""
from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import List, Optional, Sequence, Tuple

from binder_torch.dns.wire import (Message, Rcode, Record,
                                 make_query, wire_walks)
from binder_torch.utils.endpoints import parse_endpoint

DEFAULT_TIMEOUT = 3.0  # lib/recursion.js:257


class UpstreamError(Exception):
    """No upstream produced a usable answer.

    ``got_response`` distinguishes *how* it failed: True means at least
    one upstream returned a DNS response (an error rcode, truncation, a
    malformed body — the peer is alive and said no); False means pure
    transport failure (timeouts, socket death, all breakers open — the
    peer may be dark).  The federation layer serves stale only on the
    latter: a live peer's negative answer must stay a negative answer.
    """

    def __init__(self, msg: str = "", got_response: bool = False) -> None:
        super().__init__(msg)
        self.got_response = got_response


def _parse_resolver(r: str) -> Tuple[str, int]:
    return parse_endpoint(r, 53)


class _PortProto(asyncio.DatagramProtocol):
    """Shared connected-UDP endpoint for one upstream, id-multiplexed:
    qid -> (future, expected question bytes).

    Sharing a socket fixes the local port for the client's lifetime,
    which on its own would cut blind-spoofing entropy to the 16-bit id
    (the connected-socket peer filter does not stop packets forged with
    the resolver's source address).  The lost entropy is restored with
    dns0x20 (draft-vixie-dnsext-dns0x20): every query's qname gets a
    random case mask, and a response only counts if it echoes the
    question section byte-for-byte — anything else is dropped silently
    and the real answer keeps being awaited."""

    def __init__(self) -> None:
        self.pending: dict = {}         # qid -> (fut, expect_q, deadline)
        self.transport = None
        self.case_mismatch_drops = 0
        self.log = logging.getLogger("binder.dnsclient")
        # Timeout handling is a periodic deadline sweep over `pending`
        # instead of one wait_for timer per query: the forwarding hot
        # path creates/cancels zero timer handles, and a sweep over a
        # small dict every ~quarter second is noise.
        self._sweep_handle = None

    def connection_made(self, transport) -> None:
        self.transport = transport

    def _arm_sweep(self, loop, interval: float) -> None:
        if self._sweep_handle is None:
            self._sweep_handle = loop.call_later(interval, self._sweep,
                                                 loop, interval)

    def _sweep(self, loop, interval: float) -> None:
        self._sweep_handle = None
        if self.transport is None or self.transport.is_closing():
            return
        now = loop.time()
        expired = [qid for qid, (_f, _q, dl) in self.pending.items()
                   if dl <= now]
        for qid in expired:
            fut, _q, _dl = self.pending.pop(qid)
            if not fut.done():
                fut.set_exception(WireTimeout("upstream timeout"))
        if self.pending:
            self._arm_sweep(loop, interval)

    def datagram_received(self, data, addr) -> None:
        if len(data) < 12:
            return
        entry = self.pending.get((data[0] << 8) | data[1])
        if entry is None:
            return                      # late/duplicate response
        fut, expect_q, _deadline = entry
        if fut.done():
            return
        # verbatim question echo (id + 0x20 case mask) or it's not ours
        if data[12:12 + len(expect_q)] != expect_q:
            # either a spoof attempt or an 0x20-incompatible upstream
            # (one that case-normalizes the echoed question): surface it,
            # rate-limited, or every lookup is an undiagnosable timeout
            self.case_mismatch_drops += 1
            n = self.case_mismatch_drops
            if n & (n - 1) == 0:        # 1, 2, 4, 8, ...
                self.log.warning(
                    "dropping upstream response with mismatched question "
                    "echo (dns0x20); %d dropped on this socket so far "
                    "(0x20-incompatible upstream, or spoofed traffic)", n)
            return
        del self.pending[(data[0] << 8) | data[1]]
        # validated raw bytes (id + verbatim question echo); decoding is
        # deferred to the consumer — the splice path (recursion.py)
        # forwards the wire without ever building record objects.
        # Arrival stamp rides the future: the gap between this moment
        # and the done-callback running is event-loop wait, the half of
        # recursive latency the attribution layer must separate from
        # the upstream RTT (recursion._complete reads it back).
        fut.binder_recv_t = time.monotonic()
        fut.set_result(bytes(data))

    def _fail_all(self, exc) -> None:
        for fut, _q, _dl in self.pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self.pending.clear()
        if self._sweep_handle is not None:
            self._sweep_handle.cancel()
            self._sweep_handle = None

    def error_received(self, exc) -> None:
        # ICMP errors carry no query attribution on a connected socket;
        # everything in flight to this upstream is dead
        self._fail_all(exc)

    def connection_lost(self, exc) -> None:
        self._fail_all(exc or ConnectionError("upstream socket closed"))


def _close_transport(proto: "_PortProto") -> None:
    """Close a pooled transport; if its event loop is already gone,
    release the underlying socket fd directly."""
    if proto.transport is None:
        return
    try:
        proto.transport.close()
    except Exception:  # noqa: BLE001 — owning loop closed
        sock = proto.transport.get_extra_info("socket")
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass


class DnsClient:
    """Queries a set of upstream resolvers with bounded concurrency.

    One connected UDP socket is kept per upstream and shared by every
    in-flight query (id-multiplexed) — per-query socket creation would
    dominate the forwarding path's cost and churn ephemeral ports."""

    #: encoded-query templates kept per (name, qtype) — forwarders
    #: re-ask the same names continuously, and make_query+encode per
    #: forward costs more than the rest of the client path combined
    _TMPL_MAX = 4096

    def __init__(self, concurrency: int = 2,
                 timeout: float = DEFAULT_TIMEOUT,
                 log: Optional[logging.Logger] = None,
                 breakers=None) -> None:
        self.concurrency = concurrency
        self.timeout = timeout
        self.log = log or logging.getLogger("binder.dnsclient")
        # per-peer circuit breakers + latency stats
        # (binder_torch/policy/breaker.py), shared with the owning
        # Recursion: open peers are skipped before any packet is sent,
        # and p95 latency drives the hedged-request stagger in
        # lookup_raw.  None = classic behavior (bare-client tests).
        self.breakers = breakers
        # (host, port) -> (loop, _PortProto); recreated if the transport
        # died or the entry belongs to a previous event loop (tests run
        # several loops in one process)
        self._ports: dict = {}
        self._tmpl: dict = {}
        self._resolver_keys: dict = {}   # "ip:port" -> (host, port)
        # single-flight: concurrent identical lookups collapse onto one
        # upstream exchange (NXNSAttack posture: duplicate pressure must
        # not multiply upstream work).  Keyed by the full lookup shape;
        # the holder future fans the leader's outcome to followers.
        self._inflight: dict = {}
        self._qf_inflight: dict = {}     # (name, qtype, resolver) -> fut
        self.coalesced = 0
        # set by the owning Recursion: the labelled
        # binder_recursion_coalesced_total child
        self.m_coalesced = None

    def _note_coalesced(self) -> None:
        self.coalesced += 1
        if self.m_coalesced is not None:
            self.m_coalesced.inc()

    def _build_wire(self, name: str, qtype: int,
                    qid: int) -> Tuple[bytearray, int]:
        """Query wire for one send: template (cached per name/qtype,
        RD=0, qid 0) + this send's qid + a fresh dns0x20 case mask.
        Returns (wire, qname_end_offset)."""
        key = (name, qtype)
        tmpl = self._tmpl.get(key)
        if tmpl is None:
            tmpl = make_query(name, qtype, qid=0, rd=False).encode()
            if len(self._tmpl) >= self._TMPL_MAX:
                self._tmpl.pop(next(iter(self._tmpl)))
            self._tmpl[key] = tmpl
        wire = bytearray(tmpl)
        wire[0] = qid >> 8
        wire[1] = qid & 0xFF
        # dns0x20: random case mask over the qname's alpha bytes (the
        # encoder emits lowercase; a fresh query's qname sits at offset
        # 12, uncompressed); the response must echo these exact bytes.
        # One getrandbits call covers the whole name.
        mask = random.getrandbits(256)
        off = 12
        while wire[off] != 0:
            ll = wire[off]
            for i in range(off + 1, off + 1 + ll):
                if 0x61 <= wire[i] <= 0x7A and (mask >> (i - 12)) & 1:
                    wire[i] -= 0x20
            off += 1 + ll
        return wire, off

    async def _get_port(self, host: str, port: int) -> _PortProto:
        loop = asyncio.get_running_loop()
        entry = self._ports.get((host, port))
        if entry is not None:
            e_loop, proto = entry
            if (e_loop is loop and proto.transport is not None
                    and not proto.transport.is_closing()):
                return proto
            _close_transport(proto)     # dead or from a previous loop
            self._ports.pop((host, port), None)
        transport, proto = await loop.create_datagram_endpoint(
            _PortProto, remote_addr=(host, port))
        # a concurrent first query may have created the port while we
        # awaited; keep the stored one and release ours, or every
        # 100-way PTR fan-out would leak sockets
        entry = self._ports.get((host, port))
        if entry is not None and entry[0] is loop \
                and entry[1].transport is not None \
                and not entry[1].transport.is_closing():
            transport.close()
            return entry[1]
        self._ports[(host, port)] = (loop, proto)
        return proto

    def case_mismatch_drops(self) -> int:
        """Upstream responses dropped for a mismatched dns0x20 question
        echo, summed across the pooled ports (peer-health
        introspection; the per-socket counters live on _PortProto)."""
        return sum(proto.case_mismatch_drops
                   for _e_loop, proto in self._ports.values())

    def close(self) -> None:
        for (_e_loop, proto) in self._ports.values():
            _close_transport(proto)
        self._ports.clear()

    def prune(self, keep: "set") -> None:
        """Close pooled sockets for upstreams no longer in the resolver
        set (long-lived processes see resolver churn; without pruning,
        one fd per address ever seen accumulates).  In-flight sockets
        are kept — the next prune after they drain gets them."""
        for key in list(self._ports):
            _e_loop, proto = self._ports[key]
            if key not in keep and not proto.pending:
                _close_transport(proto)
                del self._ports[key]

    async def lookup(self, name: str, qtype: int,
                     resolvers: Sequence[str],
                     error_threshold: Optional[int] = None
                     ) -> List[Record]:
        """Return the answers from the first NOERROR upstream response
        (decoded-record spelling; the forwarding hot path uses
        :meth:`lookup_raw` and never builds record objects)."""
        raw = await self.lookup_raw(name, qtype, resolvers,
                                    error_threshold)
        try:
            return Message.decode(raw).answers
        except Exception as e:  # noqa: BLE001 — malformed upstream bytes
            raise UpstreamError(f"bad upstream response: {e}")

    async def lookup_raw(self, name: str, qtype: int,
                         resolvers: Sequence[str],
                         error_threshold: Optional[int] = None
                         ) -> bytes:
        """Single-flight wrapper over :meth:`_lookup_raw_uncoalesced`:
        concurrent identical lookups (same name, type, resolver set and
        threshold) share ONE upstream exchange — the first caller runs
        the real dispatch, everyone else awaits its outcome.  Failures
        propagate to all waiters; a follower's cancellation never
        cancels the leader's exchange (shield)."""
        key = (name, qtype, tuple(resolvers), error_threshold)
        holder = self._inflight.get(key)
        if holder is not None and not holder.done():
            self._note_coalesced()
            return await asyncio.shield(holder)
        loop = asyncio.get_running_loop()
        holder = loop.create_future()
        # followers may never materialize: retrieve the exception so an
        # all-failed lookup with zero followers doesn't warn at GC
        holder.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None)
        self._inflight[key] = holder
        try:
            raw = await self._lookup_raw_uncoalesced(
                name, qtype, resolvers, error_threshold)
        except BaseException as e:
            if not holder.done():
                holder.set_exception(e)
            raise
        else:
            if not holder.done():
                holder.set_result(raw)
            return raw
        finally:
            if self._inflight.get(key) is holder:
                del self._inflight[key]

    async def _lookup_raw_uncoalesced(
            self, name: str, qtype: int, resolvers: Sequence[str],
            error_threshold: Optional[int] = None) -> bytes:
        """Return the first NOERROR upstream response as validated raw
        wire bytes.

        Validation is the id-multiplex + dns0x20 verbatim question echo
        (\\_PortProto) plus the header rcode/tc checks here; body
        structure is checked by whoever consumes the bytes (the splice
        walker, or Message.decode on the rebuild path).  Gives up once
        ``error_threshold`` upstreams have failed (default: all of
        them, matching mname-client's behavior of walking the whole
        list).

        Dispatch is breaker-aware and hedged (the serial-timeout fix):
        peers whose circuit breaker is open are dropped before any
        packet moves — an all-open set fails fast with a well-formed
        error instead of hanging — and after the first ``concurrency``
        upstreams, each further upstream is launched when a prior one
        FAILS *or* when the most recent one has been silent past its
        p95-based hedge delay, whichever is first.  A dead-but-
        unopened peer therefore costs one hedge stagger (~tens of ms),
        not the full 3 s timeout the reference pays per dead resolver.
        """
        if not resolvers:
            raise UpstreamError("no upstream resolvers")
        br = self.breakers
        if br is not None:
            usable = br.filter(resolvers)
            if not usable:
                raise UpstreamError(
                    "all upstream breakers open: "
                    + ", ".join(str(r) for r in resolvers[:4]))
            resolvers = usable
        threshold = (len(resolvers) if error_threshold is None
                     else min(error_threshold, len(resolvers)))

        if len(resolvers) == 1:
            # single upstream (the common cross-DC forward): skip the
            # task fan-out machinery entirely
            return await self._lookup_one_raw(name, qtype, resolvers[0])

        errors: List[str] = []
        alive = [False]     # any upstream returned a DNS response
        done_count = [0]
        started = [0]
        loop = asyncio.get_running_loop()
        winner: asyncio.Future = loop.create_future()
        progress = asyncio.Event()   # set on every per-resolver failure

        async def one(resolver: str) -> None:
            try:
                if winner.done():
                    return
                try:
                    raw = await self._query_one(name, qtype, resolver)
                except Exception as e:  # noqa: BLE001 — any failure
                    # counts against the threshold; an uncounted error
                    # (e.g. a malformed resolver string) would hang
                    # the lookup forever
                    errors.append(f"{resolver}: {e}")
                    progress.set()
                else:
                    alive[0] = True
                    rcode = raw[3] & 0x0F
                    tc = bool(raw[2] & 0x02)
                    if rcode == Rcode.NOERROR and tc:
                        # truncated: retry the same resolver over
                        # TCP before counting it as a failure
                        # (mname-client capability the reference
                        # relies on for large PTR/SRV answer sets,
                        # lib/recursion.js:253-279)
                        try:
                            raw = await self._query_one_tcp(
                                name, qtype, resolver)
                            rcode = raw[3] & 0x0F
                            tc = bool(raw[2] & 0x02)
                        except Exception as e:  # noqa: BLE001
                            errors.append(
                                f"{resolver}: tcp retry: {e}")
                            progress.set()
                            raw = None
                    if (raw is not None
                            and rcode == Rcode.NOERROR and not tc):
                        # full decode before the response can win
                        # the fan-out race: a body-malformed NOERROR
                        # must count as ONE resolver error and let
                        # another upstream win, not fail the lookup.
                        # (The single-upstream fast path skips this
                        # — with no alternative upstream, a decode
                        # failure ends the same way either side.)
                        ok = wire_walks(raw)
                        if ok:
                            try:
                                Message.decode(raw)
                            except Exception:  # noqa: BLE001
                                ok = False
                        if ok:
                            if not winner.done():
                                winner.set_result(raw)
                            return
                        errors.append(f"{resolver}: malformed body")
                        progress.set()
                        raw = None
                    if raw is not None:
                        errors.append(
                            f"{resolver}: "
                            + ("truncated" if tc
                               else f"rcode {Rcode.name(rcode)}"))
                        progress.set()
                if len(errors) >= threshold and not winner.done():
                    winner.set_exception(UpstreamError(
                        "; ".join(errors[-4:]), got_response=alive[0]))
            finally:
                done_count[0] += 1
                if (done_count[0] == len(resolvers)
                        and not winner.done()):
                    winner.set_exception(UpstreamError(
                        "; ".join(errors[-4:]) or "all upstreams failed",
                        got_response=alive[0]))

        burst = min(self.concurrency, len(resolvers))
        tasks = [asyncio.ensure_future(one(r))
                 for r in resolvers[:burst]]
        started[0] = burst
        errors_consumed = 0
        try:
            while started[0] < len(resolvers) and not winner.done():
                progress.clear()
                if len(errors) > errors_consumed:
                    # a prior upstream failed: launch the next one NOW
                    errors_consumed += 1
                else:
                    # hedge: give the most recently launched upstream
                    # its p95 (+headroom) to answer, then stop waiting
                    # for it alone.  No synchronization races here:
                    # failures only land during awaits, and the
                    # clear-check-wait sequence has none between them.
                    hedge = (br.hedge_delay(resolvers[started[0] - 1])
                             if br is not None else None)
                    waiter = asyncio.ensure_future(progress.wait())
                    try:
                        await asyncio.wait(
                            [winner, waiter], timeout=hedge,
                            return_when=asyncio.FIRST_COMPLETED)
                    finally:
                        waiter.cancel()
                    if winner.done():
                        break
                    if len(errors) > errors_consumed:
                        errors_consumed += 1
                tasks.append(asyncio.ensure_future(
                    one(resolvers[started[0]])))
                started[0] += 1
            return await winner
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    def query_future(self, name: str, qtype: int,
                     resolver: str) -> Optional[asyncio.Future]:
        """Zero-coroutine send: build + send the query on the pooled
        port synchronously and return the response future (resolved by
        the shared protocol, timed out by its deadline sweep).  Returns
        None when the pooled port isn't ready (first query to an
        upstream, dead transport) — the caller takes the coroutine path,
        which (re)creates the port."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return None
        key = self._resolver_keys.get(resolver)
        if key is None:
            try:
                key = _parse_resolver(resolver)
            except ValueError:
                return None
            if len(self._resolver_keys) >= self._TMPL_MAX:
                self._resolver_keys.pop(next(iter(self._resolver_keys)))
            self._resolver_keys[resolver] = key
        entry = self._ports.get(key)
        if entry is None:
            return None
        e_loop, proto = entry
        if (e_loop is not loop or proto.transport is None
                or proto.transport.is_closing()):
            return None
        # single-flight on the zero-coroutine path too: a concurrent
        # identical forward reuses the pending wire future — each
        # caller's done-callback splices its own client id into the one
        # shared upstream answer.  (Each completion also records the
        # shared outcome on the breaker; N coalesced queries count as N
        # observations of the same exchange, which slightly overweights
        # it — harmless, and truthful about what clients experienced.)
        qf_key = (name, qtype, resolver)
        cur = self._qf_inflight.get(qf_key)
        if cur is not None and not cur.done():
            self._note_coalesced()
            return cur
        qid = random.getrandbits(16)
        while qid in proto.pending:
            qid = random.getrandbits(16)
        wire, off = self._build_wire(name, qtype, qid)
        fut: asyncio.Future = loop.create_future()
        proto.pending[qid] = (fut, bytes(wire[12:off + 5]),
                              loop.time() + self.timeout)
        self._qf_inflight[qf_key] = fut
        fut.add_done_callback(
            lambda f, k=qf_key:
            self._qf_inflight.pop(k)
            if self._qf_inflight.get(k) is f else None)
        proto._arm_sweep(loop, min(self.timeout / 2, 0.25))
        proto.transport.sendto(wire)
        return fut

    async def _lookup_one_raw(self, name: str, qtype: int,
                              resolver: str) -> bytes:
        """Single-upstream lookup with the same NOERROR/tc-retry policy
        as the fan-out path."""
        try:
            raw = await self._query_one(name, qtype, resolver)
        except Exception as e:  # noqa: BLE001 — same accounting as one()
            raise UpstreamError(f"{resolver}: {e}")
        rcode = raw[3] & 0x0F
        tc = bool(raw[2] & 0x02)
        if rcode == Rcode.NOERROR and tc:
            try:
                raw = await self._query_one_tcp(name, qtype, resolver)
            except Exception as e:  # noqa: BLE001
                # the UDP response arrived: the peer is alive even
                # though its TCP retry failed
                raise UpstreamError(f"{resolver}: tcp retry: {e}",
                                    got_response=True)
            rcode = raw[3] & 0x0F
            tc = bool(raw[2] & 0x02)
        if rcode == Rcode.NOERROR and not tc:
            if wire_walks(raw):
                return raw
            raise UpstreamError(f"{resolver}: malformed body",
                                got_response=True)
        raise UpstreamError(
            f"{resolver}: "
            + ("truncated" if tc else f"rcode {Rcode.name(rcode)}"),
            got_response=True)

    async def _query_one(self, name: str, qtype: int,
                         resolver: str) -> bytes:
        host, port = _parse_resolver(resolver)
        proto = await self._get_port(host, port)
        loop = asyncio.get_running_loop()
        # qid must be unique among this upstream's in-flight queries
        qid = random.getrandbits(16)
        while qid in proto.pending:
            qid = random.getrandbits(16)
        # Forwarded queries must not re-recurse: RD=0 in the template
        # (lib/recursion.js:259-261)
        wire, off = self._build_wire(name, qtype, qid)
        expect_q = bytes(wire[12:off + 5])   # qname + terminator + type/class
        fut: asyncio.Future = loop.create_future()
        proto.pending[qid] = (fut, expect_q, loop.time() + self.timeout)
        proto._arm_sweep(loop, min(self.timeout / 2, 0.25))
        if self.breakers is not None:
            # Breaker feedback rides the FUTURE, not this coroutine: a
            # hedged lookup cancels the losers' driver tasks the moment
            # a winner lands, but the losers' datagrams are still in
            # flight — their true outcome (response vs deadline-sweep
            # timeout) settles the future later, and THAT is what the
            # breaker must see, or a dead peer racing a healthy one
            # would never accumulate the failures that open its
            # breaker.  The pending entry is deliberately left in place
            # on cancellation below; the sweep (or a late response)
            # always settles and removes it within one timeout.
            sent_at = loop.time()

            def _outcome(f: "asyncio.Future",
                         resolver=resolver, sent_at=sent_at) -> None:
                if f.cancelled():
                    return      # outcome unknown: no evidence either way
                if f.exception() is not None:
                    self.breakers.record(resolver, False)
                else:
                    recv_t = getattr(f, "binder_recv_t", None)
                    self.breakers.record(
                        resolver, True,
                        (recv_t if recv_t is not None else loop.time())
                        - sent_at)

            fut.add_done_callback(_outcome)
        try:
            proto.transport.sendto(wire)
            if self.breakers is None:
                return await fut
            # shield: a hedged lookup cancels losing driver TASKS, and
            # a task awaiting a bare future cancels the future with it
            # — which would erase the in-flight query's real outcome.
            # Shielded, the wire future lives on; the deadline sweep
            # (or a late response) settles it, _outcome above records
            # the truth, and the settling path removes the pending
            # entry.
            return await asyncio.shield(fut)
        finally:
            # pop only our own SETTLED entry: after this qid was
            # released (answer delivered / socket failed), another
            # query may have re-used it before this finally ran
            cur = proto.pending.get(qid)
            if cur is not None and cur[0] is fut and fut.done():
                del proto.pending[qid]

    async def _query_one_tcp(self, name: str, qtype: int,
                             resolver: str) -> bytes:
        """RFC 1035 §4.2.2 framed query — the truncation fallback."""
        host, port = _parse_resolver(resolver)
        qid = random.randrange(0, 65536)
        query = make_query(name, qtype, qid=qid, rd=False)
        wire = query.encode()

        async def go() -> bytes:
            reader, writer = await asyncio.open_connection(host, port)
            try:
                writer.write(len(wire).to_bytes(2, "big") + wire)
                await writer.drain()
                hdr = await reader.readexactly(2)
                n = int.from_bytes(hdr, "big")
                raw = await reader.readexactly(n)
                if n < 12 or ((raw[0] << 8) | raw[1]) != qid:
                    raise WireTimeout("upstream TCP answer id mismatch")
                return raw
            finally:
                writer.close()
                try:
                    await writer.wait_closed()
                except (ConnectionResetError, BrokenPipeError, OSError):
                    pass

        return await asyncio.wait_for(go(), self.timeout)


class WireTimeout(Exception):
    pass
