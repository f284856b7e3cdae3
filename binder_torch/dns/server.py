"""DNS server transport engine (the mname-equivalent, asyncio).

Owns sockets and framing; knows nothing about resolution.  The binder layer
(``binder_torch.server``) attaches ``on_query`` / ``on_after`` hooks, exactly
like the reference attaches handlers to mname's ``query``/``after`` events
(``lib/server.js:471,509``).

Listeners (reference ``lib/server.js:609-653``):
- ``listen_udp``   — datagram per query, truncation per EDNS payload.
- ``listen_tcp``   — RFC 1035 §4.2.2 two-byte length framing, many queries
  per connection.
- ``listen_balancer`` — UNIX-socket backend side of the balancer protocol
  (docs/balancer-protocol.md) carrying original client addresses.

Error tolerance: EHOSTUNREACH (asymmetric routing) is logged and swallowed
(reference ``lib/server.js:593-607``); malformed packets get FORMERR when a
query id is recoverable, else are dropped.
"""
from __future__ import annotations

import asyncio
import errno
import ipaddress
import logging
import os
import socket
import struct
import time
from typing import Callable, List, Optional, Tuple

from binder_torch.dns.query import QueryCtx
from binder_torch.dns.stream import TcpConn, TcpStats
from binder_torch.dns.wire import Message, OPTRecord, Rcode, WireError

try:  # batched recvmmsg/sendmmsg datapath (built by `make -C native`)
    from binder_torch import _binderfastio as _fastio
except ImportError:  # pure-Python fallback: recvfrom/sendto per packet
    _fastio = None

# socket-free serve entry for the TCP / balancer lanes (older builds of
# the extension predate it)
_fp_serve_wire = getattr(_fastio, "fastpath_serve_wire", None)
# bulk TCP-frame serve: every complete frame in a read chunk handled in
# one C call (hits framed back as one writer call; misses surfaced)
_fp_serve_frames = getattr(_fastio, "fastpath_serve_frames", None)
# bulk balancer-frame serve with direct return: every UDP-transport hit
# in a read chunk is answered straight onto the balancer's passed
# client-facing socket via one sendmmsg; misses/control/TCP frames
# surface for the Python lane
_fp_serve_balancer = getattr(_fastio, "fastpath_serve_balancer", None)

# Sentinel an on_query hook may return instead of an awaitable: the
# query is in flight and the HANDLER owns its completion — response AND
# after-hook — via its own future callbacks (the recursion fast path).
# The engine then creates no task for it.
HANDLED_ASYNC = object()

BALANCER_VERSION = 1
BALANCER_HDR = 21  # version + family + transport + 16-byte addr + port
MAX_FRAME = 65_556
TRANSPORT_UDP = 0
TRANSPORT_TCP = 1
# response-only marker: route like UDP but no cache layer may keep it
# (recursion answers belong to another DC's store)
TRANSPORT_UDP_NO_STORE = 2

# Control-frame opcodes (family 0; the transport byte is the opcode).
CTL_GEN = 0          # backend→balancer: generation report
CTL_INVALIDATE = 1   # backend→balancer: dependency-tag invalidate
# Direct-return negotiation, both directions.  Backend→balancer: this
# backend accepts a passed client socket (so the balancer never sends
# the frame first — an old backend would fail the family check below
# and drop the link).  Balancer→backend: rides the sendmsg whose
# SCM_RIGHTS ancillary data carries the client-facing UDP socket.
CTL_DIRECT = 2


def pack_balancer_frame(family: int, addr: str, port: int,
                        payload: bytes,
                        transport: int = TRANSPORT_UDP) -> bytes:
    raw = (ipaddress.IPv4Address(addr).packed + b"\x00" * 12
           if family == 4 else ipaddress.IPv6Address(addr).packed)
    return struct.pack(">IBBB16sH", BALANCER_HDR + len(payload),
                       BALANCER_VERSION, family, transport, raw,
                       port) + payload


def pack_gen_frame(gen: int) -> bytes:
    """Control frame reporting the mirror-cache generation (epoch) to
    the balancer (family 0 marks control; the transport byte is the
    opcode, 0 = generation report; the 16-byte address field carries the
    generation, big-endian, in its first 8 bytes).  An advance tells the
    balancer every cached entry from this backend is stale
    (docs/balancer-protocol.md)."""
    return struct.pack(">IBBB16sH", BALANCER_HDR, BALANCER_VERSION, 0, 0,
                       (gen & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big"), 0)


def pack_invalidate_frame(tag_wire: bytes) -> bytes:
    """Control frame (opcode 1) invalidating one dependency tag at the
    balancer: the payload after the frame header is the lowercased
    qname-wire form of the store name whose answers a mutation changed
    (docs/balancer-protocol.md)."""
    return struct.pack(">IBBB16sH", BALANCER_HDR + len(tag_wire),
                       BALANCER_VERSION, 0, 1, b"\x00" * 16,
                       0) + tag_wire


def pack_direct_frame() -> bytes:
    """Control frame (opcode 2) announcing direct-return capability to
    the balancer.  An old balancer ignores the unknown opcode; a new one
    answers by passing its client-facing UDP socket over SCM_RIGHTS on a
    frame with the same opcode (docs/balancer-protocol.md)."""
    return struct.pack(">IBBB16sH", BALANCER_HDR, BALANCER_VERSION, 0,
                       CTL_DIRECT, b"\x00" * 16, 0)


def unpack_balancer_frame(frame: bytes) -> Tuple[int, str, int, int, bytes]:
    version, family, transport, raw, port = struct.unpack_from(
        ">BBB16sH", frame, 0)
    if version != BALANCER_VERSION:
        raise WireError(f"unknown balancer protocol version {version}")
    if transport not in (TRANSPORT_UDP, TRANSPORT_TCP,
                         TRANSPORT_UDP_NO_STORE):
        raise WireError(f"bad transport {transport}")
    if family == 4:
        addr = str(ipaddress.IPv4Address(raw[:4]))
    elif family == 6:
        addr = str(ipaddress.IPv6Address(raw))
    else:
        raise WireError(f"bad address family {family}")
    return family, addr, port, transport, frame[BALANCER_HDR:]


class BalancerLink:
    """One balancer connection, backend side, on a raw socket (asyncio
    streams would discard the SCM_RIGHTS ancillary data that carries
    the passed client socket).

    Lifecycle: on accept the backend reports its generation, then
    announces direct-return capability (opcode 2).  A capable balancer
    answers with an fd-pass frame whose ancillary data is its
    client-facing UDP socket; from then on every UDP-transport response
    leaves straight for the client from this process — one sendmmsg per
    read chunk on the native fast path — and only TCP-framed responses
    ride the relay.  An old balancer skips the unknown opcode and the
    link stays a pure relay, byte-compatible with the classic protocol.

    Relay writes are append-ordered into one buffer, which preserves
    the causal order the old per-connection lock defended: a response
    computed under pre-mutation data is appended synchronously when its
    send callback runs, before the call_soon that broadcasts the
    generation frame invalidating it can fire.
    """

    #: recv_fds chunk size — large enough that a deep balancer pipeline
    #: drains in few syscalls
    _READ_CHUNK = 256 * 1024
    #: queued-relay cap: a balancer that stops reading is dead weight,
    #: not backpressure — drop the link and let it reconnect
    _MAX_WRITE_BUFFER = 8 * 1024 * 1024

    def __init__(self, engine: "DnsServer", sock: socket.socket,
                 loop) -> None:
        self.engine = engine
        self.sock = sock
        self.loop = loop
        self.fd = sock.fileno()
        self.log = engine.log
        self._rbuf = bytearray()
        self._wbuf = bytearray()
        self._writing = False      # add_writer armed
        self._flush_soon = False   # coalesced relay flush scheduled
        self._fds: list = []       # passed fds awaiting their frame
        self.direct_sock: Optional[socket.socket] = None
        # non-None while a read pass is draining: synchronous direct
        # responses batch into it and flush as one sendmmsg
        self._direct_box: List[Optional[list]] = [None]
        self._direct_late: list = []
        self._closed = False

    def start(self) -> None:
        engine = self.engine
        engine._conns.add(self)
        if engine.gen_source is not None:
            # report our generation immediately so the balancer can
            # cache from the first response; per-link and unconditional
            # (a fresh balancer knows nothing), also seeds the dedupe
            # tracker
            val = engine.gen_source()
            self.send_frame(pack_gen_frame(val))
            engine._last_gen_sent = val
            engine._balancer_writers[self] = True
        if engine.balancer_direct_return:
            self.send_frame(pack_direct_frame())
        self.loop.add_reader(self.fd, self._on_readable)

    # -- reads --

    def _on_readable(self) -> None:
        try:
            data, fds, _flags, _addr = socket.recv_fds(
                self.sock, self._READ_CHUNK, 8)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self.log.error("balancer link read failed: %s", e)
            self.close()
            return
        for fd in fds:
            os.set_inheritable(fd, False)
        self._fds.extend(fds)
        if not data and not fds:
            self.close()   # EOF
            return
        self._rbuf += data
        self._process()

    def _process(self) -> None:
        engine = self.engine
        buf = self._rbuf
        out: list = []
        self._direct_box[0] = out
        try:
            fp = engine.fastpath
            if (fp is not None and _fp_serve_balancer is not None
                    and self.direct_sock is not None
                    and (engine.fastpath_gate is None
                         or engine.fastpath_gate())):
                gen = engine.fastpath_gen() if engine.fastpath_gen else 0
                try:
                    consumed, _served, misses = _fp_serve_balancer(
                        fp, buf, gen, self.direct_sock.fileno())
                except OSError as e:
                    # the passed socket went bad under us: drop direct
                    # mode, the relay lane still works, and the whole
                    # chunk re-parses below (a duplicate UDP reply for
                    # an already-sent hit is harmless — clients dedupe
                    # by query id)
                    self.log.error("direct-return send failed, "
                                   "reverting to relay: %s", e)
                    self._drop_direct()
                else:
                    del buf[:consumed]
                    for frame in misses:
                        if not self._handle_frame(bytes(frame),
                                                  from_native=True):
                            self.close()
                            return
                    log_flush = engine.fastpath_log_flush
                    if log_flush is not None:
                        try:
                            log_flush()
                        except Exception:
                            self.log.exception(
                                "query-log ring drain failed")
            # Python lane: whatever the native pass left behind —
            # everything, when there is no cache / no passed fd / the
            # gate is closed; only a trailing partial or garbage frame
            # otherwise
            while not self._closed:
                if len(buf) < 4:
                    break
                length = int.from_bytes(buf[:4], "big")
                if length < BALANCER_HDR or length > MAX_FRAME:
                    self.log.error("balancer frame length %d out of "
                                   "range", length)
                    self.close()
                    return
                if len(buf) < 4 + length:
                    break
                frame = bytes(buf[4:4 + length])
                del buf[:4 + length]
                if not self._handle_frame(frame):
                    self.close()
                    return
        finally:
            self._direct_box[0] = None
            if out and not self._closed:
                self._send_direct_batch(out)
            self._flush()

    def _handle_frame(self, frame: bytes,
                      from_native: bool = False) -> bool:
        """One complete frame (no length prefix).  Returns False on a
        protocol error that must drop the link."""
        engine = self.engine
        if frame[0] != BALANCER_VERSION:
            engine.log.error("balancer protocol error: unknown balancer "
                             "protocol version %d", frame[0])
            return False
        if frame[1] == 0:
            # control frame from the balancer; unknown opcodes are
            # skipped so the protocol can grow without lockstep
            # upgrades (mirrors the balancer's own consume loop)
            if frame[2] == CTL_DIRECT:
                self._adopt_direct_fd()
            else:
                engine.log.debug("ignoring balancer control opcode %d",
                                 frame[2])
            return True
        try:
            family, addr, port, transport, payload = \
                unpack_balancer_frame(frame)
        except WireError as e:
            engine.log.error("balancer protocol error: %s", e)
            return False
        if transport == TRANSPORT_UDP_NO_STORE:
            # response-only marker; never valid on a request
            engine.log.error("balancer protocol error: "
                             "do-not-store transport on a request")
            return False

        ctx_box: list = []

        def send(wire: bytes, f=family, a=addr, p=port, t=transport,
                 box=ctx_box) -> None:
            if t == TRANSPORT_UDP and self.direct_sock is not None:
                # direct return: the response leaves on the balancer's
                # own client-facing socket and never re-enters the
                # balancer — which also makes the do-not-store marker
                # moot (nothing sees the response to cache it)
                self._send_direct(wire, (a, p))
                return
            t_out = t
            if t == TRANSPORT_UDP and box and box[0].no_store:
                # recursion-produced responses carry the do-not-store
                # marker so the balancer won't cache another DC's data
                # under our generation
                t_out = TRANSPORT_UDP_NO_STORE
            self.send_frame(pack_balancer_frame(f, a, p, wire,
                                                transport=t_out))

        try:
            engine._handle_raw(
                payload, (addr, port), "balancer", send,
                client_transport=("tcp" if transport == TRANSPORT_TCP
                                  else "udp"),
                ctx_box=ctx_box,
                # the native pass already probed the cache for the
                # UDP-transport frames it surfaces; TCP frames bypass
                # it there and still get their serve_wire probe
                fastpath_checked=(from_native
                                  and transport == TRANSPORT_UDP))
        except Exception:
            # isolate per frame: a bug on one query must not drop the
            # link and every other client multiplexed on it
            engine.log.exception("unhandled error processing balancer "
                                 "frame for %s", addr)
        return True

    # -- direct return --

    def _adopt_direct_fd(self) -> None:
        if not self._fds:
            # ancillary data stripped (or a confused balancer): stay on
            # the relay lane, which is always correct
            self.log.warning("balancer fd-pass frame carried no "
                             "descriptor; staying on relay lane")
            return
        fd = self._fds.pop(0)
        self._drop_direct()
        # the passed descriptor shares the balancer's file description:
        # O_NONBLOCK is already set over there and toggling it here
        # would flip it under the balancer too
        self.direct_sock = socket.socket(fileno=fd)
        self.log.info("balancer passed its client socket: UDP "
                      "responses now return directly")

    def _drop_direct(self) -> None:
        if self.direct_sock is not None:
            try:
                self.direct_sock.close()
            except OSError:
                pass
            self.direct_sock = None

    def _send_direct(self, wire: bytes, addr) -> None:
        box = self._direct_box[0]
        if box is not None:
            box.append((wire, addr))
            return
        # late (async-completed) response: coalesce per event-loop pass
        if not self._direct_late:
            self.loop.call_soon(self._flush_direct_late)
        self._direct_late.append((wire, addr))

    def _flush_direct_late(self) -> None:
        out = self._direct_late[:]
        self._direct_late.clear()
        if out and not self._closed:
            self._send_direct_batch(out)

    def _send_direct_batch(self, out: list) -> None:
        sock = self.direct_sock
        if sock is None:
            # direct mode dropped between queueing and flush: the
            # responses are still deliverable over the relay
            for wire, (a, p) in out:
                fam = 6 if ":" in a else 4
                self.send_frame(pack_balancer_frame(fam, a, p, wire))
            return
        if _fastio is not None:
            try:
                sent = _fastio.send_batch(sock.fileno(), out)
                if sent < len(out):
                    # socket buffer full: one retry, then drop (UDP
                    # clients retransmit; blocking would stall every
                    # other client on the loop)
                    sent += _fastio.send_batch(sock.fileno(), out[sent:])
                    if sent < len(out):
                        self.log.debug("dropped %d direct responses "
                                       "(send buffer full)",
                                       len(out) - sent)
            except OSError as e:
                self.log.error("direct-return send failed, reverting "
                               "to relay: %s", e)
                self._drop_direct()
            return
        # pure-Python fallback (extension not built)
        for wire, addr in out:
            try:
                sock.sendto(wire, addr)
            except (BlockingIOError, InterruptedError):
                pass
            except OSError as e:
                self.log.error("direct-return send failed, reverting "
                               "to relay: %s", e)
                self._drop_direct()
                return

    # -- relay / control-frame writes --

    def send_frame(self, data: bytes) -> None:
        if self._closed:
            return
        self._wbuf += data
        if len(self._wbuf) > self._MAX_WRITE_BUFFER:
            self.log.error("balancer link write buffer overflow "
                           "(%d bytes): dropping link", len(self._wbuf))
            self.close()
            return
        if not self._writing and not self._flush_soon:
            # coalesce same-turn frames into one send
            self._flush_soon = True
            self.loop.call_soon(self._flush_scheduled)

    def _flush_scheduled(self) -> None:
        self._flush_soon = False
        self._flush()

    def _flush(self) -> None:
        if self._closed or not self._wbuf:
            return
        try:
            n = self.sock.send(self._wbuf)
        except (BlockingIOError, InterruptedError):
            n = 0
        except OSError:
            self.close()   # balancer went away; responses are lost
            return
        if n:
            del self._wbuf[:n]
        if self._wbuf and not self._writing:
            self._writing = True
            self.loop.add_writer(self.fd, self._flush)
        elif not self._wbuf and self._writing:
            self._writing = False
            self.loop.remove_writer(self.fd)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        engine = self.engine
        engine._balancer_writers.pop(self, None)
        engine._conns.discard(self)
        try:
            self.loop.remove_reader(self.fd)
        except (OSError, ValueError):
            pass
        if self._writing:
            self._writing = False
            try:
                self.loop.remove_writer(self.fd)
            except (OSError, ValueError):
                pass
        for fd in self._fds:
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds.clear()
        self._drop_direct()
        try:
            self.sock.close()
        except OSError:
            pass


class DnsServer:
    #: Bounds for the TCP front (the reference's mname engine had none;
    #: a DNS front end that one slow peer can fd-starve is not done).
    #: Both are per-server and overridable at construction.
    TCP_IDLE_TIMEOUT = 30.0    # seconds without a complete read
    MAX_TCP_CONNS = 1024
    MAX_TCP_WRITE_BUFFER = 256 * 1024   # bytes queued to one client

    def __init__(self, log: Optional[logging.Logger] = None,
                 name: str = "binder",
                 tcp_idle_timeout: Optional[float] = None,
                 max_tcp_conns: Optional[int] = None,
                 max_tcp_write_buffer: Optional[int] = None) -> None:
        self.log = log or logging.getLogger("binder.dns")
        self.name = name
        self.tcp_idle_timeout = (self.TCP_IDLE_TIMEOUT
                                 if tcp_idle_timeout is None
                                 else tcp_idle_timeout)
        self.max_tcp_conns = (self.MAX_TCP_CONNS if max_tcp_conns is None
                              else max_tcp_conns)
        self.max_tcp_write_buffer = (self.MAX_TCP_WRITE_BUFFER
                                     if max_tcp_write_buffer is None
                                     else max_tcp_write_buffer)
        # TCP clients only (balancer links are trusted local peers and
        # excluded from the cap/idle policy); members are TcpConn
        # objects (dns/stream.py)
        self._tcp_conns: set = set()
        # stream-lane counters (accepts, fast serves, promotions,
        # coalesce economics, drop reasons) — folded into binder_tcp_*
        # at scrape time by BinderServer
        self.tcp_stats = TcpStats()
        # cap-refusal accounting: a connect flood at the cap must not
        # become a log flood, so refusals log at most once per interval
        # (with the count of everything refused since the last line)
        self.tcp_cap_refusals = 0
        self._cap_log_last = 0.0
        self._cap_log_pending = 0
        # late (async-completed) UDP responses dropped at a full socket
        # buffer: counted + flight-recorded so drops are VISIBLE at
        # scale instead of a debug line nobody has enabled
        # (binder_udp_late_drops_total; counter child installed by
        # BinderServer, flight events rate-limited to one per window)
        self.udp_late_drops = 0
        self.late_drop_counter = None   # metrics child or None
        self._late_drop_event_last = 0.0
        self.LATE_DROP_EVENT_WINDOW_S = 1.0
        self.on_query: Optional[Callable] = None   # async (QueryCtx) -> None
        self.on_after: Optional[Callable] = None   # sync  (QueryCtx) -> None
        self._udp_socks: List[tuple] = []   # (loop, socket)
        self._tcp_listeners: List[tuple] = []   # (loop, socket)
        self._tcp_sweep_handle = None       # idle-sweep TimerHandle
        self._unix_servers: List[tuple] = []   # (loop, socket, path)
        self._tasks: set = set()
        # live stream connections (TCP clients, balancer links) — must be
        # force-closed on shutdown or Server.wait_closed() blocks on
        # handlers stuck in read
        self._conns: set = set()
        self._decode_cache: dict = {}
        # Raw resolve lane (installed by BinderServer): handles the
        # dominant query shape (single A/IN question) by direct wire
        # assembly, skipping Message decode/encode.  Returns True when it
        # fully handled the packet (response sent, metrics recorded);
        # anything it can't prove simple falls through to the generic
        # path below.
        self.raw_lane: Optional[Callable] = None
        # Native fast-path cache (installed by BinderServer when the
        # _binderfastio extension is built): answer-cache hits are served
        # inside the C drain loop and never surface here.  `fastpath_gen`
        # supplies the current mirror-cache generation per batch;
        # `fastpath_gate` disables the path when every query must reach
        # Python (per-query logging or probes active).
        self.fastpath = None
        self.fastpath_gen: Optional[Callable[[], int]] = None
        self.fastpath_gate: Optional[Callable[[], bool]] = None
        # Drains the native query-log ring (installed by BinderServer in
        # the logged posture); called once per UDP drain pass so ring
        # writes amortize over a whole batch of serves.
        self.fastpath_log_flush: Optional[Callable[[], None]] = None
        # Balancer answer-cache support: control frames let the balancer
        # cache responses with backend-driven invalidation.
        # `gen_source` supplies the current generation/epoch;
        # notify_mutation (wired to MirrorCache.on_mutation) broadcasts
        # it, coalesced to one frame per event-loop turn.
        # notify_invalidate (wired to MirrorCache.on_invalidate)
        # broadcasts per-name invalidate frames (opcode 1), coalesced
        # the same way, so ordinary store churn drops only the affected
        # balancer entries.
        self.gen_source: Optional[Callable[[], int]] = None
        # In-flight query table (introspection): queries whose handler
        # went async — the only ones observable "in flight" from outside
        # (sync completions never leave the dispatch call).  Keyed by
        # id(query); values are the live QueryCtx objects, whose trace
        # ID / phase stamps the status endpoint reads.  The sync hot
        # path pays nothing.
        self.inflight: dict = {}
        # driver task per async in-flight query (same key): overload
        # shedding must be able to cancel the work it refuses, not just
        # answer for it (AdmissionControl.shed_overflow)
        self.inflight_tasks: dict = {}
        # Overload admission control (binder_torch/policy/admission.py),
        # installed by BinderServer: bounds the in-flight table with
        # oldest-shed.  None = unbounded (the classic behavior).
        self.admission = None
        # Response rate limiting (binder_torch/policy/rrl.py), installed
        # by BinderServer: per-client-prefix slip/drop at the UDP
        # ingress, judged before decode.  None = unlimited.
        self.rrl = None
        # Optional flight recorder (installed by BinderServer): the
        # engine's error path records resolver-error events on it.
        self.recorder = None
        # live BalancerLink objects receiving gen/invalidate broadcasts
        # (dict for cheap membership + stable iteration order)
        self._balancer_writers: dict = {}
        self._gen_dirty = False
        self._pending_inval: set = set()    # tag wires awaiting broadcast
        self._last_gen_sent: Optional[int] = None
        # Direct-return negotiation switch: announce the capability on
        # every balancer link so a capable balancer passes its client
        # socket.  BINDER_NO_DIRECT_RETURN=1 keeps the classic pure
        # relay — the A/B lever for tests and the bench's relay arm.
        self.balancer_direct_return = os.environ.get(
            "BINDER_NO_DIRECT_RETURN", "") not in ("1", "true", "yes")

    # -- shared query dispatch --
    #
    # The on_query hook is a *synchronous* callable returning either None
    # (query fully handled — the cache-hit hot path, no task overhead) or
    # an awaitable for work that needs real I/O (the recursion path),
    # which is then driven by a task.

    def _dispatch(self, request: Message, src: Tuple[str, int],
                  protocol: str, send: Callable[[bytes], None],
                  client_transport: Optional[str] = None,
                  raw: Optional[bytes] = None,
                  ctx_box: Optional[list] = None) -> None:
        query = QueryCtx(request, src, protocol, send,
                         client_transport=client_transport, raw=raw)
        if ctx_box is not None:
            # transports that need per-response state (the balancer's
            # do-not-store marker) observe the context through this box
            ctx_box.append(query)
        if self.on_query is None:
            query.set_error(Rcode.NOTIMP)
            query.respond()
            return
        try:
            pending = self.on_query(query)
        except Exception as e:
            self._on_query_error(query, e)
            return
        if pending is None:
            self._after(query)
            return
        self.inflight[id(query)] = query
        if pending is not HANDLED_ASYNC:
            task = asyncio.ensure_future(self._run_async(query, pending))
            self._tasks.add(task)
            self.inflight_tasks[id(query)] = task
            task.add_done_callback(self._tasks.discard)
        # overload admission: past the cap, the OLDEST in-flight query
        # is shed (immediate well-formed REFUSED + task cancel) so the
        # table bounds memory and upstream fan-out — a storm of stuck
        # forwards can never grow it without bound
        adm = self.admission
        if adm is not None and len(self.inflight) > adm.max_inflight:
            adm.shed_overflow(self)

    async def _run_async(self, query: QueryCtx, pending) -> None:
        try:
            await pending
        except Exception as e:
            self._on_query_error(query, e)
            return
        self._after(query)

    def _on_query_error(self, query: QueryCtx, e: Exception) -> None:
        self.inflight.pop(id(query), None)
        self.inflight_tasks.pop(id(query), None)
        if self.recorder is not None:
            self.recorder.record(
                "resolver-error", trace=query.trace_id,
                name=query.name(), qtype=query.qtype_name(),
                error=f"{type(e).__name__}: {e}")
        if isinstance(e, OSError) and e.errno == errno.EHOSTUNREACH:
            # asymmetric routing — log and carry on (lib/server.js:593-607)
            self.log.error("cannot reply to DNS traffic: "
                           "is there asymmetric routing?")
            return
        self.log.error("query handler failed", exc_info=e)
        if not query.responded:
            # drop any half-built (possibly unencodable) answer set —
            # reset_sections keeps the EDNS echo, so the SERVFAIL
            # carries the query's EDNS posture (RFC 6891 conformance,
            # pinned by tests/test_recursion.py)
            query.reset_sections()
            query.set_error(Rcode.SERVFAIL)
            try:
                query.respond()
            except OSError:
                pass

    def _after(self, query: QueryCtx) -> None:
        self.inflight.pop(id(query), None)
        self.inflight_tasks.pop(id(query), None)
        if query.after_done:
            return   # already metered (overload shed answered for it)
        query.after_done = True
        if self.on_after is not None and query.responded:
            try:
                self.on_after(query)
            except Exception:
                self.log.exception("after hook failed")

    # Decode cache: resolvers re-ask the same names constantly, and two
    # queries for the same name/type/flags differ only in the 2-byte id.
    # Keyed on the wire bytes minus the id; entries are treated as
    # immutable templates (the query path never mutates the request).
    _DECODE_CACHE_MAX = 4096
    # legitimate queries are tiny; anything larger is not worth pinning
    _CACHEABLE_QUERY_MAX = 320

    def _decode_query(self, data: bytes) -> Message:
        key = data[2:]
        tmpl = self._decode_cache.get(key)
        if tmpl is not None:
            # hand-rolled shallow copy: dataclasses.replace() re-runs the
            # generated __init__ (every field as kwarg) and costs ~7µs on
            # this exact hot line; Message is a plain (non-slots)
            # dataclass, so a __dict__ copy is equivalent
            new = Message.__new__(Message)
            new.__dict__.update(tmpl.__dict__)
            new.id = struct.unpack_from(">H", data, 0)[0]
            return new
        msg = Message.decode(data)
        if (len(data) <= self._CACHEABLE_QUERY_MAX
                and not msg.qr and msg.opcode == 0
                and len(msg.questions) == 1
                and not msg.answers and not msg.authorities
                # additionals: at most a bare OPT.  EDNS options (cookies,
                # padding) vary per packet, so such wires never repeat —
                # caching them only mints evict-pressure keys
                and len(msg.additionals) <= 1
                and all(isinstance(r, OPTRecord) and not r.has_options
                        for r in msg.additionals)):
            if len(self._decode_cache) >= self._DECODE_CACHE_MAX:
                # evict oldest insertion; wholesale clear() would flush
                # the hot templates along with the cold ones
                self._decode_cache.pop(next(iter(self._decode_cache)))
            self._decode_cache[key] = msg
        return msg

    def _fp_call(self, entry, payload: bytes, src, protocol: str):
        """Shared plumbing for the socket-free native serve entries:
        gate check, generation fetch, logged-posture signature (src
        rides along ONLY when the log ring is armed, so an older
        compiled extension's 3-arg form keeps working), and the
        TypeError/ValueError fallback.  Returns the entry's result, or
        None when the path is unavailable/declined."""
        if (self.fastpath is None or entry is None
                or (self.fastpath_gate is not None
                    and not self.fastpath_gate())):
            return None
        try:
            gen = self.fastpath_gen() if self.fastpath_gen else 0
            if self.fastpath_log_flush is not None:
                return entry(self.fastpath, payload, gen, src[0], src[1],
                             protocol)
            return entry(self.fastpath, payload, gen)
        except (TypeError, ValueError):
            return None

    def _serve_frames_bulk(self, buf: bytes, src):
        """Bulk native TCP-frame serve (``fastpath_serve_frames``):
        every complete frame in ``buf`` the C cache/zone can answer is
        served and framed back as one block.  Returns
        ``(resp_block, consumed, misses)`` or None when the native path
        is unavailable/declined.  The one call site is the stream
        lane's feed loop (dns/stream.py)."""
        return self._fp_call(_fp_serve_frames, buf, src, "tcp")

    def _handle_raw(self, data: bytes, src: Tuple[str, int],
                    protocol: str, send: Callable[[bytes], None],
                    client_transport: Optional[str] = None,
                    ctx_box: Optional[list] = None,
                    fastpath_checked: bool = False) -> None:
        # Response rate limiting at the UDP ingress, before decode and
        # before any lane can spend work on the packet: a flooded
        # prefix gets a TC slip or silence at raw-bytes cost.  While
        # the limiter is hot the fastpath gate (BinderServer) is shut,
        # so every direct-UDP packet surfaces here for judgment.  The
        # TCP lane is exempt by design — a spoofed source cannot
        # complete a handshake, and slips exist to push real clients
        # to TCP.
        rrl = self.rrl
        if rrl is not None and protocol == "udp":
            verdict = rrl.decide(src[0])
            if verdict != rrl.SEND:
                if verdict == rrl.SLIP:
                    resp = rrl.slip_reply(data)
                    if resp is not None:
                        try:
                            send(resp)
                        except OSError:
                            pass
                return
        elif rrl is not None and protocol == "tcp":
            # adaptive-bucket liveness evidence: a TCP query reaching
            # the serve path at all proves a completed handshake — the
            # one thing a spoofed source can never do.  While the
            # limiter is hot the fastpath gate is shut, so exactly the
            # TCP retries that matter (slipped clients coming back)
            # surface here.
            rrl.note_tcp(src[0])
        # Native answer-cache/zone serve for the lanes that have no C
        # drain of their own — TCP and the balancer socket.  Direct-UDP
        # packets reaching here already missed inside fastpath_drain,
        # and TCP payloads surfaced by the bulk frame serve arrive with
        # fastpath_checked=True — a second lookup would be pure waste.
        # Correct for every lane: entries hold only untruncated
        # responses and decline when the assembled wire would exceed
        # the query's advertised ceiling, so a TCP serve can never
        # differ from the Python path's.
        if protocol != "udp" and not fastpath_checked:
            resp = self._fp_call(_fp_serve_wire, data, src, protocol)
            if resp is not None:
                try:
                    send(resp)
                except OSError:
                    pass
                return
        lane = self.raw_lane
        if lane is not None:
            try:
                if lane(data, src, protocol, send, client_transport):
                    return
            except Exception:
                # the lane assembles before it sends, so falling through
                # re-processes the query from scratch safely
                self.log.exception("raw lane failed; using generic path")
        try:
            request = self._decode_query(data)
        except WireError as e:
            self.log.debug("dropping malformed packet from %s: %s", src, e)
            if len(data) >= 2:
                qid = struct.unpack_from(">H", data, 0)[0]
                resp = Message(id=qid, qr=True, rcode=Rcode.FORMERR)
                try:
                    send(resp.encode())
                except OSError:
                    pass
            return
        if request.qr:
            return  # not a query
        self._dispatch(request, src, protocol, send, client_transport,
                       raw=data, ctx_box=ctx_box)

    # -- UDP --

    # Packets drained per readiness callback: bounds event-loop
    # starvation of timers/TCP under sustained UDP flood.
    _UDP_BURST = 128

    async def listen_udp(self, address: str, port: int,
                         announce: bool = True,
                         reuse_port: bool = False) -> int:
        """Direct add_reader recv/send loop.

        asyncio's DatagramTransport costs ~15µs/packet in protocol
        plumbing (buffer management, flow control, call_soon hops) that a
        DNS responder doesn't need; reading the socket ourselves roughly
        doubles single-process throughput.  Send errors are tolerated
        best-effort like the reference (EHOSTUNREACH etc.,
        lib/server.js:593-607) — UDP clients retry.

        ``announce=False`` defers the "service started" log line — the
        ephemeral pair bind (BinderServer.start) must not advertise a
        port it may yet release and redraw: launchers watch that line,
        and one observed CI failure latched a redrawn (dead) port."""
        loop = asyncio.get_running_loop()
        fam = socket.AF_INET6 if ":" in address else socket.AF_INET
        sock = socket.socket(fam, socket.SOCK_DGRAM)
        # no SO_REUSEADDR: UDP has no TIME_WAIT to work around, and on
        # Linux the option would let another local process bind a
        # more-specific address on the same port and divert queries
        # (the reason asyncio removed it for datagram endpoints).
        # SO_REUSEPORT is the deliberate exception — shard mode binds N
        # worker sockets on ONE port so the kernel's 4-tuple hash
        # balances queries across processes (same-UID only, so the
        # hijack concern above does not apply).
        if reuse_port:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        # absorb bursts while the event loop is busy with other work
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
        except OSError:
            pass
        sock.setblocking(False)
        sock.bind((address, port))

        handle_raw = self._handle_raw
        recvfrom = sock.recvfrom
        sendto = sock.sendto
        log = self.log
        burst = self._UDP_BURST

        if _fastio is not None:
            on_readable = self._batched_udp_reader(sock)
        else:
            def on_readable() -> None:
                for _ in range(burst):
                    try:
                        data, addr = recvfrom(65535)
                    except (BlockingIOError, InterruptedError):
                        return
                    except OSError as e:
                        log.error("UDP socket error: %s", e)
                        return

                    def send(wire: bytes, _addr=addr) -> None:
                        try:
                            sendto(wire, _addr)
                        except OSError as e:
                            # best-effort: full socket buffer or
                            # unreachable client must not take down
                            # serving
                            log.debug("UDP send to %s failed: %s",
                                      _addr, e)

                    handle_raw(data, (addr[0], addr[1]), "udp", send)

        loop.add_reader(sock.fileno(), on_readable)
        self._udp_socks.append((loop, sock))
        actual = sock.getsockname()[1]
        if announce:
            self.announce_udp(address, actual)
        return actual

    def announce_udp(self, address: str, port: int) -> None:
        self.log.info("UDP DNS service started on %s:%d", address, port)

    def announce_tcp(self, address: str, port: int) -> None:
        self.log.info("TCP DNS service started on %s:%d", address, port)

    def close_udp_listener(self, port: int) -> None:
        """Tear down one bound UDP listener.  Used by the paired-bind
        retry in ``BinderServer.start``: with ``port=0`` the kernel
        picks the UDP port first, and when that number turns out to be
        occupied on TCP the draw must be released and repeated."""
        for i, (loop, sock) in enumerate(self._udp_socks):
            try:
                bound = sock.getsockname()[1]
            except OSError:
                continue
            if bound == port:
                try:
                    loop.remove_reader(sock.fileno())
                except (OSError, ValueError):
                    pass
                sock.close()
                del self._udp_socks[i]
                return

    def note_late_drops(self, n: int) -> None:
        """Account late (async-completed) UDP responses dropped at a
        full send buffer: monotonic counter + metrics child
        (binder_udp_late_drops_total) + a rate-limited flight event —
        at production scale a silent drop path is an invisible SLO
        leak, so the evidence must be scrapeable."""
        if n <= 0:
            return
        self.udp_late_drops += n
        if self.late_drop_counter is not None:
            self.late_drop_counter.inc(n)
        self.log.debug("dropped %d late UDP responses "
                       "(send buffer full)", n)
        if self.recorder is not None:
            now = time.monotonic()
            if (now - self._late_drop_event_last
                    >= self.LATE_DROP_EVENT_WINDOW_S):
                self._late_drop_event_last = now
                self.recorder.record("udp-late-drop", dropped=n,
                                     total=self.udp_late_drops)

    def _batched_udp_reader(self, sock: socket.socket) -> Callable[[], None]:
        """recvmmsg/sendmmsg datapath (native/fastio/fastio.c).

        Up to 64 datagrams move per kernel crossing instead of one; on the
        single-core deployment unit (the reference scales by adding
        processes, boot/setup.sh:145-149, not threads) per-packet syscall
        overhead is the throughput floor, and batching roughly halves it.
        Responses produced synchronously during the drain are flushed as
        one sendmmsg; responses that arrive later (the recursion path) fall
        back to plain sendto."""
        handle_raw = self._handle_raw
        recv_batch = _fastio.recv_batch
        send_batch = _fastio.send_batch
        fp_drain = getattr(_fastio, "fastpath_drain", None)
        sendto = sock.sendto
        fd = sock.fileno()
        log = self.log
        burst = self._UDP_BURST
        batch_out: List[Optional[list]] = [None]  # non-None while draining
        # RRL sampling credit (see ResponseRateLimiter): a cache-hit
        # flood served entirely inside fastpath_drain would never reach
        # rrl.decide() to trip hot(), so while the gate is open the
        # drain alternates: one recv_batch through Python, decide()
        # charging N tokens per packet, earns the C drain N - 1 packets
        # (served or declined) per packet sampled.  Counted in packets, not readiness events,
        # so a burst that lands in one event is sampled like the same
        # burst spread over many.  The first sample is the Nth packet,
        # as it was the Nth event when the count was in events.
        rrl_credit = [self.rrl.FASTPATH_SAMPLE_EVERY - 1
                      if self.rrl is not None else 0]
        # Late (async-completed) responses — the recursion path — are
        # coalesced per event-loop pass into one sendmmsg instead of a
        # sendto syscall each: upstream answers arrive in batches on the
        # upstream socket, so their completions cluster in one pass.
        late_out: list = []

        def flush_late() -> None:
            out = late_out[:]
            late_out.clear()
            try:
                sent = send_batch(fd, out)
                if sent < len(out):
                    sent += send_batch(fd, out[sent:])
                    if sent < len(out):
                        self.note_late_drops(len(out) - sent)
            except OSError as e:
                log.error("batched late UDP send failed: %s", e)
                self.note_late_drops(len(out))

        def send_late(wire: bytes, addr) -> None:
            if not late_out:
                try:
                    asyncio.get_running_loop().call_soon(flush_late)
                except RuntimeError:
                    try:
                        sendto(wire, addr)
                    except OSError as e:
                        log.debug("UDP send to %s failed: %s", addr, e)
                    return
            late_out.append((wire, addr))

        def on_readable() -> None:
            out: list = []
            batch_out[0] = out
            # fast path on/off is decided once per readiness event — the
            # gate (query-log / probe state) can flip at runtime
            fp = self.fastpath
            use_fp = (fp is not None and fp_drain is not None
                      and (self.fastpath_gate is None
                           or self.fastpath_gate()))
            fp_gen = self.fastpath_gen
            rrl = self.rrl
            try:
                drained = 0
                while drained < burst:
                    served = 0
                    want = 64
                    sample = (use_fp and rrl is not None
                              and rrl_credit[0] <= 0)
                    try:
                        if use_fp and not sample:
                            if rrl is not None:
                                want = min(want, rrl_credit[0])
                            msgs, served = fp_drain(
                                fp, fd, fp_gen() if fp_gen else 0, want)
                            if rrl is not None:
                                rrl_credit[0] -= len(msgs) + served
                        else:
                            msgs = recv_batch(fd, want)
                    except OSError as e:
                        log.error("UDP socket error: %s", e)
                        break
                    if not msgs and not served:
                        break
                    if rrl is not None:
                        every = rrl.FASTPATH_SAMPLE_EVERY
                        rrl.sample_cost = float(every) if sample else 1.0
                        if sample:
                            rrl_credit[0] += (every - 1) * len(msgs)
                    drained += len(msgs) + served
                    for data, addr in msgs:
                        def send(wire: bytes, _addr=addr) -> None:
                            cur = batch_out[0]
                            if cur is not None:
                                cur.append((wire, _addr))
                            else:   # late (async) response
                                send_late(wire, _addr)
                        try:
                            handle_raw(data, addr, "udp", send)
                        except Exception:
                            # isolate per packet, like the plain path's
                            # one-callback-per-packet structure: a bug on
                            # one query must not abandon the drain or the
                            # flush of other clients' responses
                            log.exception("unhandled error processing "
                                          "packet from %s", addr)
                    if len(msgs) + served < want:
                        break
            finally:
                if rrl is not None:
                    rrl.sample_cost = 1.0
                # flush in finally so responses already produced are
                # never lost to an unexpected escape above
                batch_out[0] = None
                if out:
                    try:
                        sent = send_batch(fd, out)
                        if sent < len(out):
                            # socket buffer full: one retry, then drop
                            # (UDP clients retransmit; blocking here
                            # would stall the event loop for every other
                            # client)
                            sent += send_batch(fd, out[sent:])
                            if sent < len(out):
                                log.debug("dropped %d UDP responses "
                                          "(send buffer full)",
                                          len(out) - sent)
                    except OSError as e:
                        log.error("batched UDP send failed: %s", e)
                log_flush = self.fastpath_log_flush
                if use_fp and log_flush is not None:
                    try:
                        log_flush()
                    except Exception:
                        log.exception("query-log ring drain failed")

        return on_readable

    # -- TCP (2-byte length framing, RFC 1035 §4.2.2) --
    #
    # The stream lane runs on a raw accept loop + per-connection
    # readiness callbacks (dns/stream.py TcpConn), not
    # asyncio.start_server: protocol/StreamReader/StreamWriter/task
    # creation per connection was the dominant cost of every fresh
    # connection (tcp1 ~137µs, the tc=1 UDP→TCP retry flow 10.8ms p50
    # in BENCH_r05).  With TCP_DEFER_ACCEPT the first frame normally
    # rides the accept-readiness event, so a one-shot client is served
    # inside the accept callback — one loop iteration end to end.

    #: seconds a dataless connection may sit in the kernel's deferred-
    #: accept queue before being surfaced anyway (Linux rounds up to
    #: SYN-ACK retransmission boundaries).  Short enough that a patient
    #: legitimate client only pays ~1s of first-byte latency; long
    #: enough that connect-flood noise never occupies a connection slot.
    TCP_DEFER_ACCEPT_S = 1
    #: connections accepted per readiness callback — bounds event-loop
    #: starvation under an accept flood, like _UDP_BURST for datagrams
    _ACCEPT_BURST = 64

    async def listen_tcp(self, address: str, port: int,
                         announce: bool = True,
                         reuse_port: bool = False) -> int:
        loop = asyncio.get_running_loop()
        fam = socket.AF_INET6 if ":" in address else socket.AF_INET
        lsock = socket.socket(fam, socket.SOCK_STREAM)
        try:
            lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if reuse_port:
                # shard mode: the kernel spreads incoming connections
                # across every worker listening on this port
                lsock.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_REUSEPORT, 1)
            lsock.setblocking(False)
            lsock.bind((address, port))
            lsock.listen(1024)
            # accept fast path: wake only when the first frame's bytes
            # are already in the socket buffer (guarded: not every
            # platform has the option, and serving must not depend on it)
            try:
                lsock.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_DEFER_ACCEPT,
                                 self.TCP_DEFER_ACCEPT_S)
            except (AttributeError, OSError):
                pass
        except OSError:
            # bind/listen failure (the pair-bind redraw path): leave no
            # socket behind
            lsock.close()
            raise
        loop.add_reader(lsock.fileno(), self._on_accept_ready, lsock,
                        loop)
        self._tcp_listeners.append((loop, lsock))
        if self._tcp_sweep_handle is None and self.tcp_idle_timeout:
            # ONE idle sweep for the whole connection table (vs a timer
            # per connection): granularity T/4 keeps worst-case
            # overstay at ~T/4 past the deadline
            interval = max(0.05, min(self.tcp_idle_timeout / 4.0, 5.0))
            self._tcp_sweep_handle = loop.call_later(
                interval, self._sweep_idle_tcp, loop, interval)
        actual = lsock.getsockname()[1]
        if announce:
            self.announce_tcp(address, actual)
        return actual

    def _on_accept_ready(self, lsock: socket.socket, loop) -> None:
        stats = self.tcp_stats
        for _ in range(self._ACCEPT_BURST):
            try:
                sock, peer = lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                self.log.error("TCP accept failed: %s", e)
                return
            stats.accepts += 1
            if len(self._tcp_conns) >= self.max_tcp_conns:
                # at the connection cap: refuse the newcomer outright
                # (the idle sweep guarantees slots recycle, so a
                # slowloris herd can't pin the front end shut for long)
                self._refuse_at_cap(sock, peer, loop)
                continue
            sock.setblocking(False)
            # (TCP_NODELAY is armed lazily by TcpConn — at promotion,
            # or as soon as a second write becomes possible.  A
            # one-shot client gets exactly one response write on a
            # fresh connection, which Nagle sends immediately anyway,
            # so the fast path skips the syscall.)
            TcpConn(self, sock, peer, loop).start()

    def _refuse_at_cap(self, sock: socket.socket, peer, loop) -> None:
        self.tcp_cap_refusals += 1
        self._cap_log_pending += 1
        now = loop.time()
        if now - self._cap_log_last >= 5.0:
            # a connect flood at the cap must not become a log flood:
            # refusals log at most once per interval, with the count
            self.log.warning(
                "TCP connection cap (%d) reached, refused %d "
                "connection(s) since last report (latest: %s; full "
                "count in binder_tcp_cap_refusals)",
                self.max_tcp_conns, self._cap_log_pending, peer[0])
            self._cap_log_last = now
            self._cap_log_pending = 0
        try:
            sock.close()
        except OSError:
            pass

    def _sweep_idle_tcp(self, loop, interval: float) -> None:
        self._tcp_sweep_handle = None
        now = loop.time()
        for conn in list(self._tcp_conns):
            deadline = conn.deadline
            if deadline is not None and now > deadline:
                self.tcp_stats.idle_timeouts += 1
                self.log.debug("closing idle TCP connection from %s",
                               conn.peer[0])
                conn.close()
        if self._tcp_listeners or self._tcp_conns:
            self._tcp_sweep_handle = loop.call_later(
                interval, self._sweep_idle_tcp, loop, interval)

    def tcp_introspect(self) -> dict:
        """The ``/status`` ``tcp`` section: live connection-table state
        plus the stream-lane counters (docs/observability.md)."""
        out = self.tcp_stats.snapshot()
        out.update({
            "open_conns": len(self._tcp_conns),
            "max_conns": self.max_tcp_conns,
            "idle_timeout_seconds": float(self.tcp_idle_timeout or 0.0),
            "max_write_buffer": self.max_tcp_write_buffer,
            "cap_refusals": self.tcp_cap_refusals,
        })
        return out

    # -- balancer backend socket (docs/balancer-protocol.md) --

    async def listen_balancer(self, path: str, ready) -> None:
        """Serve the balancer on the UNIX socket ``path``.

        The socket is bound at once (a supervisor waiting for the file
        sees the instance up) but listens only once ``ready()`` is
        true: until then the balancer's connects are refused, and it
        keeps its clients on the other backends instead of handing
        them to a server that cannot answer yet."""
        # raw listener + raw per-link sockets, not asyncio streams: the
        # direct-return fd pass arrives as SCM_RIGHTS ancillary data,
        # which the stream protocol machinery silently discards
        loop = asyncio.get_running_loop()
        lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        join_now = ready()
        try:
            lsock.setblocking(False)
            lsock.bind(path)
            if join_now:
                lsock.listen(64)
        except OSError:
            lsock.close()
            raise
        self._unix_servers.append((loop, lsock, path))
        if join_now:
            self._serve_balancer(lsock, path, loop)
            return
        self.log.info("balancer socket %s bound; joining the balancer "
                      "once the mirror holds the zone", path)
        task = loop.create_task(self._join_balancer(ready, lsock, path,
                                                    loop))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _join_balancer(self, ready, lsock: socket.socket, path: str,
                             loop) -> None:
        while not ready():
            await asyncio.sleep(0.1)
        lsock.listen(64)
        self._serve_balancer(lsock, path, loop)

    def _serve_balancer(self, lsock: socket.socket, path: str,
                        loop) -> None:
        loop.add_reader(lsock.fileno(), self._on_balancer_accept, lsock,
                        loop)
        self.log.info("balancer service started on %s", path)

    def _on_balancer_accept(self, lsock: socket.socket, loop) -> None:
        for _ in range(self._ACCEPT_BURST):
            try:
                sock, _peer = lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                self.log.error("balancer accept failed: %s", e)
                return
            sock.setblocking(False)
            BalancerLink(self, sock, loop).start()

    def notify_mutation(self) -> None:
        """Broadcast a fresh generation frame to every balancer link,
        coalesced to one frame per event-loop turn (a session rebuild
        bumps the generation once per mirrored node)."""
        if self._gen_dirty or not self._balancer_writers \
                or self.gen_source is None:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return   # no loop: no balancer link is being served either
        self._gen_dirty = True
        loop.call_soon(self._send_gen_frames)

    def notify_invalidate(self, tag_wires) -> None:
        """Broadcast per-name invalidate frames (opcode 1) to every
        balancer link, coalesced per event-loop turn like the generation
        report — and through the same ordered write path, so a response
        computed under pre-mutation data (whose write task exists before
        the mutation ran) always reaches the balancer before the frame
        that would invalidate it."""
        if not self._balancer_writers:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return   # no loop: no balancer link is being served either
        schedule = not self._pending_inval and not self._gen_dirty
        self._pending_inval.update(tag_wires)
        if schedule and self._pending_inval:
            loop.call_soon(self._send_gen_frames)

    def _send_gen_frames(self) -> None:
        gen_dirty = self._gen_dirty
        self._gen_dirty = False
        pending = self._pending_inval
        self._pending_inval = set()
        frame = b""
        if gen_dirty and self.gen_source is not None:
            # mutations mark dirty but the reported value is the epoch,
            # which only moves on rebuilds — skip the no-op frame the
            # balancer would ignore anyway
            val = self.gen_source()
            if val != self._last_gen_sent:
                frame += pack_gen_frame(val)
                self._last_gen_sent = val
        for tag in sorted(pending):
            frame += pack_invalidate_frame(tag)
        if not frame:
            return
        for link in list(self._balancer_writers):
            # the frame rides the same append-ordered write buffer as
            # relay responses: a response computed under the OLD
            # generation was appended synchronously when its send
            # callback ran — before the call_soon that brought us here
            # could fire — so the balancer never tags a stale response
            # with the new generation
            link.send_frame(frame)

    # -- lifecycle --

    async def quiesce(self, timeout: float = 5.0) -> int:
        """Graceful stop-accepting for the rolling drain-and-replace
        cycle (shard supervisor, docs/operations.md "Rolling
        upgrade"): stop taking NEW work, serve out what is already
        here, then leave the ``SO_REUSEPORT`` group.

        Order matters: the accept paths close first (new TCP clients
        re-hash to the surviving group members immediately), then the
        UDP read loop stops and the datagrams the kernel already
        queued to this socket — which would be silently dropped at
        close — are served out synchronously before the socket closes
        and its hash share moves over.  Finally a bounded wait lets
        async in-flight queries finish and one settle tick lets the
        stream lane's write coalescing flush.  Returns the number of
        in-flight queries still pending at the deadline (0 == clean
        drain)."""
        for loop, lsock in self._tcp_listeners:
            try:
                loop.remove_reader(lsock.fileno())
            except (OSError, ValueError):
                pass
            lsock.close()
        self._tcp_listeners.clear()
        for loop, lsock, _path in self._unix_servers:
            try:
                loop.remove_reader(lsock.fileno())
            except (OSError, ValueError):
                pass
            lsock.close()
        self._unix_servers.clear()
        for loop, sock in self._udp_socks:
            try:
                loop.remove_reader(sock.fileno())
            except (OSError, ValueError):
                pass
            while True:
                try:
                    data, addr = sock.recvfrom(65535)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    break

                def send(wire: bytes, _sock=sock, _addr=addr) -> None:
                    try:
                        _sock.sendto(wire, _addr)
                    except OSError:
                        pass

                self._handle_raw(data, (addr[0], addr[1]), "udp", send)
            # leaving the group NOW keeps the unread window to the
            # microseconds between the drain loop and this close; an
            # async in-flight UDP answer past this point is best-effort
            # (its reply socket is gone), matching the sync-dominated
            # shard serving profile
            sock.close()
        self._udp_socks.clear()
        deadline = time.monotonic() + timeout
        while self.inflight and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        # one settle pass for the per-tick TCP write coalescing
        await asyncio.sleep(0.05)
        return len(self.inflight)

    async def close(self) -> None:
        for loop, sock in self._udp_socks:
            try:
                loop.remove_reader(sock.fileno())
            except (OSError, ValueError):
                pass
            sock.close()
        if self._tcp_sweep_handle is not None:
            self._tcp_sweep_handle.cancel()
            self._tcp_sweep_handle = None
        for loop, lsock in self._tcp_listeners:
            try:
                loop.remove_reader(lsock.fileno())
            except (OSError, ValueError):
                pass
            lsock.close()
        for w in list(self._conns):
            w.close()
        for loop, lsock, path in self._unix_servers:
            try:
                loop.remove_reader(lsock.fileno())
            except (OSError, ValueError):
                pass
            # note: the path is NOT unlinked here — supervisor SIGTERM
            # semantics own the unlink (main.py), matching the old
            # stream-server behavior callers test against
            lsock.close()
        for task in list(self._tasks):
            task.cancel()
        self._udp_socks.clear()
        self._tcp_listeners.clear()
        self._unix_servers.clear()
