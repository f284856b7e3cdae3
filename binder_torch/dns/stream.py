"""TCP stream lane: accept fast path + pipelined coalesced writes.

The stream lane used to run on ``asyncio.start_server``: one protocol,
one StreamReader/StreamWriter pair, and one long-lived task per
connection, with two awaits per query.  For persistent pipelined
clients that overhead amortizes; for the one-shot clients that dominate
real TCP traffic (RFC 1035 §4.2.2 truncation retries, non-keep-alive
stub resolvers) it WAS the serve path — the r05 bench put a fresh
connection at ~137µs (tcp1) and the tc=1 UDP→TCP retry flow at 10.8ms
p50, against a 3µs pipelined serve.

This module replaces that machinery with plain readiness callbacks on
the shared event loop:

- **Accept fast path** — the listener arms ``TCP_DEFER_ACCEPT``, so
  accept-readiness normally fires with the client's first frame already
  in the socket buffer.  The accept callback reads it, serves every
  complete frame through the same native-bulk/raw-lane/generic ladder
  the old protocol used, and answers with one vectored write — accept,
  read, serve, and respond in a single loop iteration, no task, no
  streams.  A one-shot client's close lands as EOF on a later readiness
  callback and tears the state down; only clients that keep sending get
  *promoted* (an accounting state — the serve machinery is already the
  pipelined one).
- **Pipelined write coalescing** — responses produced while draining a
  read chunk, and async completions (the recursion path) landing in the
  same loop tick, are sent as ONE vectored write (``sendmsg``).
  Responses go out as they complete, out of order per RFC 7766 §6.2.1.1
  — a miss never head-of-line-blocks a batch of hits.
- **Hardened connection table** — the write-buffer cap disconnects slow
  readers with an RST (``abort``) so the kernel send buffer is freed
  immediately; half-closed clients (send-then-SHUT_WR is a legitimate
  shape) are held only until their owed responses are written, under a
  bounded grace; mid-frame RSTs shed the connection without touching
  the rest of the table.  Idle enforcement is a single periodic sweep
  owned by :class:`~binder_torch.dns.server.DnsServer` — one timer for
  the whole table, not one per connection.

Every transition feeds :class:`TcpStats`, folded into the
``binder_tcp_*`` Prometheus family at scrape time and surfaced in the
``/status`` ``tcp`` section (docs/observability.md).
"""
from __future__ import annotations

import socket
import struct

from binder_torch.introspect.loopacct import ACCOUNT

#: scatter-gather ceiling per sendmsg (POSIX IOV_MAX is 1024 on Linux);
#: a flush carrying more frames sends the first window and lets the
#: short-write tail logic queue the rest
_IOV_MAX = 1024


def _tcp(callback):
    """``callback`` as one ``tcp`` span of loop accounting a call."""
    return ACCOUNT.wrap("tcp", callback)


class TcpStats:
    """Plain-int counters for the stream lane.  The serve path pays an
    attribute increment; the labelled-metric work happens once per
    scrape when ``BinderServer._fold_engine_counters`` folds the deltas
    into the Prometheus collectors."""

    FIELDS = ("accepts", "fast_serves", "promotions", "oneshot_closes",
              "idle_timeouts", "slow_reader_drops", "coalesced_writes",
              "coalesced_frames", "half_closes", "rst_drops")
    __slots__ = FIELDS

    def __init__(self) -> None:
        for field in self.FIELDS:
            setattr(self, field, 0)

    def snapshot(self) -> dict:
        return {field: getattr(self, field) for field in self.FIELDS}


class TcpConn:
    """One client connection on the stream lane.

    Owned entirely by readiness callbacks; holds no task and no
    coroutine.  The read side reframes RFC 1035 §4.2.2 length-prefixed
    queries and dispatches them through the server's ``_handle_raw``;
    the write side batches frames and enforces the slow-reader cap.
    """

    __slots__ = ("srv", "sock", "fd", "loop", "peer", "src", "buf",
                 "out", "out_nframes", "wbuf", "flush_scheduled",
                 "reader_on", "writer_on", "deadline", "promoted",
                 "served", "q_out", "eof", "closed", "grace", "in_feed",
                 "nodelay")

    def __init__(self, srv, sock, peer, loop) -> None:
        self.srv = srv
        self.sock = sock
        self.fd = sock.fileno()
        self.loop = loop
        self.peer = peer
        self.src = (peer[0], peer[1])
        self.buf = b""
        self.out: list = []          # buffers awaiting the next flush
        self.out_nframes = 0         # response FRAMES those carry (a
        #                              native bulk block is one buffer,
        #                              many frames)
        self.wbuf = None             # bytearray once a write went short
        self.flush_scheduled = False
        self.reader_on = False
        self.writer_on = False
        idle = srv.tcp_idle_timeout
        self.deadline = (loop.time() + idle) if idle else None
        self.promoted = False
        self.served = 0              # complete frames dispatched
        self.q_out = 0               # dispatched frames not yet answered
        self.eof = False
        self.closed = False
        self.grace = None            # half-close drain deadline handle
        self.in_feed = False
        self.nodelay = False

    def start(self) -> None:
        srv = self.srv
        srv._conns.add(self)
        srv._tcp_conns.add(self)
        # DEFER_ACCEPT means accept-readiness normally arrives with the
        # first frame already buffered: serve it NOW, inside the accept
        # callback — a one-shot client's whole visit is one loop
        # iteration (accept → read → serve → vectored write)
        self._on_readable()
        if not self.closed and not self.eof and not self.reader_on:
            self.loop.add_reader(self.fd, _tcp(self._on_readable))
            self.reader_on = True

    # -- read side --

    def _on_readable(self) -> None:
        if self.closed:
            return
        try:
            chunk = self.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            # RST, possibly mid-frame: shed this connection; the rest
            # of the table (and any partial frame state) dies with it
            self.srv.tcp_stats.rst_drops += 1
            self.close()
            return
        if not chunk:
            self._on_eof()
            return
        if self.served and not self.promoted:
            # kept sending after the served first burst: a real
            # pipelining client — account the promotion (the serve
            # machinery is already the pipelined one)
            self.promoted = True
            self.srv.tcp_stats.promotions += 1
            self._arm_nodelay()
        self._feed(chunk)

    def _arm_nodelay(self) -> None:
        """TCP_NODELAY, the moment a SECOND response write becomes
        possible: repeated small framed writes with unacked data are
        exactly the shape Nagle + delayed ACK turn into 40ms stalls.
        A one-shot connection's single write never needs it (Nagle
        sends the first segment immediately), so the accept fast path
        skips the syscall."""
        if self.nodelay:
            return
        self.nodelay = True
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
        except OSError:
            pass

    def _feed(self, chunk: bytes) -> None:
        srv = self.srv
        buf = self.buf + chunk if self.buf else chunk
        off = 0
        dispatched = 0
        self.in_feed = True
        try:
            # native bulk serve first: every complete frame the C
            # cache/zone can answer is served and framed in ONE call;
            # only misses (and frames past the C arena cap) fall
            # through to the per-frame path
            if len(buf) >= 2:
                bulk = srv._serve_frames_bulk(buf, self.src)
                if bulk is not None:
                    resp, consumed, fmisses = bulk
                    # frames in the consumed region (cheap header walk;
                    # the C side already validated the lengths)
                    nblock = 0
                    o = 0
                    while o + 2 <= consumed:
                        o += 2 + ((buf[o] << 8) | buf[o + 1])
                        nblock += 1
                    dispatched += nblock
                    if resp:
                        self.out.append(resp)
                        self.out_nframes += nblock - len(fmisses)
                    for payload in fmisses:
                        self.q_out += 1
                        try:
                            # already declined by the bulk serve: skip
                            # the redundant per-payload fastpath probe
                            srv._handle_raw(payload, self.src, "tcp",
                                            self._send_wire,
                                            fastpath_checked=True)
                        except Exception:
                            srv.log.exception(
                                "unhandled error processing TCP frame "
                                "from %s", self.peer[0])
                    off = consumed
                    if resp and srv.fastpath_log_flush is not None:
                        try:
                            srv.fastpath_log_flush()
                        except Exception:
                            srv.log.exception(
                                "query-log ring drain failed")
            n = len(buf)
            while n - off >= 2:
                length = (buf[off] << 8) | buf[off + 1]
                if length == 0:
                    # a zero-length frame is never valid DNS (min
                    # header is 12 bytes) and would count as free
                    # deadline progress for a slot-squatting client:
                    # drop the connection outright
                    srv.log.debug(
                        "closing TCP connection from %s: zero-length "
                        "frame", self.peer[0])
                    self.in_feed = False
                    self._flush()
                    self.close()
                    return
                if n - off - 2 < length:
                    break
                self.q_out += 1
                dispatched += 1
                try:
                    srv._handle_raw(buf[off + 2:off + 2 + length],
                                    self.src, "tcp", self._send_wire)
                except Exception:
                    # isolate per frame: a bug on one query must not
                    # abandon the rest of the batch
                    srv.log.exception(
                        "unhandled error processing TCP frame from %s",
                        self.peer[0])
                off += 2 + length
            self.buf = buf[off:] if off else buf
            if dispatched:
                idle = srv.tcp_idle_timeout
                if idle:
                    # only COMPLETE frames advance the idle deadline: a
                    # client trickling bytes gets the same whole-frame
                    # deadline as a silent one
                    self.deadline = self.loop.time() + idle
                self.served += dispatched
                if not self.promoted:
                    srv.tcp_stats.fast_serves += dispatched
        finally:
            self.in_feed = False
        self._flush()

    def _on_eof(self) -> None:
        srv = self.srv
        self.eof = True
        # no more data will arrive; a level-triggered reader would spin
        if self.reader_on:
            try:
                self.loop.remove_reader(self.fd)
            except (OSError, ValueError):
                pass
            self.reader_on = False
        if self.q_out == 0 and not self.out and self.wbuf is None:
            self._maybe_finish()
            return
        # half-close with responses still owed (send-then-SHUT_WR is a
        # legitimate RFC 7766 client shape): serve them out under a
        # bounded grace, so a query that never answers (malformed drop)
        # cannot wedge the slot
        srv.tcp_stats.half_closes += 1
        grace = min(srv.tcp_idle_timeout or 5.0, 5.0)
        self.grace = self.loop.call_later(grace, self.close)

    # -- write side --

    def _send_wire(self, wire: bytes) -> None:
        # one response per dispatched query at most (QueryCtx.responded
        # guards); q_out tracks responses still owed to a half-closed
        # connection
        if self.q_out:
            self.q_out -= 1
        self.send_framed(struct.pack(">H", len(wire)) + wire)

    def send_framed(self, framed: bytes) -> None:
        if self.closed:
            return   # late (async) response to a dead connection: drop
        self.out.append(framed)
        self.out_nframes += 1
        if not self.in_feed and not self.flush_scheduled:
            # async completions (the recursion path): coalesce every
            # response landing in this loop tick into one vectored
            # write — upstream answers arrive in batches, so their
            # completions cluster in one pass
            self.flush_scheduled = True
            self.loop.call_soon(_tcp(self._flush_cb))

    def _flush_cb(self) -> None:
        self.flush_scheduled = False
        self._flush()

    def _count_coalesced(self) -> None:
        """Account one flush batch: a batch carrying more than one
        response frame (vectored write, or a native bulk block) is a
        coalesced write."""
        n = self.out_nframes
        self.out_nframes = 0
        if n > 1:
            stats = self.srv.tcp_stats
            stats.coalesced_writes += 1
            stats.coalesced_frames += n

    def _flush(self) -> None:
        if self.closed:
            return
        out = self.out
        if self.wbuf is not None:
            # a previous write went short; the writability callback
            # owns the socket until the backlog drains
            if out:
                self._count_coalesced()
                wbuf = self.wbuf
                for framed in out:
                    wbuf += framed
                out.clear()
                self._enforce_write_cap()
            return
        if not out:
            self._maybe_finish()
            return
        self._count_coalesced()
        nframes = len(out)
        total = 0
        for framed in out:
            total += len(framed)
        try:
            if nframes == 1:
                sent = self.sock.send(out[0])
            else:
                # past IOV_MAX the kernel rejects the vector outright
                # (EMSGSIZE); the unsent frames fall into the
                # short-write tail below
                sent = self.sock.sendmsg(out[:_IOV_MAX])
        except (BlockingIOError, InterruptedError):
            sent = 0
        except OSError:
            out.clear()
            self.close()
            return
        if sent == total:
            out.clear()
            if self.q_out and not self.nodelay:
                # responses still owed (async handlers in flight): a
                # further write is coming while this one may be unacked
                self._arm_nodelay()
            self._maybe_finish()
            return
        # short write: keep the tail, let writability drain it
        tail = bytearray()
        for framed in out:
            if sent >= len(framed):
                sent -= len(framed)
                continue
            tail += framed[sent:] if sent else framed
            sent = 0
        out.clear()
        self.wbuf = tail
        if not self.writer_on:
            self.loop.add_writer(self.fd, _tcp(self._on_writable))
            self.writer_on = True
        self._enforce_write_cap()

    def _on_writable(self) -> None:
        if self.closed:
            return
        wbuf = self.wbuf
        try:
            sent = self.sock.send(wbuf)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self.close()
            return
        del wbuf[:sent]
        if not wbuf:
            self.wbuf = None
            if self.writer_on:
                try:
                    self.loop.remove_writer(self.fd)
                except (OSError, ValueError):
                    pass
                self.writer_on = False
            if self.out:
                self._flush()
            else:
                self._maybe_finish()

    def _enforce_write_cap(self) -> None:
        """A slow reader is disconnected the moment its unsent backlog
        exceeds ``max_tcp_write_buffer`` — never buffered unboundedly.
        The disconnect is an RST so the kernel's own send buffer (which
        the peer also isn't draining) is freed immediately."""
        srv = self.srv
        if self.wbuf is None or len(self.wbuf) <= srv.max_tcp_write_buffer:
            return
        srv.tcp_stats.slow_reader_drops += 1
        srv.log.warning(
            "TCP client %s not reading responses (>%d bytes queued), "
            "aborting", self.peer[0], srv.max_tcp_write_buffer)
        if srv.recorder is not None:
            srv.recorder.record(
                "tcp-slow-reader", client=self.peer[0],
                queued=len(self.wbuf), cap=srv.max_tcp_write_buffer)
        self.abort()

    # -- teardown --

    def _maybe_finish(self) -> None:
        """Close a half-closed connection once every owed response is
        written; account the one-shot close for never-promoted
        connections (the accept-fast-path's whole population)."""
        if not (self.eof and self.q_out == 0 and not self.out
                and self.wbuf is None):
            return
        if self.served and not self.promoted:
            self.srv.tcp_stats.oneshot_closes += 1
        self.close()

    def abort(self) -> None:
        """RST the connection: SO_LINGER(0) + close drops the queued
        kernel send buffer instead of draining it toward a peer that
        has stopped reading."""
        if not self.closed:
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                     struct.pack("ii", 1, 0))
            except OSError:
                pass
        self.close()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self.grace is not None:
            self.grace.cancel()
            self.grace = None
        if self.reader_on:
            try:
                self.loop.remove_reader(self.fd)
            except (OSError, ValueError):
                pass
            self.reader_on = False
        if self.writer_on:
            try:
                self.loop.remove_writer(self.fd)
            except (OSError, ValueError):
                pass
            self.writer_on = False
        self.srv._conns.discard(self)
        self.srv._tcp_conns.discard(self)
        self.out.clear()
        self.out_nframes = 0
        self.wbuf = None
        try:
            self.sock.close()
        except OSError:
            pass
