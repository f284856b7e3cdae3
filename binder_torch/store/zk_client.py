"""Asyncio ZooKeeper client implementing the StoreClient interface.

The zkstream equivalent (reference ``lib/zk.js:33-39`` creates a zkstream
Client with a 30s session timeout and rebuilds its cache on every
``session`` event).  Speaks the public ZooKeeper 3.4 wire protocol
directly (see ``jute.py``); no external ZK library exists in this image.

Semantics:
- **Session loop**: connect → handshake (resuming the previous session id
  if any) → serve requests/watch events → on disconnect, reconnect with
  backoff.  A handshake that establishes a *new* session (first connect,
  or the old one expired) fires the ``session`` callbacks, which makes
  the mirror cache re-register its whole watch tree
  (``MirrorCache.rebuild``), exactly like the reference's full rebuild on
  zkstream's ``session`` event (``lib/zk.js:45-47,68-76``).  We
  conservatively fire ``session`` on *every* reconnect: ZK watches are
  not replayed for a resumed session unless re-registered, and re-issuing
  the read+watch pass is always safe (watch delivery is state-based here,
  events carry no payload).
- **Watches**: one-shot on the wire.  Attaching a listener to a Watcher
  triggers a fetch (getChildren2/getData with watch=1, or an
  exists-watch for nodes that don't exist yet); each WatcherEvent
  re-issues the fetch, re-arming the watch and emitting fresh state to
  the cache (state, not deltas — same contract as FakeStore).
- **Ping**: every timeout/3 to keep the session alive.
- **Request pipeline**: a request is a frame and a reply callback, no
  task.  ``_pending`` maps each xid in flight to its callback; at most
  ``MAX_IN_FLIGHT`` are in flight, the rest wait in a FIFO and each
  reply moves one of them onto the wire, so requests go out in the
  order they were made.  A fetch is a chain of such callbacks (getData,
  then a getChildren2 where the Stat asks for one, or the exists-watch
  on NONODE) counted by ``syncing()`` until its last reply is handled.
  The frames queued during one loop turn leave in one socket write at
  the next turn (a walk's write carries up to a window of them, a lone
  change's one); each chunk the socket delivers is split into its
  frames, dispatched in wire order, so a watch event keeps its place
  between the replies around it.  ``binder_zk_wire_batches`` and
  ``binder_zk_wire_frames`` count both directions
  (docs/torch-observability.md).  On session loss
  every callback in flight or queued is answered with
  ``CONNECTION_LOSS``; the reconnect's rebuild fetches everything again.
  The coroutines (``get_data``, ``create``, …) are thin wrappers over
  the same pipeline for tools and tests.
- **Shared watches**: when the mirror offers its
  domain→node index via ``bind_source``, the client stops allocating a
  per-path ``_ZKWatcher`` (~190 B/znode) and stops registering two wire
  watches per znode.  Each bound node costs ONE getData(watch=1) whose
  trailing Stat says whether the node has children; the additional
  getChildren2(watch=1) goes only to nodes that have children now or
  could grow them — structural nodes (no record), container records
  (services), anything non-host — while host-record leaves, the ~30:1
  bulk of a production zone, stop at the data watch.  Watch events are
  dispatched straight through the mirror index (path → domain → node).
  At a million names this nearly halves both the server-side watch
  table and the session re-establishment chatter: a rebuild issues
  ~nodes + directories requests instead of 2×nodes.  Residual
  relaxation: a HOST-record leaf that gains a first child is only
  noticed at its next data touch or session rebuild — in this data
  model children hang off service records, which always keep a
  children watch.
"""
from __future__ import annotations

import asyncio
import collections
import logging
import struct
from functools import partial
from typing import Callable, Dict, List, Optional

from binder_torch.introspect.loopacct import ACCOUNT
from binder_torch.store import jute
from binder_torch.store.interface import (SessionStateMixin, StoreClient,
                                        Watcher)
from binder_torch.store.jute import Buf, Err, EventType, OpCode
from binder_torch.utils.endpoints import parse_endpoint
from binder_torch.verify.tracer import trace_id

RECONNECT_DELAY = 1.0
# Connect attempts must be bounded well under the session timeout: a
# blackholed ensemble member (SYNs dropped, no RST) would otherwise
# stall rotation for the kernel's ~2 min connect timeout while the
# session expires.
CONNECT_TIMEOUT = 3.0
# Requests in flight per client.  The mirror's tree walk asks for
# every znode at once; unbounded, a 100k-name zone's burst backs up the
# transport, and asyncio sums the sizes of its buffered chunks on every
# further write, so each write costs O(backlog) and the walk turns
# quadratic.  A window keeps the backlog, and each write, small.
MAX_IN_FLIGHT = 512
#: the error a reply callback gets for a request the session lost
#: (ZooKeeper's own client-side code for it)
CONNECTION_LOSS = -4
MAX_FRAME = 4 * 1024 * 1024

_LEN = struct.Struct(">i")
_REQ_HDR = struct.Struct(">iii")       # length, xid, opcode
_REPLY_HDR = struct.Struct(">iqi")     # xid, zxid, err
_EVENT_TYPE = struct.Struct(">i")      # after the reply header
_EVENT_PATH_OFF = _REPLY_HDR.size + 8  # type and keeper state skipped

#: the loop-accounting activities (introspect/loopacct.py) of the
#: session's wire (a flush, a read chunk's dispatch, the session task's
#: steps) and of the mirror's updates from fetched znodes
_ACT_ZK = ACCOUNT.activity("zk")
_ACT_MIRROR = ACCOUNT.activity("mirror")


def _zk_task(coro) -> asyncio.Task:
    """A task of the session, each of its steps one ``zk`` span."""
    return asyncio.ensure_future(ACCOUNT.steps("zk", coro))


def _mirror_apply(node, handler, arg) -> None:
    """One fetched znode state applied to the mirror, as one ``mirror``
    span: the node's update, ``bump_gen`` and the synchronous
    invalidation fan-out to the mirror's subscribers.  A stall's cause
    is the propagation trace the update opened."""
    ACCOUNT.begin(_ACT_MIRROR)
    try:
        handler(arg)
    finally:
        ACCOUNT.end(lambda: trace_id(getattr(node.cache, "tracer", None)))


def _settle(fut: asyncio.Future, err: int, buf) -> None:
    if not fut.done():
        fut.set_result((err, buf))


def _read_children(buf: Buf) -> List[str]:
    n = buf.i32()
    return sorted(buf.string() for _ in range(max(0, n)))


class _Wire(asyncio.Protocol):
    """One connection's socket: the handshake's reply, then every chunk
    read split into its complete frames and handed to the client in
    wire order, as one ``zk`` span a chunk."""

    def __init__(self, client: "ZKClient",
                 loop: asyncio.AbstractEventLoop) -> None:
        self.client = client
        self.transport: Optional[asyncio.Transport] = None
        self.handshake = loop.create_future()
        self.lost = loop.create_future()
        # why the connection ended, for the session loop's log
        self.error: Optional[ConnectionError] = None
        self.now = loop.time
        self.last_rx = loop.time()
        # a frame cut by the chunk's end, and the bytes it needs
        self._rest = bytearray()
        self._need = 0
        # frames read after the handshake's reply but before the session
        # took the connection over (a resumed session's watch events)
        self.early: List[bytes] = []

    def connection_made(self, transport) -> None:
        self.transport = transport

    def fail(self, error: ConnectionError) -> None:
        if self.error is None:
            self.error = error
        self.transport.abort()

    def data_received(self, data: bytes) -> None:
        ACCOUNT.begin(_ACT_ZK)
        try:
            self._chunk(data)
        finally:
            ACCOUNT.end()

    def _chunk(self, data: bytes) -> None:
        if self._rest:
            self._rest += data
            if len(self._rest) < self._need:
                return
            data = bytes(self._rest)
            self._rest = bytearray()
        frames = []
        off, end = 0, len(data)
        while end - off >= 4:
            (n,) = _LEN.unpack_from(data, off)
            if n < 0 or n > MAX_FRAME:
                self.fail(ConnectionError(f"zk: bad frame length {n}"))
                return
            if end - off - 4 < n:
                break
            frames.append(data[off + 4:off + 4 + n])
            off += 4 + n
        if off < end:
            self._rest = bytearray(data[off:])
            self._need = (4 + _LEN.unpack_from(data, off)[0]
                          if end - off >= 4 else 4)
        if not frames:
            return
        self.last_rx = self.now()
        if not self.handshake.done():
            self.handshake.set_result(frames.pop(0))
        if self.client._wire is self:
            self.client._on_frames(self, frames)
        else:
            self.early.extend(frames)

    def connection_lost(self, exc) -> None:
        if exc is not None and self.error is None:
            self.error = ConnectionError(f"zk: connection lost: {exc}")
        if not self.handshake.done():
            self.handshake.set_exception(
                self.error or ConnectionError("zk: closed in handshake"))
        if not self.lost.done():
            self.lost.set_result(None)


class _ZKWatcher(Watcher):
    """Watcher whose listener attachment triggers a watched fetch."""

    __slots__ = ("_client",)

    def __init__(self, client: "ZKClient", path: str) -> None:
        super().__init__(path)
        self._client = client

    def on(self, event: str, cb: Callable) -> None:
        super().on(event, cb)
        self._client._schedule_sync(self.path, event)

    def bind_node(self, tn) -> None:
        super().bind_node(tn)
        self._client._schedule_sync(self.path, "children")
        self._client._schedule_sync(self.path, "data")


def parse_connect_string(address: str, default_port: int
                         ) -> List[tuple]:
    """``"h1,h2:2182,[::1]:2183"`` → ``[(h1, dp), (h2, 2182), (::1, 2183)]``.

    The multi-host connect string is standard ZooKeeper client surface
    (production binder co-locates with a 3-5 node ensemble,
    reference README.md:36-39); each entry may carry its own port."""
    servers = [parse_endpoint(entry, default_port)
               for entry in address.split(",") if entry.strip()]
    if not servers:
        raise ValueError(f"empty ZooKeeper connect string: {address!r}")
    return servers


class ZKClient(SessionStateMixin, StoreClient):
    def __init__(self, address: str = "127.0.0.1", port: int = 2181,
                 session_timeout_ms: int = 30000,
                 log: Optional[logging.Logger] = None,
                 collector=None, recorder=None) -> None:
        self._init_session_state(recorder)
        self.address = address
        self.port = port
        # ensemble rotation state: reconnects walk the server list round-
        # robin, so losing one server fails over to the next (the session,
        # replicated by ZAB, survives the move)
        self._servers = parse_connect_string(address, port)
        self._server_idx = 0
        self.session_timeout_ms = session_timeout_ms
        self.log = log or logging.getLogger("binder.zk")

        # client observability (zkstream publishes the analogous metrics
        # through the shared artedi collector, reference lib/zk.js:26-38)
        self.m_sessions = self.m_requests = self.m_notifications = None
        self.m_batches = self.m_frames = {}
        if collector is not None:
            self.m_sessions = collector.counter(
                "binder_zk_sessions_established",
                "ZooKeeper sessions established (1 + reconnects)").labelled()
            self.m_requests = collector.counter(
                "binder_zk_requests", "ZooKeeper requests sent").labelled()
            self.m_notifications = collector.counter(
                "binder_zk_watch_notifications",
                "ZooKeeper watch notifications received").labelled()
            batches = collector.counter(
                "binder_zk_wire_batches",
                "ZooKeeper socket writes (dir=send) and read chunks "
                "(dir=recv)")
            frames = collector.counter(
                "binder_zk_wire_frames",
                "ZooKeeper frames in those writes and chunks")
            self.m_batches = {d: batches.labelled({"dir": d})
                              for d in ("send", "recv")}
            self.m_frames = {d: frames.labelled({"dir": d})
                             for d in ("send", "recv")}
            collector.gauge(
                "binder_zk_connected",
                "1 while the ZooKeeper session is live"
            ).set_function(lambda: 1.0 if self._connected else 0.0)
            collector.gauge(
                "binder_zk_outstanding_requests",
                "requests awaiting a ZooKeeper response"
            ).set_function(lambda: len(self._pending))

        self._session_cbs: List[Callable[[], None]] = []
        self._watchers: Dict[str, _ZKWatcher] = {}
        # mirror's domain->node index once bind_source was accepted;
        # None keeps the legacy one-watcher-per-path mode (explicit
        # watcher() consumers — e.g. the federation registry — always
        # use that mode regardless)
        self._shared_nodes = None
        self._connected = False
        self._closed = False
        # whether a connection attempt has ended, with or without a
        # session (``connecting()``)
        self._attempt_ended = False

        self._session_id = 0
        self._passwd = b"\x00" * 16
        self._negotiated_timeout = session_timeout_ms

        # the live session's connection (None between sessions)
        self._wire: Optional[_Wire] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._xid = 0
        # xid -> reply callback(err, buf) of each request in flight
        self._pending: Dict[int, Callable] = {}
        # (opcode, body, callback) of requests waiting for the window
        self._queued: collections.deque = collections.deque()
        # frames queued this loop turn, and the flush that writes them
        self._out: List[bytes] = []
        self._flush_handle: Optional[asyncio.Handle] = None
        self._ping_timer: Optional[asyncio.TimerHandle] = None
        self._deadline_timer: Optional[asyncio.TimerHandle] = None
        self._read_timeout = 1.0
        # fetch chains queued, in flight or re-arming (``syncing()``)
        self._fetches = 0
        self._loop_task: Optional[asyncio.Task] = None
        # paths we watch via exists() because they don't exist yet
        self._exists_watch: set = set()

        try:
            asyncio.get_running_loop()
            self._loop_task = _zk_task(self._session_loop())
        except RuntimeError:
            pass  # caller starts us with start()

    # -- StoreClient interface --

    def start(self) -> None:
        if self._loop_task is None:
            self._loop_task = _zk_task(self._session_loop())

    def on_session(self, cb: Callable[[], None]) -> None:
        self._session_cbs.append(cb)
        if self._connected:
            cb()

    def watcher(self, path: str) -> Watcher:
        w = self._watchers.get(path)
        if w is None:
            w = _ZKWatcher(self, path)
            self._watchers[path] = w
        return w

    # -- shared-watch mode (mirror fast binding, see module docstring) --

    def bind_source(self, nodes) -> bool:
        """Accept the mirror's domain->node index: per-node binds then
        carry no per-node client state, and leaf znodes register one
        wire watch instead of two (the data watch; directory-ness comes
        from that request's trailing Stat)."""
        self._shared_nodes = nodes
        return True

    @staticmethod
    def _path_domain(path: str) -> str:
        """``/com/foo/web`` -> ``web.foo.com`` (inverse of
        ``cache.domain_to_path``)."""
        return ".".join(reversed([p for p in path.split("/") if p])).lower()

    def bind_node(self, path: str, node) -> None:
        if self._shared_nodes is None:
            StoreClient.bind_node(self, path, node)
            return
        self._schedule_shared(path, "bind")

    def unbind_node(self, path: str, node) -> None:
        if self._shared_nodes is None:
            StoreClient.unbind_node(self, path, node)
        # shared mode: nothing to tear down — the mirror already removed
        # the node from its index, so a later one-shot watch event for
        # the path dispatches to nothing and is dropped

    def syncing(self) -> bool:
        """True while a watched path's fetch is queued, in flight or
        re-arming (the mirror's walk, or a change being fetched)."""
        return self._fetches > 0

    def connecting(self) -> bool:
        """True while the first connection attempt is in flight (the
        session loop runs, no attempt has ended, none reached a
        session).  Bounded by CONNECT_TIMEOUT: a refused or unanswered
        ensemble ends it, and the state stays ``never-connected``."""
        return (self._loop_task is not None and not self._closed
                and not self._attempt_ended
                and self._session_state == "never-connected")

    def is_connected(self) -> bool:
        """True only while a live session is established.  The bool
        cannot distinguish "never connected" from "session lost" — use
        ``session_state()`` (SessionStateMixin) for the full state
        machine and ``disconnected_seconds()`` for the exact, measured
        age of a loss."""
        return self._connected

    def close(self) -> None:
        self._session_transition("closed", "close() called")
        self._closed = True
        self._connected = False
        if self._wire is not None:
            self._wire.transport.close()
        if self._loop_task is not None:
            self._loop_task.cancel()

    # -- session loop --

    async def _session_loop(self) -> None:
        while not self._closed:
            err = ""
            try:
                await self._run_session()
            except asyncio.CancelledError:
                return
            except Exception as e:  # noqa: BLE001
                self.log.warning("zk: session error: %s", e)
                err = str(e)
            self._attempt_ended = True
            self._connected = False
            if self._session_state == "connected":
                # a live session just dropped: degraded until the
                # reconnect either resumes it or learns it expired
                self._session_transition("degraded", err or "disconnected")
            # whatever ended the session, try the next ensemble member
            # (reconnecting straight back to a dead server would burn a
            # full RECONNECT_DELAY cycle per retry)
            self._server_idx = (self._server_idx + 1) % len(self._servers)
            if self._closed:
                return
            await asyncio.sleep(RECONNECT_DELAY)

    async def _handshake(self, host: str, port: int):
        """Connect and exchange the ConnectRequest/Response.

        Runs under one CONNECT_TIMEOUT deadline (see _run_session): a
        half-alive ensemble member that accepts TCP but never answers the
        handshake must fail fast so server rotation can advance, instead
        of stalling the session loop on the response read forever.
        """
        loop = asyncio.get_running_loop()
        transport, wire = await loop.create_connection(
            lambda: _Wire(self, loop), host, port)
        try:
            # ConnectRequest: protoVer, lastZxidSeen, timeout, sessionId,
            # passwd (+ readOnly flag, 3.4+)
            req = (jute.i32(0) + jute.i64(0)
                   + jute.i32(self.session_timeout_ms)
                   + jute.i64(self._session_id)
                   + jute.buffer(self._passwd) + jute.boolean(False))
            transport.write(jute.frame(req))
            resp = await wire.handshake
        except BaseException:
            transport.close()
            raise
        return wire, resp

    async def _run_session(self) -> None:
        host, port = self._servers[self._server_idx]
        wire, raw_resp = await asyncio.wait_for(
            self._handshake(host, port), CONNECT_TIMEOUT)
        try:
            resp = Buf(raw_resp)
            resp.i32()  # protocol version
            timeout = resp.i32()
            session_id = resp.i64()
            passwd = resp.buffer() or b"\x00" * 16
            if timeout <= 0 or session_id == 0:
                # session expired server-side: start a fresh one
                self.log.warning("zk: session expired; starting new session")
                self._session_transition("expired",
                                         "session expired server-side")
                self._session_id = 0
                self._passwd = b"\x00" * 16
                return
            self._session_id = session_id
            self._passwd = passwd
            self._negotiated_timeout = timeout
            loop = self._loop = asyncio.get_running_loop()
            self._wire = wire
            self._connected = True
            self._session_transition(
                "connected", f"session 0x{session_id:x} via {host}:{port}")
            if self.m_sessions is not None:
                self.m_sessions.inc()
            self.log.info("zk: session 0x%x established (timeout %dms)",
                          session_id, timeout)

            # Dead-peer detection: our pings elicit replies every
            # timeout/3, so a full session timeout with no frame at all
            # means the server is gone even if TCP hasn't noticed (no
            # FIN/RST on partition).
            self._read_timeout = max(1.0, timeout / 1000.0)
            self._deadline_timer = loop.call_at(
                wire.last_rx + self._read_timeout, self._check_deadline)
            interval = max(0.5, timeout / 3000.0)
            self._ping_timer = loop.call_later(interval, self._ping,
                                               interval)
            try:
                # fire session callbacks -> cache rebinds -> watched reads
                for cb in list(self._session_cbs):
                    cb()
                if wire.early:
                    early, wire.early = wire.early, []
                    self._on_frames(wire, early)
                await wire.lost
                raise wire.error or ConnectionError(
                    "zk: connection closed by server")
            finally:
                self._end_session()
        finally:
            self._connected = False
            wire.transport.close()

    def _end_session(self) -> None:
        """The session's connection is gone: stop its timers and answer
        every request in flight or queued with ``CONNECTION_LOSS``."""
        self._wire = None
        self._connected = False
        for handle in (self._flush_handle, self._ping_timer,
                       self._deadline_timer):
            if handle is not None:
                handle.cancel()
        self._flush_handle = self._ping_timer = self._deadline_timer = None
        self._out = []
        lost = list(self._pending.values())
        lost.extend(cb for _, _, cb in self._queued)
        self._pending.clear()
        self._queued.clear()
        for cb in lost:
            self._answer(cb, CONNECTION_LOSS, None)

    def _check_deadline(self) -> None:
        wire = self._wire
        if wire is None:
            return
        due = wire.last_rx + self._read_timeout
        if self._loop.time() >= due:
            wire.fail(ConnectionError(
                "zk: no traffic within session timeout; "
                "assuming dead peer"))
            return
        self._deadline_timer = self._loop.call_at(due, self._check_deadline)

    def _ping(self, interval: float) -> None:
        if self._wire is None:
            return
        self._send(jute.XID_PING, OpCode.PING, b"")
        self._ping_timer = self._loop.call_later(interval, self._ping,
                                                 interval)

    def _on_frames(self, wire: _Wire, frames: List[bytes]) -> None:
        """One read chunk's frames, in wire order: watch events, ping
        replies, and requests' replies handed to their callbacks."""
        if self.m_batches:
            self.m_batches["recv"].inc()
            self.m_frames["recv"].inc(len(frames))
        pending, queued = self._pending, self._queued
        for frame in frames:
            try:
                xid, _, err = _REPLY_HDR.unpack_from(frame)
                if xid == jute.XID_WATCHER_EVENT:
                    (etype,) = _EVENT_TYPE.unpack_from(frame,
                                                       _REPLY_HDR.size)
                    buf = Buf(frame)
                    buf.off = _EVENT_PATH_OFF
                    path = buf.string()
                    self._on_watch_event(etype, path)
                    continue
            except (struct.error, ValueError) as e:
                wire.fail(ConnectionError(f"zk: bad frame: {e}"))
                return
            if xid == jute.XID_PING:
                continue
            cb = pending.pop(xid, None)
            if cb is None:
                continue
            if queued:
                # the window slot this reply freed goes to the oldest
                # waiting request
                opcode, body, qcb = queued.popleft()
                self._issue(opcode, body, qcb)
            buf = Buf(frame)
            buf.off = _REPLY_HDR.size
            self._answer(cb, err, buf)

    def _answer(self, cb: Callable, err: int, buf) -> None:
        try:
            cb(err, buf)
        except Exception:  # noqa: BLE001 — one bad reply must not end
            self.log.exception("zk: reply handler failed")  # the session

    # -- request plumbing --

    def _send(self, xid: int, opcode: int, body: bytes) -> None:
        """Queue one request's frame for this loop turn's write."""
        if self._wire is None:
            raise ConnectionError("zk: not connected")
        self._out.append(_REQ_HDR.pack(len(body) + 8, xid, opcode) + body)
        if self._flush_handle is None:
            self._flush_handle = self._loop.call_soon(self._flush)

    @ACCOUNT.spans("zk")
    def _flush(self) -> None:
        """Write the frames queued during the last loop turn at once."""
        self._flush_handle = None
        out, self._out = self._out, []
        if not out or self._wire is None:
            return
        self._wire.transport.write(b"".join(out))
        if self.m_batches:
            self.m_batches["send"].inc()
            self.m_frames["send"].inc(len(out))

    def _request(self, opcode: int, body: bytes, cb: Callable) -> None:
        """Send one request, or queue it behind the window; ``cb(err,
        buf)`` gets its reply, or ``CONNECTION_LOSS`` (buf None) when
        the session is lost first or there is none."""
        if self._wire is None:
            cb(CONNECTION_LOSS, None)
        elif self._queued or len(self._pending) >= MAX_IN_FLIGHT:
            self._queued.append((opcode, body, cb))
        else:
            self._issue(opcode, body, cb)

    def _issue(self, opcode: int, body: bytes, cb: Callable) -> None:
        self._xid += 1
        xid = self._xid
        self._pending[xid] = cb
        if self.m_requests is not None:
            self.m_requests.inc()
        self._send(xid, opcode, body)

    async def _call(self, opcode: int, body: bytes):
        fut = asyncio.get_running_loop().create_future()
        self._request(opcode, body, partial(_settle, fut))
        err, buf = await fut
        if err == CONNECTION_LOSS:
            raise ConnectionError("zk: disconnected")
        return err, buf

    # -- public reads (used by tools and tests) --

    async def get_children(self, path: str,
                           watch: bool = False) -> Optional[List[str]]:
        err, buf = await self._call(OpCode.GETCHILDREN2,
                                    jute.string(path) + jute.boolean(watch))
        if err == Err.NONODE:
            return None
        if err != Err.OK:
            raise ConnectionError(f"zk: getChildren({path}) err {err}")
        return _read_children(buf)

    async def get_data(self, path: str,
                       watch: bool = False) -> Optional[bytes]:
        err, buf = await self._call(OpCode.GETDATA,
                                    jute.string(path) + jute.boolean(watch))
        if err == Err.NONODE:
            return None
        if err != Err.OK:
            raise ConnectionError(f"zk: getData({path}) err {err}")
        return buf.buffer() or b""

    async def get_data2(self, path: str, watch: bool = False):
        """getData returning ``(data, stat_dict)`` instead of discarding
        the trailing Stat, for tools and tests that want to see it.
        None when the node does not exist."""
        err, buf = await self._call(OpCode.GETDATA,
                                    jute.string(path) + jute.boolean(watch))
        if err == Err.NONODE:
            return None
        if err != Err.OK:
            raise ConnectionError(f"zk: getData({path}) err {err}")
        data = buf.buffer() or b""
        return data, jute.read_stat(buf)

    async def exists(self, path: str, watch: bool = False) -> bool:
        err, buf = await self._call(OpCode.EXISTS,
                                    jute.string(path) + jute.boolean(watch))
        return err == Err.OK

    # -- writes (registrar-equivalent surface; used by tests/tools) --

    async def create(self, path: str, data: bytes = b"") -> None:
        body = (jute.string(path) + jute.buffer(data)
                + jute.i32(1)          # one ACL
                + jute.i32(31) + jute.string("world") + jute.string("anyone")
                + jute.i32(0))         # flags: persistent
        err, _ = await self._call(OpCode.CREATE, body)
        if err not in (Err.OK, Err.NODEEXISTS):
            raise ConnectionError(f"zk: create({path}) err {err}")

    async def set_data(self, path: str, data: bytes) -> None:
        err, _ = await self._call(OpCode.SETDATA, jute.string(path)
                                  + jute.buffer(data) + jute.i32(-1))
        if err != Err.OK:
            raise ConnectionError(f"zk: setData({path}) err {err}")

    async def delete(self, path: str) -> None:
        err, _ = await self._call(OpCode.DELETE,
                                  jute.string(path) + jute.i32(-1))
        if err not in (Err.OK, Err.NONODE):
            raise ConnectionError(f"zk: delete({path}) err {err}")

    async def mkdirp(self, path: str, data: bytes = b"") -> None:
        parts = [p for p in path.split("/") if p]
        cur = ""
        for i, p in enumerate(parts):
            cur += "/" + p
            await self.create(cur, data if i == len(parts) - 1 else b"")
        if data and await self.get_data(path) != data:
            await self.set_data(path, data)

    # -- watch/sync machinery: fetch chains of reply callbacks --

    def _fetch(self, opcode: int, path: str, cb: Callable) -> None:
        """One watched read of a fetch chain, counted by ``syncing()``
        until ``cb`` has handled its reply (and so issued the chain's
        next read, if any)."""
        self._fetches += 1
        self._request(opcode, jute.string(path) + jute.boolean(True),
                      partial(self._fetched, cb))

    def _fetched(self, cb: Callable, err: int, buf) -> None:
        try:
            cb(err, buf)
        finally:
            self._fetches -= 1

    def _schedule_sync(self, path: str, event: str) -> None:
        """Fetch current state with a fresh watch and emit it."""
        if not self._connected:
            return  # the session callback will rebind + resync everything
        w = self._watchers.get(path)
        if w is None or not w.has_listeners:
            return
        if event == "children":
            self._fetch(OpCode.GETCHILDREN2, path,
                        partial(self._synced, path, w, event))
        elif event == "data":
            self._fetch(OpCode.GETDATA, path,
                        partial(self._synced, path, w, event))

    def _synced(self, path: str, w: _ZKWatcher, event: str, err: int,
                buf) -> None:
        if err == Err.NONODE:
            self._arm_exists_watch(path)
        elif err == Err.OK:
            w.emit(event, _read_children(buf) if event == "children"
                   else buf.buffer() or b"")
        # anything else (a lost session): the reconnect path resyncs

    # -- shared-watch sync (mirror-bound paths, no per-path watcher) --

    def _schedule_shared(self, path: str, want: str) -> None:
        """Fetch current state with fresh watches and deliver it to the
        mirror node the path maps to (dropped if it was unbound).

        ``bind`` is the full pass: one watched getData whose Stat
        decides whether a watched getChildren follows — only for nodes
        that have children now, or whose record is a container type
        (dict-shaped, e.g. a service) and so may grow children later.
        Host leaves — the million-name bulk — stop at the data watch.
        """
        if not self._connected or self._shared_nodes is None:
            return  # the session callback will rebind + resync everything
        node = self._shared_node(path)
        if node is None:
            return
        if want == "children":
            self._fetch(OpCode.GETCHILDREN2, path,
                        partial(self._shared_children, path, node, True))
        else:
            self._fetch(OpCode.GETDATA, path,
                        partial(self._shared_data, path, node))

    def _shared_node(self, path: str):
        nodes = self._shared_nodes
        if nodes is None:
            return None
        return nodes.get(self._path_domain(path))

    def _shared_data(self, path: str, node, err: int, buf) -> None:
        if err == Err.NONODE:
            self._arm_exists_watch(path)
            return
        if err != Err.OK:
            return  # the reconnect path will resync
        data = buf.buffer() or b""
        num_children = jute.stat_num_children(buf)
        _mirror_apply(node, node.on_data_changed, data)
        # Children watch for every node EXCEPT host-record leaves
        # (compact tuples — the ~30:1 bulk of a production zone).
        # Structural nodes (no record: the mirror root and interior
        # path components) and container records (dict-shaped, e.g.
        # services) may grow children at any time, so they keep the
        # watch even while childless; a host leaf that somehow has
        # children is caught by the Stat.  On a plain data touch
        # the Stat doubles as a heal: children that appeared while
        # a node was watch-less get picked up here.
        if num_children > 0 or type(node.rec) is not tuple:
            self._fetch(OpCode.GETCHILDREN2, path,
                        partial(self._shared_children, path, node, False))

    def _shared_children(self, path: str, node, arm: bool, err: int,
                         buf) -> None:
        if err == Err.NONODE:
            if arm:
                self._arm_exists_watch(path)
        elif err == Err.OK:
            _mirror_apply(node, node.on_children_changed,
                          _read_children(buf))

    def _arm_exists_watch(self, path: str) -> None:
        if path in self._exists_watch:
            return
        self._exists_watch.add(path)
        self._fetch(OpCode.EXISTS, path, partial(self._exists_armed, path))

    def _exists_armed(self, path: str, err: int, buf) -> None:
        if err == Err.OK:
            # created between the NONODE and the exists call
            self._exists_watch.discard(path)
            self._resync_created(path)
        elif err == CONNECTION_LOSS:
            self._exists_watch.discard(path)

    def _resync_created(self, path: str) -> None:
        """A watched path (re)appeared: fetch it through whichever
        binding mode covers it (each does nothing when the path has no
        listener of its kind)."""
        self._schedule_sync(path, "children")
        self._schedule_sync(path, "data")
        self._schedule_shared(path, "bind")

    def _on_watch_event(self, etype: int, path: str) -> None:
        if self.m_notifications is not None:
            self.m_notifications.inc()
        self._exists_watch.discard(path)
        if etype == EventType.CREATED:
            self._resync_created(path)
        elif etype == EventType.DATA_CHANGED:
            self._schedule_sync(path, "data")
            self._schedule_shared(path, "data")
        elif etype == EventType.CHILDREN_CHANGED:
            self._schedule_sync(path, "children")
            self._schedule_shared(path, "children")
        elif etype == EventType.DELETED:
            # parent's children watch drives the unbind; re-arm creation
            # for paths something still listens on (for shared mode
            # that's a node still in the mirror index — notably the
            # mirror ROOT, which has no watched parent to notice its
            # re-creation)
            wants = ((path in self._watchers
                      and self._watchers[path].has_listeners)
                     or self._shared_node(path) is not None)
            if wants:
                self._arm_exists_watch(path)
