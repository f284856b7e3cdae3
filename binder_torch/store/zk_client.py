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
  triggers an async fetch (getChildren2/getData with watch=1, or an
  exists-watch for nodes that don't exist yet); each WatcherEvent
  re-issues the fetch, re-arming the watch and emitting fresh state to
  the cache (state, not deltas — same contract as FakeStore).
- **Ping**: every timeout/3 to keep the session alive.
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
import logging
import struct
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


#: the loop-accounting activity (introspect/loopacct.py) of the mirror's
#: updates from fetched znodes
_ACT_MIRROR = ACCOUNT.activity("mirror")


def _zk_task(coro) -> asyncio.Task:
    """A task of the session (its read loop, pings and fetches), each of
    its steps one ``zk`` span: the socket reads, the request window and
    the replies' wake-ups besides the frames themselves."""
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
        if collector is not None:
            self.m_sessions = collector.counter(
                "binder_zk_sessions_established",
                "ZooKeeper sessions established (1 + reconnects)").labelled()
            self.m_requests = collector.counter(
                "binder_zk_requests", "ZooKeeper requests sent").labelled()
            self.m_notifications = collector.counter(
                "binder_zk_watch_notifications",
                "ZooKeeper watch notifications received").labelled()
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

        self._writer: Optional[asyncio.StreamWriter] = None
        self._xid = 0
        self._window = asyncio.Semaphore(MAX_IN_FLIGHT)
        self._pending: Dict[int, asyncio.Future] = {}
        self._tasks: List[asyncio.Task] = []
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
        """True while a watched path's fetch is outstanding (the
        mirror's walk, or a change being fetched)."""
        # every task but the connected session's ping loop is a fetch
        return len(self._tasks) > (1 if self._connected else 0)

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
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:  # noqa: BLE001
                pass
        for t in self._tasks + ([self._loop_task] if self._loop_task
                                else []):
            t.cancel()

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
        reader, writer = await asyncio.open_connection(host, port)
        self._writer = writer
        try:
            # ConnectRequest: protoVer, lastZxidSeen, timeout, sessionId,
            # passwd (+ readOnly flag, 3.4+)
            req = (jute.i32(0) + jute.i64(0)
                   + jute.i32(self.session_timeout_ms)
                   + jute.i64(self._session_id)
                   + jute.buffer(self._passwd) + jute.boolean(False))
            writer.write(jute.frame(req))
            await writer.drain()
            resp = await self._read_frame(reader)
        except BaseException:
            self._writer = None
            writer.close()
            raise
        return reader, writer, resp

    async def _run_session(self) -> None:
        host, port = self._servers[self._server_idx]
        reader, writer, raw_resp = await asyncio.wait_for(
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
            self._connected = True
            self._session_transition(
                "connected", f"session 0x{session_id:x} via {host}:{port}")
            if self.m_sessions is not None:
                self.m_sessions.inc()
            self.log.info("zk: session 0x%x established (timeout %dms)",
                          session_id, timeout)

            ping_task = _zk_task(self._ping_loop())
            self._tasks.append(ping_task)
            try:
                # fire session callbacks -> cache rebinds -> watched reads
                for cb in list(self._session_cbs):
                    cb()
                await self._read_loop(reader)
            finally:
                ping_task.cancel()
                self._tasks.remove(ping_task)
                for fut in self._pending.values():
                    if not fut.done():
                        fut.set_exception(ConnectionError("zk: disconnected"))
                self._pending.clear()
        finally:
            self._connected = False
            writer.close()
            try:
                await writer.wait_closed()
            except Exception:  # noqa: BLE001
                pass
            self._writer = None

    async def _read_frame(self, reader: asyncio.StreamReader) -> bytes:
        hdr = await reader.readexactly(4)
        (length,) = struct.unpack(">i", hdr)
        if length < 0 or length > 4 * 1024 * 1024:
            raise ConnectionError(f"zk: bad frame length {length}")
        return await reader.readexactly(length)

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        # Dead-peer detection: our pings elicit replies every timeout/3,
        # so a full session timeout with no frame at all means the server
        # is gone even if TCP hasn't noticed (no FIN/RST on partition).
        read_timeout = max(1.0, self._negotiated_timeout / 1000.0)
        while True:
            try:
                frame = await asyncio.wait_for(self._read_frame(reader),
                                               timeout=read_timeout)
            except asyncio.TimeoutError:
                raise ConnectionError(
                    "zk: no traffic within session timeout; "
                    "assuming dead peer")
            self._dispatch_frame(frame)

    def _dispatch_frame(self, frame: bytes) -> None:
        """One frame the read loop took: a watch event, a ping's
        reply, or a request's reply handed to its waiter."""
        buf = Buf(frame)
        xid = buf.i32()
        if xid == jute.XID_WATCHER_EVENT:
            buf.i64()  # zxid
            buf.i32()  # err
            etype = buf.i32()
            buf.i32()  # keeper state
            path = buf.string()
            self._on_watch_event(etype, path)
            return
        if xid == jute.XID_PING:
            buf.i64()
            buf.i32()
            return
        buf.i64()  # zxid
        err = buf.i32()
        fut = self._pending.pop(xid, None)
        if fut is not None and not fut.done():
            fut.set_result((err, buf))

    async def _ping_loop(self) -> None:
        interval = max(0.5, self._negotiated_timeout / 3000.0)
        while True:
            await asyncio.sleep(interval)
            self._send(jute.XID_PING, OpCode.PING, b"")

    # -- request plumbing --

    @ACCOUNT.spans("zk")
    def _send(self, xid: int, opcode: int, body: bytes) -> None:
        if self._writer is None:
            raise ConnectionError("zk: not connected")
        self._writer.write(jute.frame(jute.i32(xid) + jute.i32(opcode)
                                      + body))

    async def _call(self, opcode: int, body: bytes):
        async with self._window:
            self._xid += 1
            xid = self._xid
            fut = asyncio.get_running_loop().create_future()
            self._pending[xid] = fut
            if self.m_requests is not None:
                self.m_requests.inc()
            self._send(xid, opcode, body)
            return await fut

    # -- public reads (used by the sync machinery and tests) --

    async def get_children(self, path: str,
                           watch: bool = False) -> Optional[List[str]]:
        err, buf = await self._call(OpCode.GETCHILDREN2,
                                    jute.string(path) + jute.boolean(watch))
        if err == Err.NONODE:
            return None
        if err != Err.OK:
            raise ConnectionError(f"zk: getChildren({path}) err {err}")
        n = buf.i32()
        return sorted(buf.string() for _ in range(max(0, n)))

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
        the trailing Stat — its ``numChildren`` is how the shared-watch
        sync learns directory-ness without a getChildren round trip.
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

    # -- watch/sync machinery --

    def _schedule_sync(self, path: str, event: str) -> None:
        if not self._connected:
            return  # the session callback will rebind + resync everything
        task = _zk_task(self._sync(path, event))
        self._tasks.append(task)
        task.add_done_callback(self._tasks.remove)

    async def _sync(self, path: str, event: str) -> None:
        """Fetch current state with a fresh watch and emit it."""
        w = self._watchers.get(path)
        if w is None or not w.has_listeners:
            return
        try:
            if event == "children":
                kids = await self.get_children(path, watch=True)
                if kids is None:
                    await self._arm_exists_watch(path)
                    return
                w.emit("children", kids)
            elif event == "data":
                data = await self.get_data(path, watch=True)
                if data is None:
                    await self._arm_exists_watch(path)
                    return
                w.emit("data", data)
        except (ConnectionError, asyncio.CancelledError):
            pass  # reconnect path will resync

    # -- shared-watch sync (mirror-bound paths, no per-path watcher) --

    def _schedule_shared(self, path: str, want: str) -> None:
        if not self._connected or self._shared_nodes is None:
            return  # the session callback will rebind + resync everything
        task = _zk_task(self._sync_shared(path, want))
        self._tasks.append(task)
        task.add_done_callback(self._tasks.remove)

    def _shared_node(self, path: str):
        nodes = self._shared_nodes
        if nodes is None:
            return None
        return nodes.get(self._path_domain(path))

    async def _sync_shared(self, path: str, want: str) -> None:
        """Fetch current state with fresh watches and deliver it to the
        mirror node the path maps to (dropped if it was unbound since).

        ``bind`` is the full pass: one watched getData whose Stat
        decides whether a watched getChildren follows — only for nodes
        that have children now, or whose record is a container type
        (dict-shaped, e.g. a service) and so may grow children later.
        Host leaves — the million-name bulk — stop at the data watch.
        """
        node = self._shared_node(path)
        if node is None:
            return
        try:
            if want == "children":
                kids = await self.get_children(path, watch=True)
                if kids is None:
                    await self._arm_exists_watch(path)
                    return
                _mirror_apply(node, node.on_children_changed, kids)
                return
            res = await self.get_data2(path, watch=True)
            if res is None:
                await self._arm_exists_watch(path)
                return
            data, stat = res
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
            if stat["numChildren"] > 0 or type(node.rec) is not tuple:
                kids = await self.get_children(path, watch=True)
                if kids is not None:
                    _mirror_apply(node, node.on_children_changed, kids)
        except (ConnectionError, asyncio.CancelledError):
            pass  # reconnect path will resync

    async def _arm_exists_watch(self, path: str) -> None:
        if path in self._exists_watch:
            return
        self._exists_watch.add(path)
        try:
            if await self.exists(path, watch=True):
                # created between the NONODE and the exists call
                self._exists_watch.discard(path)
                self._resync_created(path)
        except (ConnectionError, asyncio.CancelledError):
            self._exists_watch.discard(path)

    def _resync_created(self, path: str) -> None:
        """A watched path (re)appeared: schedule the full fetch through
        whichever binding mode covers it.  Both schedules are cheap
        no-op tasks when the path has no listener of that kind."""
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
                task = _zk_task(self._arm_exists_watch(path))
                self._tasks.append(task)
                task.add_done_callback(self._tasks.remove)
