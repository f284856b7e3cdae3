"""In-process ZooKeeper server speaking the real wire protocol.

Test double for ``zk_client.py`` — lets the ZK client, mirror cache, and
full binder stack be exercised against the actual jute protocol without a
ZooKeeper installation (this image has none).  Implements the subset the
client uses: session handshake/resume/expiry, ping, getChildren2,
getData, exists (all with one-shot watches), create, setData, delete,
closeSession.

Ensemble semantics: several servers constructed over one shared
``ZKEnsembleState`` behave like members of a quorum from the client's
point of view — the tree, the session table, and zxids are common, so a
session established through one member survives a failover to another
(the ZAB-replicated-session behavior of the production co-located
ensemble, reference README.md:36-39).  Watch registrations also live in
the shared state; combined with the client's re-arm-on-reconnect pass
this makes the failover path testable end to end.  Each server only
severs its *own* connections on stop(), exactly like losing one member.

Production deployments point ``store.backend=zookeeper`` at a real
ensemble; this server exists so the protocol path has automated coverage
the reference never had (its tests require a live ZK at 127.0.0.1:2181,
SURVEY §4).
"""
from __future__ import annotations

import asyncio
import logging
import struct
from typing import Dict, Optional, Set, Tuple

from binder_torch.store import jute
from binder_torch.store.jute import Buf, Err, EventType, KeeperState, OpCode


class _Node:
    __slots__ = ("data", "children", "version", "cversion")

    def __init__(self, data: bytes = b"") -> None:
        self.data = data
        self.children: Dict[str, _Node] = {}
        self.version = 0
        self.cversion = 0


class _Session:
    def __init__(self, session_id: int, timeout_ms: int) -> None:
        self.id = session_id
        self.passwd = session_id.to_bytes(8, "big") * 2
        self.timeout_ms = timeout_ms
        self.writer: Optional[asyncio.StreamWriter] = None
        self.expired = False


class ZKEnsembleState:
    """State shared by every member of a test ensemble: the replicated
    tree, the session table, the zxid counter, and watch registrations
    (path -> set of session ids, per watch class)."""

    def __init__(self) -> None:
        self.root = _Node()
        self.sessions: Dict[int, _Session] = {}
        self.next_session = 0x10_0000_0000_0001
        self.zxid = 0
        self.data_watches: Dict[str, Set[int]] = {}
        self.child_watches: Dict[str, Set[int]] = {}
        self.exists_watches: Dict[str, Set[int]] = {}


class ZKTestServer:
    def __init__(self, log: Optional[logging.Logger] = None,
                 state: Optional[ZKEnsembleState] = None) -> None:
        self.log = log or logging.getLogger("binder.zktest")
        # pass the same ZKEnsembleState to several servers to model a
        # quorum; default is a standalone single-member "ensemble"
        self.state = state if state is not None else ZKEnsembleState()
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        # connections accepted by THIS member (stop() must only sever
        # these, not sessions served by sibling members)
        self._conns: Set[asyncio.StreamWriter] = set()
        self.dropped_conns = 0

    # -- lifecycle --

    async def start(self, address: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._conn, address, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        # sever live connections BEFORE wait_closed(): since 3.12 it
        # waits for connection handlers too, and a handler blocked in a
        # read only exits once its writer (same transport) is closed —
        # the old order deadlocked when a client was still connected.
        # Only THIS member's connections are severed; sessions survive in
        # the shared state for the surviving members to resume.
        for w in list(self._conns):
            w.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def expire_session(self, session_id: Optional[int] = None) -> None:
        """Mark session(s) expired and drop their connections — the test
        hook for session-loss behavior."""
        for s in list(self.state.sessions.values()):
            if session_id is None or s.id == session_id:
                s.expired = True
                if s.writer is not None:
                    s.writer.close()

    def drop_connections(self) -> None:
        """Sever this member's connections without expiring sessions
        (network blip)."""
        for w in list(self._conns):
            self.dropped_conns += 1
            w.close()

    # -- tree helpers --

    def _find(self, path: str) -> Optional[_Node]:
        node = self.state.root
        for part in [p for p in path.split("/") if p]:
            node = node.children.get(part)
            if node is None:
                return None
        return node

    @staticmethod
    def _split(path: str) -> Tuple[str, str]:
        parts = [p for p in path.split("/") if p]
        return "/" + "/".join(parts[:-1]), parts[-1]

    # -- watch firing (one-shot, like the real server) --

    def _fire(self, table: Dict[str, Set[int]], path: str,
              etype: int) -> None:
        sessions = table.pop(path, set())
        payload = (jute.i32(jute.XID_WATCHER_EVENT)
                   + jute.i64(self.state.zxid)
                   + jute.i32(0) + jute.i32(etype)
                   + jute.i32(KeeperState.SYNC_CONNECTED)
                   + jute.string(path))
        for sid in sessions:
            s = self.state.sessions.get(sid)
            if s is not None and s.writer is not None and not s.expired:
                try:
                    s.writer.write(jute.frame(payload))
                except Exception:  # noqa: BLE001
                    pass

    # -- connection handling --

    async def _conn(self, reader: asyncio.StreamReader,
                    writer: asyncio.StreamWriter) -> None:
        session: Optional[_Session] = None
        self._conns.add(writer)
        try:
            # handshake
            req = Buf(await self._read_frame(reader))
            req.i32()          # protocol version
            req.i64()          # lastZxidSeen
            timeout = req.i32()
            session_id = req.i64()
            req.buffer()       # passwd
            # (optional readOnly flag ignored)

            if session_id != 0:
                old = self.state.sessions.get(session_id)
                if old is None or old.expired:
                    # expired: per protocol, answer with session 0
                    writer.write(jute.frame(
                        jute.i32(0) + jute.i32(0) + jute.i64(0)
                        + jute.buffer(b"\x00" * 16) + jute.boolean(False)))
                    await writer.drain()
                    return
                session = old
            else:
                session = _Session(self.state.next_session, timeout)
                self.state.next_session += 1
                self.state.sessions[session.id] = session
            session.writer = writer
            writer.write(jute.frame(
                jute.i32(0) + jute.i32(session.timeout_ms)
                + jute.i64(session.id) + jute.buffer(session.passwd)
                + jute.boolean(False)))
            await writer.drain()

            while True:
                buf = Buf(await self._read_frame(reader))
                xid = buf.i32()
                opcode = buf.i32()
                if opcode == OpCode.PING:
                    writer.write(jute.frame(
                        jute.i32(jute.XID_PING) + jute.i64(self.state.zxid)
                        + jute.i32(0)))
                    await writer.drain()
                    continue
                if opcode == OpCode.CLOSE:
                    writer.write(jute.frame(
                        jute.i32(xid) + jute.i64(self.state.zxid) + jute.i32(0)))
                    await writer.drain()
                    return
                err, body = self._handle(session, opcode, buf)
                writer.write(jute.frame(
                    jute.i32(xid) + jute.i64(self.state.zxid) + jute.i32(err)
                    + body))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                ValueError):
            pass
        finally:
            self._conns.discard(writer)
            if session is not None and session.writer is writer:
                session.writer = None
            writer.close()

    async def _read_frame(self, reader: asyncio.StreamReader) -> bytes:
        hdr = await reader.readexactly(4)
        (length,) = struct.unpack(">i", hdr)
        if length < 0 or length > 4 * 1024 * 1024:
            raise ValueError("bad frame")
        return await reader.readexactly(length)

    def _create(self, path: str, data: bytes) -> int:
        parent_path, name = self._split(path)
        parent = self._find(parent_path)
        if parent is None:
            return Err.NONODE
        if name in parent.children:
            return Err.NODEEXISTS
        self.state.zxid += 1
        parent.children[name] = _Node(data)
        parent.cversion += 1
        self._fire(self.state.exists_watches, path, EventType.CREATED)
        self._fire(self.state.child_watches, parent_path,
                   EventType.CHILDREN_CHANGED)
        return Err.OK

    def load(self, nodes) -> None:
        """Create every ``(path, data)`` of ``nodes`` in order, parents
        first, as a client's ``create`` calls would: a bulk seed."""
        for path, data in nodes:
            err = self._create(path, data)
            if err != Err.OK:
                raise ValueError(f"cannot create {path}: error {err}")

    # -- op dispatch --

    def _handle(self, session: _Session, opcode: int,
                buf: Buf) -> Tuple[int, bytes]:
        if opcode == OpCode.GETCHILDREN2 or opcode == OpCode.GETCHILDREN:
            path = buf.string()
            watch = buf.boolean()
            node = self._find(path)
            if node is None:
                if watch:
                    self.state.exists_watches.setdefault(path,
                                                    set()).add(session.id)
                return Err.NONODE, b""
            if watch:
                self.state.child_watches.setdefault(path, set()).add(session.id)
            out = jute.i32(len(node.children))
            for name in sorted(node.children):
                out += jute.string(name)
            if opcode == OpCode.GETCHILDREN2:
                out += jute.pack_stat(version=node.version,
                                      cversion=node.cversion,
                                      data_length=len(node.data),
                                      num_children=len(node.children))
            return Err.OK, out

        if opcode == OpCode.GETDATA:
            path = buf.string()
            watch = buf.boolean()
            node = self._find(path)
            if node is None:
                if watch:
                    self.state.exists_watches.setdefault(path,
                                                    set()).add(session.id)
                return Err.NONODE, b""
            if watch:
                self.state.data_watches.setdefault(path, set()).add(session.id)
            # numChildren must be real: the shared-watch client decides
            # from this stat whether the node is a directory that needs
            # its own children watch (zk_client._shared_data)
            return Err.OK, (jute.buffer(node.data)
                            + jute.pack_stat(version=node.version,
                                             data_length=len(node.data),
                                             num_children=len(node.children)))

        if opcode == OpCode.EXISTS:
            path = buf.string()
            watch = buf.boolean()
            node = self._find(path)
            if node is None:
                if watch:
                    self.state.exists_watches.setdefault(path,
                                                    set()).add(session.id)
                return Err.NONODE, b""
            if watch:
                self.state.data_watches.setdefault(path, set()).add(session.id)
            return Err.OK, jute.pack_stat(version=node.version,
                                          data_length=len(node.data))

        if opcode == OpCode.CREATE:
            path = buf.string()
            err = self._create(path, buf.buffer() or b"")
            return err, jute.string(path) if err == Err.OK else b""

        if opcode == OpCode.SETDATA:
            path = buf.string()
            data = buf.buffer() or b""
            node = self._find(path)
            if node is None:
                return Err.NONODE, b""
            self.state.zxid += 1
            node.data = data
            node.version += 1
            self._fire(self.state.data_watches, path, EventType.DATA_CHANGED)
            return Err.OK, jute.pack_stat(version=node.version,
                                          data_length=len(data))

        if opcode == OpCode.DELETE:
            path = buf.string()
            parent_path, name = self._split(path)
            parent = self._find(parent_path)
            if parent is None or name not in parent.children:
                return Err.NONODE, b""
            if parent.children[name].children:
                return Err.NOTEMPTY, b""
            self.state.zxid += 1
            del parent.children[name]
            parent.cversion += 1
            self._fire(self.state.data_watches, path, EventType.DELETED)
            self._fire(self.state.child_watches, path, EventType.DELETED)
            self._fire(self.state.child_watches, parent_path,
                       EventType.CHILDREN_CHANGED)
            return Err.OK, b""

        self.log.warning("zktest: unsupported opcode %d", opcode)
        return Err.OK, b""


def main() -> None:
    """Run standalone: ``python -m binder_torch.store.zk_testserver
    [port] [tree.json]``, where ``tree.json`` holds ``[path, data]``
    pairs, parents first, loaded before the server listens."""
    import json
    import sys

    async def _run():
        server = ZKTestServer()
        if len(sys.argv) > 2:
            with open(sys.argv[2], encoding="utf-8") as f:
                server.load((path, data.encode())
                            for path, data in json.load(f))
        port = await server.start(
            port=int(sys.argv[1]) if len(sys.argv) > 1 else 2181)
        print(f"zk-testserver listening on 127.0.0.1:{port}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
