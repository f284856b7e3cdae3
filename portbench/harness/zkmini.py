"""The registrar's ZooKeeper client: one session, synchronous ``setData``.

Enough of the public ZooKeeper client protocol (jute framing, the
connect handshake, SETDATA) for the benchmark's churn writer, on the
frozen :mod:`portbench.harness.jute`.  It shares no code with the
program's client.
"""
from __future__ import annotations

import socket
import struct

from portbench.harness import jute


class ZKError(RuntimeError):
    pass


class ZKSession:
    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout_ms: int = 30000):
        self.sock = socket.create_connection((host, port), timeout=10)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send(jute.i32(0) + jute.i64(0) + jute.i32(timeout_ms)
                   + jute.i64(0) + jute.buffer(b"\x00" * 16))
        buf = jute.Buf(self._recv())
        buf.i32()
        buf.i32()
        if buf.i64() == 0:
            raise ZKError("no session")
        self.xid = 0

    def _send(self, payload: bytes) -> None:
        self.sock.sendall(jute.frame(payload))

    def _recv(self) -> bytes:
        (n,) = struct.unpack(">i", self._exact(4))
        return self._exact(n)

    def _exact(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ZKError("connection closed")
            out += chunk
        return bytes(out)

    def set_data(self, path: str, data: bytes) -> None:
        """``setData(path, data, -1)``; returns once the server has
        acknowledged it."""
        self.xid += 1
        self._send(jute.i32(self.xid) + jute.i32(jute.OpCode.SETDATA)
                   + jute.string(path) + jute.buffer(data) + jute.i32(-1))
        while True:
            buf = jute.Buf(self._recv())
            xid = buf.i32()
            buf.i64()
            err = buf.i32()
            if xid == self.xid:
                break
        if err != jute.Err.OK:
            raise ZKError(f"setData {path}: error {err}")

    def close(self) -> None:
        try:
            self.xid += 1
            self._send(jute.i32(self.xid) + jute.i32(jute.OpCode.CLOSE))
        except OSError:
            pass
        self.sock.close()
