"""Faults planted under a run, to show that its check catches them.

Each is handed to :class:`portbench.harness.cell.Run` as ``fault``: the
run then goes on as it would, with the timed path broken underneath, and
its ``correct`` has to come out false.

- :class:`Stale`, the control: the configuration guarantees that an
  acknowledged write reaches every answer within 5 s; here the
  registrar's writes are acknowledged by a second stand-in that the
  deployment does not watch, so the mirror keeps its state unchanged.
- :class:`DropHalf`: half of the questions (by a hash of their name, so
  a retransmission is dropped too) never reach the deployment.
- :class:`Alter`: one answer in sixteen has its last byte changed on its
  way back to the client.

The last two put a relay between the client and the deployment's port;
the relay sends each query on from an address of the client's own /24,
so the deployment's rate limit sees the same prefixes.
"""
from __future__ import annotations

import os
import re
import selectors
import socket
import threading
import zlib

from portbench.harness import procs


class Stale:
    name = "stale"

    def churn_spec(self, spec: dict, tmp: str) -> dict:
        log_path = os.path.join(tmp, "decoy.log")
        proc = procs.spawn(["-m", "portbench.harness.zk_testserver", "0",
                            os.path.join(tmp, "tree.json")], log_path)
        m = procs.wait_line(proc, log_path,
                            re.compile(rb"listening on [\d.]+:(\d+)"),
                            "decoy stand-in", 120)
        return dict(spec, zk_port=int(m.group(1)))

    def front(self, port: int, tmp: str) -> int:
        return port

    def close(self) -> None:
        pass


class Relay:
    """A UDP relay in a thread of this process."""

    def churn_spec(self, spec: dict, tmp: str) -> dict:
        return spec

    def front(self, port: int, tmp: str) -> int:
        self.upstream = ("127.0.0.1", port)
        self.sel = selectors.DefaultSelector()
        self.listen = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.listen.bind(("127.0.0.1", 0))
        self.listen.setblocking(False)
        self.sel.register(self.listen, selectors.EVENT_READ, None)
        self.out = {}          # client address -> upstream socket
        self.stop = threading.Event()
        self.n = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        return self.listen.getsockname()[1]

    def _upstream(self, client):
        s = self.out.get(client)
        if s is None:
            a, b, c, _ = client[0].split(".")
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind((f"{a}.{b}.{c}.2", 0))
            s.connect(self.upstream)
            s.setblocking(False)
            self.sel.register(s, selectors.EVENT_READ, client)
            self.out[client] = s
        return s

    def _run(self) -> None:
        while not self.stop.is_set():
            for key, _ in self.sel.select(0.05):
                sock, client = key.fileobj, key.data
                while True:
                    try:
                        data, addr = sock.recvfrom(65535)
                    except (BlockingIOError, ConnectionRefusedError):
                        break
                    if client is None:
                        if not self.drop(data):
                            self._upstream(addr).send(data)
                    else:
                        self.n += 1
                        self.listen.sendto(self.alter(data), client)

    def close(self) -> None:
        if not hasattr(self, "stop"):
            return
        self.stop.set()
        self.thread.join(timeout=5)
        for s in [self.listen, *self.out.values()]:
            s.close()

    def drop(self, query: bytes) -> bool:
        return False

    def alter(self, reply: bytes) -> bytes:
        return reply


class DropHalf(Relay):
    name = "drop_half"

    def drop(self, query: bytes) -> bool:
        return zlib.crc32(query[12:]) % 2 == 0


class Alter(Relay):
    name = "alter"

    def alter(self, reply: bytes) -> bytes:
        if self.n % 16:
            return reply
        return reply[:-1] + bytes([reply[-1] ^ 1])


FAULTS = {f.name: f for f in (Stale, DropHalf, Alter)}
