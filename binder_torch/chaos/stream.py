"""Stream-lane (TCP) fault clients for the chaos DSL.

The stream lane (accept fast path, coalesced pipelined writes,
slow-reader disconnect) is only trustworthy if misbehaving TCP peers
are injected the same way session loss and upstream packet faults
are.  Three client shapes cover the connection-table hazards:

- ``tcp-slow-reader conns=N queries=M hold_ms=H`` — N connections each
  pipeline M queries with a tiny receive window and never read a byte;
  the server must disconnect each at ``MAX_TCP_WRITE_BUFFER``
  (``binder_tcp_slow_reader_drops``), never buffer unboundedly.
- ``tcp-half-close queries=M`` — send M queries then ``SHUT_WR`` (a
  legitimate RFC 7766 client shape): every owed response must still
  arrive, and the slot must be reclaimed afterwards.
- ``tcp-rst conns=N`` — send a partial frame (header promising more
  bytes than follow) then RST via ``SO_LINGER(0)``: the connection
  table must shed the carcass without wedging.

Every fault is driven against a live server's host/port
(``ChaosDriver(tcp_target=...)``); assertions live in the callers
(tests/test_torch_chaos.py, ``chip_smoke.py``) — this module only
injects.
"""
from __future__ import annotations

import asyncio
import socket
import struct

from binder_torch.dns import Type, make_query

#: per-socket I/O budget: a fault client must never outlive the
#: incident window it was scripted into
_IO_TIMEOUT_S = 5.0


async def run_stream_fault(action: str, host: str, port: int,
                           qname: str, **kwargs) -> None:
    """Dispatch one DSL stream action (the ChaosDriver entry)."""
    if action == "tcp-slow-reader":
        await slow_reader(host, port, qname,
                          conns=int(kwargs.get("conns", 1)),
                          queries=int(kwargs.get("queries", 256)),
                          hold_ms=float(kwargs.get("hold_ms", 1000)))
    elif action == "tcp-half-close":
        await half_close(host, port, qname,
                         queries=int(kwargs.get("queries", 1)))
    elif action == "tcp-rst":
        await rst_mid_frame(host, port,
                            conns=int(kwargs.get("conns", 1)))
    else:
        raise ValueError(f"unknown stream fault {action!r}")


async def slow_reader(host: str, port: int, qname: str, *,
                      conns: int = 1, queries: int = 256,
                      hold_ms: float = 1000.0) -> None:
    """Pipeline queries and never read responses.  The tiny client
    receive window keeps the kernel from absorbing the backlog, so the
    server's write buffer grows toward its cap."""
    loop = asyncio.get_running_loop()
    wire = make_query(qname, Type.A, qid=0, edns_payload=4096).encode()
    frame = struct.pack(">H", len(wire)) + wire
    block = frame * min(64, max(1, queries))
    rounds = max(1, (queries + 63) // 64)
    socks = []
    try:
        for _ in range(max(1, conns)):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
            s.setblocking(False)
            try:
                await asyncio.wait_for(
                    loop.sock_connect(s, (host, port)), _IO_TIMEOUT_S)
            except (OSError, asyncio.TimeoutError):
                s.close()
                continue
            socks.append(s)
        for s in socks:
            try:
                for _ in range(rounds):
                    await asyncio.wait_for(loop.sock_sendall(s, block),
                                           _IO_TIMEOUT_S)
            except (OSError, asyncio.TimeoutError):
                pass   # disconnected (the fault landed) or wedged: done
        await asyncio.sleep(hold_ms / 1000.0)
    finally:
        for s in socks:
            s.close()


async def half_close(host: str, port: int, qname: str, *,
                     queries: int = 1) -> None:
    """Send, SHUT_WR, then keep reading: the legitimate one-shot client
    shape the stream lane must serve out rather than drop."""
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), _IO_TIMEOUT_S)
    except (OSError, asyncio.TimeoutError):
        return
    try:
        for i in range(max(1, queries)):
            wire = make_query(qname, Type.A, qid=i + 1).encode()
            writer.write(struct.pack(">H", len(wire)) + wire)
        await writer.drain()
        writer.write_eof()
        got = 0
        try:
            while got < max(1, queries):
                hdr = await asyncio.wait_for(reader.readexactly(2),
                                             _IO_TIMEOUT_S)
                await asyncio.wait_for(
                    reader.readexactly(int.from_bytes(hdr, "big")),
                    _IO_TIMEOUT_S)
                got += 1
        except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                ConnectionResetError):
            pass
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass


async def rst_mid_frame(host: str, port: int, *, conns: int = 1) -> None:
    """Open, send a torn frame (length prefix promising more bytes than
    follow), then RST: the connection-table-wedge probe."""
    loop = asyncio.get_running_loop()
    for _ in range(max(1, conns)):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        try:
            await asyncio.wait_for(loop.sock_connect(s, (host, port)),
                                   _IO_TIMEOUT_S)
            await asyncio.wait_for(
                loop.sock_sendall(s, b"\x01\x00abc"), _IO_TIMEOUT_S)
            # give the torn frame a moment to land in the server's read
            # buffer before tearing the connection down under it
            await asyncio.sleep(0.05)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
        except (OSError, asyncio.TimeoutError):
            pass
        s.close()
