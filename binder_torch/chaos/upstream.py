"""ChaosUpstream: a recursion upstream that misbehaves on command.

A minimal in-process DNS server (UDP + TCP) standing in for a
remote-DC binder, answering A/IN from a static name→address map —
except that every packet first consults a :class:`FaultPlan`'s live
``upstream`` fault state:

- ``dead``      — drop everything (the dead-peer shape breakers exist
                  for);
- ``loss``      — drop with probability p (lossy cross-DC link);
- ``delay_ms``  — hold the response (slow peer; what hedging beats);
- ``dup``       — send the response twice (duplicate-delivery paths);
- ``truncate``  — answer TC=1 with no answers over UDP, forcing the
                  client's TCP retry (TCP serves the real answer).

The response is built by patching the *request* wire — id and question
echoed byte-verbatim — so the chaos upstream is transparent to the
client's dns0x20 validation, exactly like a real binder peer.

Used by tests/test_torch_chaos.py and the chaos phase of
``chip_smoke.py``.
"""
from __future__ import annotations

import asyncio
import logging
import socket
import struct
from typing import Dict, Optional, Tuple

from binder_torch.chaos.plan import FaultPlan


def _parse_question(data: bytes) -> Optional[Tuple[str, int, int]]:
    """(lowercased qname, qtype, question_end_offset) of a
    single-question query wire, or None when malformed."""
    if len(data) < 17 or data[4:6] != b"\x00\x01":
        return None
    labels = []
    off = 12
    try:
        while True:
            ll = data[off]
            if ll == 0:
                off += 1
                break
            if ll & 0xC0:
                return None
            labels.append(data[off + 1:off + 1 + ll])
            off += 1 + ll
        qtype = (data[off] << 8) | data[off + 1]
    except IndexError:
        return None
    if off + 4 > len(data):
        return None
    try:
        name = b".".join(labels).lower().decode("ascii")
    except UnicodeDecodeError:
        return None
    return name, qtype, off + 4


class ChaosUpstream:
    def __init__(self, plan: FaultPlan,
                 hosts: Optional[Dict[str, str]] = None,
                 ttl: int = 30,
                 log: Optional[logging.Logger] = None) -> None:
        self.plan = plan
        self.hosts = dict(hosts or {})
        self.ttl = ttl
        self.log = log or logging.getLogger("binder.chaos.upstream")
        self.port: Optional[int] = None
        self._udp_transport = None
        self._tcp_server: Optional[asyncio.AbstractServer] = None
        # per-fault accounting the soak report reads back
        self.served = 0
        self.dropped = 0
        self.delayed = 0
        self.duplicated = 0
        self.truncated = 0

    # -- answer assembly (request-wire patching, lane-style) --

    def build_response(self, data: bytes, tc: bool) -> Optional[bytes]:
        parsed = _parse_question(data)
        if parsed is None:
            return None
        name, qtype, q_end = parsed
        rd = data[2] & 0x01
        addr = self.hosts.get(name) if qtype == 1 else None
        body = b""
        ancount = 0
        rcode = 0
        if tc:
            pass                        # TC=1, empty answer section
        elif addr is not None:
            try:
                packed = socket.inet_aton(addr)
            except OSError:
                return None
            body = (b"\xc0\x0c\x00\x01\x00\x01"
                    + struct.pack(">IH", self.ttl, 4) + packed)
            ancount = 1
        else:
            rcode = 3                   # NXDOMAIN for unmapped names
        flags = 0x8400 | (0x0100 if rd else 0) | (0x0200 if tc else 0) \
            | rcode
        return (data[:2] + struct.pack(">HHHHH", flags, 1, ancount, 0, 0)
                + data[12:q_end] + body)

    # -- UDP (the faulted path) --

    class _Proto(asyncio.DatagramProtocol):
        def __init__(self, owner: "ChaosUpstream") -> None:
            self.owner = owner
            self.transport = None

        def connection_made(self, transport) -> None:
            self.transport = transport

        def datagram_received(self, data: bytes, addr) -> None:
            owner = self.owner
            faults = owner.plan.upstream
            rng = owner.plan.rng
            if faults.dead or (faults.loss > 0.0
                               and rng.random() < faults.loss):
                owner.dropped += 1
                return
            resp = owner.build_response(data, tc=faults.truncate)
            if resp is None:
                return
            if faults.truncate:
                owner.truncated += 1
            copies = 1
            if faults.dup > 0.0 and rng.random() < faults.dup:
                owner.duplicated += 1
                copies = 2

            def send() -> None:
                if self.transport is None or self.transport.is_closing():
                    return
                for _ in range(copies):
                    self.transport.sendto(resp, addr)
                owner.served += 1

            if faults.delay_ms > 0.0:
                owner.delayed += 1
                asyncio.get_running_loop().call_later(
                    faults.delay_ms / 1000.0, send)
            else:
                send()

    # -- TCP (the truncation-retry path; faults apply to loss/dead) --

    async def _tcp_conn(self, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                hdr = await reader.readexactly(2)
                n = int.from_bytes(hdr, "big")
                data = await reader.readexactly(n)
                faults = self.plan.upstream
                if faults.dead or (faults.loss > 0.0
                                   and self.plan.rng.random()
                                   < faults.loss):
                    self.dropped += 1
                    continue
                resp = self.build_response(data, tc=False)
                if resp is None:
                    continue
                if faults.delay_ms > 0.0:
                    await asyncio.sleep(faults.delay_ms / 1000.0)
                writer.write(len(resp).to_bytes(2, "big") + resp)
                await writer.drain()
                self.served += 1
        except (asyncio.IncompleteReadError, ConnectionResetError,
                BrokenPipeError, OSError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    # -- lifecycle --

    async def start(self, address: str = "127.0.0.1",
                    port: int = 0) -> int:
        loop = asyncio.get_running_loop()
        self._udp_transport, _ = await loop.create_datagram_endpoint(
            lambda: self._Proto(self), local_addr=(address, port))
        self.port = self._udp_transport.get_extra_info("sockname")[1]
        # TCP shares the UDP port number (binder peers serve both)
        self._tcp_server = await asyncio.start_server(
            self._tcp_conn, address, self.port)
        return self.port

    async def stop(self) -> None:
        if self._udp_transport is not None:
            self._udp_transport.close()
            self._udp_transport = None
        if self._tcp_server is not None:
            self._tcp_server.close()
            await self._tcp_server.wait_closed()
            self._tcp_server = None

    def stats(self) -> dict:
        return {"served": self.served, "dropped": self.dropped,
                "delayed": self.delayed, "duplicated": self.duplicated,
                "truncated": self.truncated,
                "faults": self.plan.upstream.snapshot()}
