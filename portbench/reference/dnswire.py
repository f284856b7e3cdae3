"""DNS messages on the wire (RFC 1035, RFC 2782), in plain Python.

The benchmark's own codec: it builds the query wires the client sends and
decodes every reply the reference judges.  It shares no code with the
program under test.
"""
from __future__ import annotations

import struct

A, SOA, PTR, SRV, OPT = 1, 6, 12, 33, 41
NOERROR, SERVFAIL, NXDOMAIN, REFUSED = 0, 2, 3, 5


class WireError(ValueError):
    """A reply that is not a well-formed DNS message."""


def encode_name(name: str) -> bytes:
    out = bytearray()
    for label in name.rstrip(".").split("."):
        raw = label.encode("ascii")
        if not 0 < len(raw) < 64:
            raise ValueError(f"bad label in {name!r}")
        out.append(len(raw))
        out += raw
    out.append(0)
    return bytes(out)


def encode_query(name: str, qtype: int, qid: int = 0) -> bytes:
    """A standard query, RD clear, no EDNS, as a stub resolver on a
    service host sends it to binder."""
    return (struct.pack(">HHHHHH", qid, 0, 1, 0, 0, 0)
            + encode_name(name) + struct.pack(">HH", qtype, 1))


def reverse_name(addr: str) -> str:
    return ".".join(reversed(addr.split("."))) + ".in-addr.arpa"


def _name(data: bytes, off: int):
    """``(name, offset after it)`` of the name at ``off``, following
    compression pointers."""
    labels = []
    end = None
    jumps = 0
    while True:
        if off >= len(data):
            raise WireError("name runs past the message")
        n = data[off]
        if n & 0xC0 == 0xC0:
            if off + 1 >= len(data):
                raise WireError("cut pointer")
            if end is None:
                end = off + 2
            off = ((n & 0x3F) << 8) | data[off + 1]
            jumps += 1
            if jumps > 64:
                raise WireError("pointer loop")
            continue
        if n & 0xC0:
            raise WireError("bad label type")
        off += 1
        if n == 0:
            break
        if off + n > len(data):
            raise WireError("label runs past the message")
        labels.append(data[off:off + n].decode("ascii").lower())
        off += n
    return ".".join(labels), (off if end is None else end)


class Reply:
    """A decoded reply: header fields, the question, and the answer and
    additional records as ``(name, type, ttl, value)``; ``value`` is the
    dotted address (A), the target name (PTR), ``(port, target,
    priority, weight)`` (SRV) or the raw RDATA (other types)."""

    __slots__ = ("qid", "qr", "opcode", "tc", "rcode", "qname", "qtype",
                 "answers", "authorities", "additionals")

    def __init__(self, data: bytes):
        if len(data) < 12:
            raise WireError("shorter than a header")
        (self.qid, flags, qd, an, ns, ar) = struct.unpack_from(
            ">HHHHHH", data)
        self.qr = flags >> 15
        self.opcode = (flags >> 11) & 0xF
        self.tc = (flags >> 9) & 1
        self.rcode = flags & 0xF
        if qd != 1:
            raise WireError(f"{qd} questions")
        self.qname, off = _name(data, 12)
        if off + 4 > len(data):
            raise WireError("cut question")
        self.qtype, _ = struct.unpack_from(">HH", data, off)
        off += 4
        sections = []
        for count in (an, ns, ar):
            recs = []
            for _ in range(count):
                name, off = _name(data, off)
                if off + 10 > len(data):
                    raise WireError("cut record")
                rtype, _cls, ttl, rdlen = struct.unpack_from(
                    ">HHIH", data, off)
                off += 10
                if off + rdlen > len(data):
                    raise WireError("cut rdata")
                if rtype == A:
                    if rdlen != 4:
                        raise WireError("A rdata length")
                    value = ".".join(str(b) for b in data[off:off + 4])
                elif rtype == PTR:
                    value, _ = _name(data, off)
                elif rtype == SRV:
                    prio, weight, port = struct.unpack_from(">HHH", data,
                                                            off)
                    target, _ = _name(data, off + 6)
                    value = (port, target, prio, weight)
                else:
                    value = data[off:off + rdlen]
                recs.append((name, rtype, ttl, value))
                off += rdlen
            sections.append(recs)
        if off != len(data):
            raise WireError("bytes after the last record")
        self.answers, self.authorities, self.additionals = sections
