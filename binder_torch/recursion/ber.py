"""Minimal BER (ITU-T X.690) codec — just the subset LDAPv3 needs.

The reference consumes LDAP via the ``ufds`` npm package (an ldapjs
client, SURVEY §2.3); this rebuild owns the wire layer the same way it
owns the DNS codec.  Definite lengths only (LDAP forbids indefinite),
universal INTEGER/OCTET STRING/BOOLEAN/ENUMERATED/SEQUENCE/SET plus
application- and context-tagged forms.
"""
from __future__ import annotations

from typing import List, Tuple

# universal tags
INTEGER = 0x02
OCTET_STRING = 0x04
BOOLEAN = 0x01
NULL = 0x05
ENUMERATED = 0x0A
SEQUENCE = 0x30          # constructed
SET = 0x31               # constructed


class BerError(Exception):
    pass


def encode_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = b""
    while n:
        out = bytes([n & 0xFF]) + out
        n >>= 8
    return bytes([0x80 | len(out)]) + out


def tlv(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + encode_len(len(content)) + content


def encode_int(value: int, tag: int = INTEGER) -> bytes:
    if value == 0:
        return tlv(tag, b"\x00")
    neg = value < 0
    out = b""
    v = value
    while True:
        out = bytes([v & 0xFF]) + out
        v >>= 8
        if (v == 0 and not neg and not (out[0] & 0x80)) or \
           (v == -1 and neg and (out[0] & 0x80)):
            break
    return tlv(tag, out)


def encode_str(s, tag: int = OCTET_STRING) -> bytes:
    if isinstance(s, str):
        s = s.encode("utf-8")
    return tlv(tag, s)


def encode_bool(b: bool) -> bytes:
    return tlv(BOOLEAN, b"\xff" if b else b"\x00")


def encode_seq(parts: List[bytes], tag: int = SEQUENCE) -> bytes:
    return tlv(tag, b"".join(parts))


def decode_tlv(data: bytes, off: int = 0) -> Tuple[int, bytes, int]:
    """Return (tag, content, offset-after) for the TLV at *off*."""
    if off + 2 > len(data):
        raise BerError("short TLV header")
    tag = data[off]
    if tag & 0x1F == 0x1F:
        raise BerError("multi-byte tags unsupported")
    length = data[off + 1]
    off += 2
    if length & 0x80:
        nlen = length & 0x7F
        if nlen == 0:
            raise BerError("indefinite length not allowed in LDAP")
        if nlen > 4 or off + nlen > len(data):
            raise BerError("bad long-form length")
        length = int.from_bytes(data[off:off + nlen], "big")
        off += nlen
    if off + length > len(data):
        raise BerError("TLV content overruns buffer")
    return tag, data[off:off + length], off + length


def decode_int(content: bytes) -> int:
    if not content:
        raise BerError("empty INTEGER")
    return int.from_bytes(content, "big", signed=True)


def decode_all(data: bytes) -> List[Tuple[int, bytes]]:
    """Decode a run of sibling TLVs (e.g. a SEQUENCE body)."""
    out = []
    off = 0
    while off < len(data):
        tag, content, off = decode_tlv(data, off)
        out.append((tag, content))
    return out


def frame_length(data: bytes) -> int:
    """Total bytes of the TLV starting at offset 0, or 0 if incomplete —
    for streaming message framing."""
    if len(data) < 2:
        return 0
    length = data[1]
    hdr = 2
    if length & 0x80:
        nlen = length & 0x7F
        if nlen == 0 or nlen > 4:
            raise BerError("bad frame length")
        if len(data) < 2 + nlen:
            return 0
        length = int.from_bytes(data[2:2 + nlen], "big")
        hdr = 2 + nlen
    total = hdr + length
    return total if len(data) >= total else 0
