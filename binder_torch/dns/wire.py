"""DNS wire-format codec.

From-scratch implementation of the DNS message format (RFC 1035, plus SRV
RFC 2782 and EDNS0 RFC 6891) — the layer the reference delegates to the
external ``mname`` npm package (reference ``package.json:14``, consumed at
``lib/server.js:19-22,443-446``).  The rebuild owns this layer per SURVEY
§7.1 step 1.

Design notes:
- Encoding uses full name compression (suffix-pointer table) — answers for
  service records repeat the query name many times, so compression directly
  cuts response bytes on the hot path.
- Decoding is strict about bounds and pointer loops (a malformed packet must
  never hang or over-read; compare the reference's zklog.c overflow-checked
  walks for the house style).
- Record classes mirror the reference's record typology: A / AAAA / SRV /
  PTR / SOA / TXT / CNAME / NS / OPT (mname's ARecord/SRVRecord/PTRRecord/
  SOARecord at ``lib/server.js:19-22`` plus the client-side types recursion
  rebuilds at ``lib/recursion.js:299-323``).
"""
from __future__ import annotations

import dataclasses
import ipaddress
import socket as _socket
import struct
from typing import ClassVar, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Constants


class Type:
    A = 1
    NS = 2
    CNAME = 5
    SOA = 6
    PTR = 12
    MX = 15
    TXT = 16
    AAAA = 28
    SRV = 33
    OPT = 41
    ANY = 255

    _names: ClassVar[Dict[int, str]] = {}

    @classmethod
    def name(cls, code: int) -> str:
        if not cls._names:
            cls._names = {
                v: k for k, v in vars(cls).items()
                if isinstance(v, int) and k.isupper()
            }
        return cls._names.get(code, f"TYPE{code}")


class Class:
    IN = 1
    CH = 3
    ANY = 255


class Rcode:
    NOERROR = 0
    FORMERR = 1
    SERVFAIL = 2
    NXDOMAIN = 3
    NOTIMP = 4
    REFUSED = 5

    _names: ClassVar[Dict[int, str]] = {}

    @classmethod
    def name(cls, code: int) -> str:
        if not cls._names:
            cls._names = {
                v: k for k, v in vars(cls).items()
                if isinstance(v, int) and k.isupper()
            }
        return cls._names.get(code, f"RCODE{code}")


class Opcode:
    QUERY = 0
    IQUERY = 1
    STATUS = 2
    NOTIFY = 4
    UPDATE = 5


MAX_NAME_LEN = 255
MAX_LABEL_LEN = 63
MAX_UDP_PAYLOAD = 512   # classic; EDNS extends
MAX_EDNS_PAYLOAD = 4096  # ceiling we honor from an OPT advertisement


class WireError(Exception):
    """Malformed DNS wire data."""


# ---------------------------------------------------------------------------
# Name encoding / decoding


def normalize_name(name: str) -> str:
    """Lowercase and strip the trailing dot ('Foo.Com.' -> 'foo.com')."""
    n = name.strip().lower()
    if n.endswith("."):
        n = n[:-1]
    return n


def encode_name(name: str, buf: bytearray,
                offsets: Optional[Dict[str, int]] = None) -> None:
    """Append *name* to *buf*, using/recording compression offsets.

    *offsets* maps a normalized suffix string ('foo.com') to the buffer
    offset where that suffix was first written.  Pointers may only target
    offsets < 0x4000 (14-bit), per RFC 1035 §4.1.4.
    """
    name = normalize_name(name)
    if name == "":
        buf.append(0)
        return
    if len(name) > MAX_NAME_LEN - 1:
        raise WireError(f"name too long: {name!r}")
    labels = name.split(".")
    for i, label in enumerate(labels):
        if not label or len(label) > MAX_LABEL_LEN:
            raise WireError(f"bad label in name {name!r}")
        suffix = ".".join(labels[i:])
        if offsets is not None:
            at = offsets.get(suffix)
            if at is not None:
                buf += struct.pack(">H", 0xC000 | at)
                return
            if len(buf) < 0x4000:
                offsets[suffix] = len(buf)
        raw = label.encode("ascii")
        buf.append(len(raw))
        buf += raw
    buf.append(0)


def decode_name(data: bytes, off: int) -> Tuple[str, int]:
    """Decode a (possibly compressed) name at *off*.

    Returns (name, offset-after-name-in-original-stream).
    """
    labels: List[str] = []
    jumps = 0
    end: Optional[int] = None  # offset after the first pointer (or terminator)
    total = 0
    pos = off
    while True:
        if pos >= len(data):
            raise WireError("name runs past end of message")
        length = data[pos]
        if length & 0xC0 == 0xC0:
            if pos + 2 > len(data):
                raise WireError("truncated compression pointer")
            ptr = struct.unpack_from(">H", data, pos)[0] & 0x3FFF
            if end is None:
                end = pos + 2
            if ptr >= pos:
                raise WireError("forward/self compression pointer")
            jumps += 1
            if jumps > 128:
                raise WireError("compression pointer loop")
            pos = ptr
            continue
        if length & 0xC0:
            raise WireError(f"reserved label type 0x{length:02x}")
        pos += 1
        if length == 0:
            if end is None:
                end = pos
            break
        if pos + length > len(data):
            raise WireError("label runs past end of message")
        total += length + 1
        if total > MAX_NAME_LEN:
            raise WireError("decoded name too long")
        chunk = data[pos:pos + length]
        if not chunk.isascii():
            # Reject rather than replace: a U+FFFD-bearing name decodes
            # fine but can never re-encode (the question echo in every
            # REFUSED/FORMERR response would raise mid-respond), so
            # tolerating it here turns hostile bytes into a serve-path
            # exception.  Real clients put only ASCII (IDN is punycode)
            # on the wire; anything else earns the header-only FORMERR.
            raise WireError("non-ascii label")
        labels.append(chunk.decode("ascii").lower())
        pos += length
    return ".".join(labels), end


# ---------------------------------------------------------------------------
# Resource records


@dataclasses.dataclass
class Record:
    """Base resource record.  Subclasses define rtype + rdata codec."""
    name: str
    ttl: int
    rclass: int = Class.IN
    rtype: ClassVar[int] = 0

    def encode_rdata(self, buf: bytearray, offsets: Dict[str, int]) -> None:
        raise NotImplementedError

    @classmethod
    def decode_rdata(cls, data: bytes, off: int, rdlen: int,
                     name: str, ttl: int, rclass: int) -> "Record":
        raise NotImplementedError

    # -- shared plumbing --

    def encode(self, buf: bytearray, offsets: Dict[str, int]) -> None:
        encode_name(self.name, buf, offsets)
        buf += struct.pack(">HHI", self.rtype, self.rclass, self.ttl & 0xFFFFFFFF)
        len_at = len(buf)
        buf += b"\x00\x00"
        self.encode_rdata(buf, offsets)
        rdlen = len(buf) - len_at - 2
        struct.pack_into(">H", buf, len_at, rdlen)


@dataclasses.dataclass
class ARecord(Record):
    rtype: ClassVar[int] = Type.A
    address: str = "0.0.0.0"

    def encode_rdata(self, buf, offsets):
        # inet_aton is ~5x cheaper than ipaddress on this hot path, but
        # accepts legacy short/hex forms ("10.1", "0x7f.1") that would
        # silently encode a different address than stored — the ntoa
        # round-trip rejects anything but canonical dotted-quad
        try:
            packed = _socket.inet_aton(self.address)
        except (OSError, TypeError):
            raise WireError(f"bad A address {self.address!r}")
        if _socket.inet_ntoa(packed) != self.address:
            raise WireError(f"non-canonical A address {self.address!r}")
        buf += packed

    @classmethod
    def decode_rdata(cls, data, off, rdlen, name, ttl, rclass):
        if rdlen != 4:
            raise WireError("A rdata must be 4 bytes")
        return cls(name=name, ttl=ttl, rclass=rclass,
                   address=_socket.inet_ntoa(data[off:off + 4]))


@dataclasses.dataclass
class AAAARecord(Record):
    rtype: ClassVar[int] = Type.AAAA
    address: str = "::"

    def encode_rdata(self, buf, offsets):
        buf += ipaddress.IPv6Address(self.address).packed

    @classmethod
    def decode_rdata(cls, data, off, rdlen, name, ttl, rclass):
        if rdlen != 16:
            raise WireError("AAAA rdata must be 16 bytes")
        return cls(name=name, ttl=ttl, rclass=rclass,
                   address=str(ipaddress.IPv6Address(data[off:off + 16])))


@dataclasses.dataclass
class _NameRecord(Record):
    """Records whose rdata is a single domain name."""
    target: str = ""
    # RFC 3597 would forbid compressing rdata names for unknown types; for
    # these well-known types compression is standard.

    def encode_rdata(self, buf, offsets):
        encode_name(self.target, buf, offsets)

    @classmethod
    def decode_rdata(cls, data, off, rdlen, name, ttl, rclass):
        target, end = decode_name(data, off)
        if end > off + rdlen:
            raise WireError("rdata name runs past rdlen")
        return cls(name=name, ttl=ttl, rclass=rclass, target=target)


@dataclasses.dataclass
class PTRRecord(_NameRecord):
    rtype: ClassVar[int] = Type.PTR


@dataclasses.dataclass
class CNAMERecord(_NameRecord):
    rtype: ClassVar[int] = Type.CNAME


@dataclasses.dataclass
class NSRecord(_NameRecord):
    rtype: ClassVar[int] = Type.NS


@dataclasses.dataclass
class SRVRecord(Record):
    rtype: ClassVar[int] = Type.SRV
    priority: int = 0
    weight: int = 0
    port: int = 0
    target: str = ""

    def encode_rdata(self, buf, offsets):
        buf += struct.pack(">HHH", self.priority, self.weight, self.port)
        # RFC 2782 says the target must not be compressed; write it raw.
        encode_name(self.target, buf, None)

    @classmethod
    def decode_rdata(cls, data, off, rdlen, name, ttl, rclass):
        if rdlen < 7:
            raise WireError("SRV rdata too short")
        prio, weight, port = struct.unpack_from(">HHH", data, off)
        target, end = decode_name(data, off + 6)
        if end > off + rdlen:
            raise WireError("SRV target runs past rdlen")
        return cls(name=name, ttl=ttl, rclass=rclass, priority=prio,
                   weight=weight, port=port, target=target)


@dataclasses.dataclass
class SOARecord(Record):
    rtype: ClassVar[int] = Type.SOA
    mname: str = ""
    rname: str = ""
    serial: int = 0
    refresh: int = 0
    retry: int = 0
    expire: int = 0
    minimum: int = 0

    def encode_rdata(self, buf, offsets):
        encode_name(self.mname, buf, offsets)
        encode_name(self.rname, buf, offsets)
        buf += struct.pack(">IIIII", self.serial, self.refresh, self.retry,
                           self.expire, self.minimum)

    @classmethod
    def decode_rdata(cls, data, off, rdlen, name, ttl, rclass):
        mname, off2 = decode_name(data, off)
        rname, off3 = decode_name(data, off2)
        if off3 + 20 > off + rdlen:
            raise WireError("SOA rdata too short")
        serial, refresh, retry, expire, minimum = struct.unpack_from(
            ">IIIII", data, off3)
        return cls(name=name, ttl=ttl, rclass=rclass, mname=mname,
                   rname=rname, serial=serial, refresh=refresh, retry=retry,
                   expire=expire, minimum=minimum)


@dataclasses.dataclass
class TXTRecord(Record):
    rtype: ClassVar[int] = Type.TXT
    texts: Tuple[str, ...] = ()

    def encode_rdata(self, buf, offsets):
        for t in self.texts:
            raw = t.encode("utf-8")
            if len(raw) > 255:
                raise WireError("TXT string too long")
            buf.append(len(raw))
            buf += raw

    @classmethod
    def decode_rdata(cls, data, off, rdlen, name, ttl, rclass):
        texts: List[str] = []
        end = off + rdlen
        while off < end:
            n = data[off]
            off += 1
            if off + n > end:
                raise WireError("TXT string runs past rdata")
            texts.append(data[off:off + n].decode("utf-8", "replace"))
            off += n
        return cls(name=name, ttl=ttl, rclass=rclass, texts=tuple(texts))


@dataclasses.dataclass
class OPTRecord(Record):
    """EDNS0 pseudo-record (RFC 6891).  ttl field carries ext-rcode/flags."""
    rtype: ClassVar[int] = Type.OPT
    udp_payload_size: int = 1232
    ext_rcode: int = 0
    version: int = 0
    dnssec_ok: bool = False
    # options (cookies, padding, ...) are ignored semantically but their
    # presence matters to the decode cache: option bytes vary per packet,
    # so such requests can never be cache templates
    has_options: bool = False

    def encode(self, buf, offsets):
        buf.append(0)  # root name
        flags = (0x8000 if self.dnssec_ok else 0)
        ttl = (self.ext_rcode << 24) | (self.version << 16) | flags
        buf += struct.pack(">HHI", self.rtype, self.udp_payload_size, ttl)
        buf += b"\x00\x00"  # no options

    def encode_rdata(self, buf, offsets):  # pragma: no cover - unused
        pass

    @classmethod
    def from_wire(cls, name, ttl, rclass, rdata):
        return cls(
            name=name, ttl=0, rclass=Class.IN,
            udp_payload_size=rclass,
            ext_rcode=(ttl >> 24) & 0xFF,
            version=(ttl >> 16) & 0xFF,
            dnssec_ok=bool(ttl & 0x8000),
            has_options=bool(rdata),
        )


@dataclasses.dataclass
class RawRecord(Record):
    """Unknown rtype — rdata kept opaque (RFC 3597 behavior)."""
    rtype_code: int = 0
    rdata: bytes = b""

    @property
    def rtype(self):  # type: ignore[override]
        return self.rtype_code

    def encode(self, buf, offsets):
        encode_name(self.name, buf, offsets)
        buf += struct.pack(">HHI", self.rtype_code, self.rclass,
                           self.ttl & 0xFFFFFFFF)
        buf += struct.pack(">H", len(self.rdata))
        buf += self.rdata

    def encode_rdata(self, buf, offsets):  # pragma: no cover - unused
        pass


_RECORD_TYPES: Dict[int, type] = {
    Type.A: ARecord,
    Type.AAAA: AAAARecord,
    Type.PTR: PTRRecord,
    Type.CNAME: CNAMERecord,
    Type.NS: NSRecord,
    Type.SRV: SRVRecord,
    Type.SOA: SOARecord,
    Type.TXT: TXTRecord,
}


def _decode_record(data: bytes, off: int) -> Tuple[Record, int]:
    name, off = decode_name(data, off)
    if off + 10 > len(data):
        raise WireError("truncated record header")
    rtype, rclass, ttl, rdlen = struct.unpack_from(">HHIH", data, off)
    off += 10
    if off + rdlen > len(data):
        raise WireError("rdata runs past end of message")
    if rtype == Type.OPT:
        rec: Record = OPTRecord.from_wire(name, ttl, rclass,
                                          data[off:off + rdlen])
    else:
        cls = _RECORD_TYPES.get(rtype)
        if cls is None:
            rec = RawRecord(name=name, ttl=ttl, rclass=rclass,
                            rtype_code=rtype, rdata=bytes(data[off:off + rdlen]))
        else:
            rec = cls.decode_rdata(data, off, rdlen, name, ttl, rclass)
    return rec, off + rdlen


# ---------------------------------------------------------------------------
# Question + Message


@dataclasses.dataclass
class Question:
    name: str
    qtype: int
    qclass: int = Class.IN

    def encode(self, buf: bytearray, offsets: Dict[str, int]) -> None:
        encode_name(self.name, buf, offsets)
        buf += struct.pack(">HH", self.qtype, self.qclass)


@dataclasses.dataclass
class Message:
    id: int = 0
    qr: bool = False
    opcode: int = Opcode.QUERY
    aa: bool = False
    tc: bool = False
    rd: bool = False
    ra: bool = False
    rcode: int = Rcode.NOERROR
    questions: List[Question] = dataclasses.field(default_factory=list)
    answers: List[Record] = dataclasses.field(default_factory=list)
    authorities: List[Record] = dataclasses.field(default_factory=list)
    additionals: List[Record] = dataclasses.field(default_factory=list)

    def _flags(self) -> int:
        f = 0
        if self.qr:
            f |= 0x8000
        f |= (self.opcode & 0xF) << 11
        if self.aa:
            f |= 0x0400
        if self.tc:
            f |= 0x0200
        if self.rd:
            f |= 0x0100
        if self.ra:
            f |= 0x0080
        f |= self.rcode & 0xF
        return f

    def encode(self, max_size: Optional[int] = None) -> bytes:
        """Serialize with name compression.

        If *max_size* is given and the message exceeds it, answers are
        dropped and TC is set (UDP truncation semantics).
        """
        buf = bytearray()
        offsets: Dict[str, int] = {}
        buf += struct.pack(
            ">HHHHHH", self.id, self._flags(), len(self.questions),
            len(self.answers), len(self.authorities), len(self.additionals))
        for q in self.questions:
            q.encode(buf, offsets)
        for rec in self.answers:
            rec.encode(buf, offsets)
        for rec in self.authorities:
            rec.encode(buf, offsets)
        for rec in self.additionals:
            rec.encode(buf, offsets)
        if max_size is not None and len(buf) > max_size:
            # RFC 6891: keep the OPT pseudo-record in TC responses so EDNS
            # clients retain negotiated payload size on retry.
            opt = [r for r in self.additionals if isinstance(r, OPTRecord)]
            truncated = dataclasses.replace(
                self, tc=True, answers=[], authorities=[], additionals=opt)
            return truncated.encode(None)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Message":
        """Strict decode; raises WireError for ANYTHING malformed.

        The armor wrapper is the contract the serve lanes build on:
        every lane maps WireError to FORMERR-or-drop, so a decoder bug
        (struct.error, IndexError, a codec surprise) reached by a
        hostile frame must degrade to the same verdict instead of
        becoming an unhandled exception in a read loop.  The corpus
        replay in tests/test_hostile.py pins this."""
        try:
            return cls._decode(data)
        except WireError:
            raise
        except Exception as e:
            raise WireError(f"undecodable message "
                            f"({type(e).__name__}: {e})") from e

    @classmethod
    def _decode(cls, data: bytes) -> "Message":
        if len(data) < 12:
            raise WireError("message shorter than header")
        (mid, flags, qd, an, ns, ar) = struct.unpack_from(">HHHHHH", data, 0)
        msg = cls(
            id=mid,
            qr=bool(flags & 0x8000),
            opcode=(flags >> 11) & 0xF,
            aa=bool(flags & 0x0400),
            tc=bool(flags & 0x0200),
            rd=bool(flags & 0x0100),
            ra=bool(flags & 0x0080),
            rcode=flags & 0xF,
        )
        off = 12
        for _ in range(qd):
            name, off = decode_name(data, off)
            if off + 4 > len(data):
                raise WireError("truncated question")
            qtype, qclass = struct.unpack_from(">HH", data, off)
            off += 4
            msg.questions.append(Question(name=name, qtype=qtype, qclass=qclass))
        for _ in range(an):
            rec, off = _decode_record(data, off)
            msg.answers.append(rec)
        for _ in range(ns):
            rec, off = _decode_record(data, off)
            msg.authorities.append(rec)
        for _ in range(ar):
            rec, off = _decode_record(data, off)
            msg.additionals.append(rec)
        if off != len(data):
            # trailing bytes beyond the counted records: no legitimate
            # client produces these, and tolerating them lets attackers
            # mint unique cache keys from one query
            raise WireError(f"{len(data) - off} trailing bytes")
        return msg

    # -- convenience --

    @property
    def edns(self) -> Optional[OPTRecord]:
        # memoized: the serve path asks several times per query and
        # request additionals never change after decode (a request built
        # by hand must not grow an OPT after first access)
        try:
            return self._edns_memo
        except AttributeError:
            pass
        memo = None
        for rec in self.additionals:
            if isinstance(rec, OPTRecord):
                memo = rec
                break
        self._edns_memo = memo
        return memo

    def max_udp_payload(self) -> int:
        opt = self.edns
        if opt is not None and opt.udp_payload_size >= MAX_UDP_PAYLOAD:
            return min(opt.udp_payload_size, MAX_EDNS_PAYLOAD)
        return MAX_UDP_PAYLOAD


def skip_name(buf: bytes, off: int) -> Optional[int]:
    """Offset just past a wire name at ``off`` — labels walked, a
    compression pointer consumed as the 2-byte terminator it is; None
    on malformed/overrun.  Structural only (no decompression): used by
    consumers that forward or validate wires without decoding them."""
    n = len(buf)
    while True:
        if off >= n:
            return None
        b = buf[off]
        if b == 0:
            return off + 1
        if b & 0xC0 == 0xC0:
            return off + 2 if off + 2 <= n else None
        if b & 0xC0:
            return None
        off += 1 + b


def skip_record(buf: bytes, off: int) -> Optional[Tuple[int, int]]:
    """(next_offset, rtype) for the record at ``off``; None on bounds."""
    noff = skip_name(buf, off)
    if noff is None or noff + 10 > len(buf):
        return None
    rtype = (buf[noff] << 8) | buf[noff + 1]
    rdlen = (buf[noff + 8] << 8) | buf[noff + 9]
    end = noff + 10 + rdlen
    if end > len(buf):
        return None
    return end, rtype


def wire_walks(raw: bytes) -> bool:
    """True when the message's section counts walk the wire cleanly to
    its exact end — the structural validation applied to upstream
    responses before they can win a lookup (a full decode happens only
    on paths that need record objects)."""
    if len(raw) < 12:
        return False
    counts = ((raw[4] << 8) | raw[5], (raw[6] << 8) | raw[7],
              (raw[8] << 8) | raw[9], (raw[10] << 8) | raw[11])
    off = 12
    for _ in range(counts[0]):
        noff = skip_name(raw, off)
        if noff is None or noff + 4 > len(raw):
            return False
        off = noff + 4
    for _ in range(counts[1] + counts[2] + counts[3]):
        nxt = skip_record(raw, off)
        if nxt is None:
            return False
        off = nxt[0]
    return off == len(raw)


def patch_answer_wire(wire: bytes, qid: Optional[int] = None,
                      rd: Optional[bool] = None) -> bytes:
    """ID/flags patch for a precompiled response wire — the query-time
    half of the mutation-time pipeline (`resolver/precompile.py`).

    Precompiled wires are rendered canonically (id 0, RD clear); serving
    one to a live query is this patch plus the question-case echo the
    respond path already applies — never a re-encode.  The EDNS axis is
    handled by variant selection, not patching: the OPT echo sits at the
    head of the additionals section (`QueryCtx` appends it at
    construction, before any answer-derived additionals), so a
    with-EDNS wire is pre-rendered alongside the without-EDNS one
    rather than spliced per query.
    """
    b = bytearray(wire)
    if qid is not None:
        b[0] = (qid >> 8) & 0xFF
        b[1] = qid & 0xFF
    if rd is not None:
        if rd:
            b[2] |= 0x01
        else:
            b[2] &= 0xFE
    return bytes(b)


def make_query(name: str, qtype: int, *, qid: int = 0, rd: bool = False,
               edns_payload: Optional[int] = 1232) -> Message:
    """Build a standard query message (client side / tests)."""
    msg = Message(id=qid, rd=rd,
                  questions=[Question(name=normalize_name(name), qtype=qtype)])
    if edns_payload:
        msg.additionals.append(OPTRecord(name="", ttl=0,
                                         udp_payload_size=edns_payload))
    return msg


def reverse_name_for_ip(ip: str) -> str:
    """'10.1.2.3' -> '3.2.1.10.in-addr.arpa' (v6 -> ip6.arpa nibbles)."""
    addr = ipaddress.ip_address(ip)
    return addr.reverse_pointer


def ip_from_reverse_name(name: str) -> Optional[str]:
    """Parse 'd.c.b.a.in-addr.arpa' -> 'a.b.c.d', or ip6.arpa -> IPv6.

    Returns None if the name is not a well-formed reverse name (the caller
    decides the rcode policy — the reference REFUSES such queries,
    ``lib/server.js:71-103``).
    """
    n = normalize_name(name)
    if n.endswith(".in-addr.arpa"):
        parts = n[:-len(".in-addr.arpa")].split(".")
        if len(parts) != 4:
            return None
        try:
            octets = [int(p) for p in parts]
        except ValueError:
            return None
        if any(o < 0 or o > 255 for o in octets):
            return None
        if any(p != str(o) for p, o in zip(parts, octets)):
            return None  # reject leading zeros / weird forms
        return ".".join(str(o) for o in reversed(octets))
    if n.endswith(".ip6.arpa"):
        nibbles = n[:-len(".ip6.arpa")].split(".")
        if len(nibbles) != 32:
            return None
        if any(len(nib) != 1 or nib not in "0123456789abcdef"
               for nib in nibbles):
            return None
        hexstr = "".join(reversed(nibbles))
        groups = [hexstr[i:i + 4] for i in range(0, 32, 4)]
        return str(ipaddress.IPv6Address(":".join(groups)))
    return None
