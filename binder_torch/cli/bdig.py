"""bdig — dig-style DNS query tool speaking binder_torch's own codec.

The reference's test strategy shells out to dig(1) and text-scrapes it
(test/dig.js:12,109-134); operators use dig against binder directly.
This image has no dig, so the rebuild ships its own: same core surface
(@server, -p port, +tcp, +norecurse, type argument), output modeled on
dig's answer section.

    bdig @::1 -p 1053 web.foo.com A
    bdig @127.0.0.1 -p 53 _http._tcp.svc.foo.com SRV +tcp
    bdig @127.0.0.1 1.0.168.192.in-addr.arpa PTR

where ``bdig`` is ``python -m binder_torch.cli.bdig``, the counterpart
of ``bin/bdig`` with the same options, output and exit codes.
"""
import argparse
import random
import socket
import struct
import sys
import time

from binder_torch.dns import Message, Rcode, Type, make_query


def rdata_str(rec):
    for attr in ("address",):
        if hasattr(rec, attr):
            return getattr(rec, attr)
    if hasattr(rec, "port"):   # SRV
        return f"{rec.priority} {rec.weight} {rec.port} {rec.target}."
    if hasattr(rec, "target"):
        return f"{rec.target}."
    if hasattr(rec, "texts"):
        return " ".join(f'"{t}"' for t in rec.texts)
    if hasattr(rec, "mname"):  # SOA
        return (f"{rec.mname}. {rec.rname}. {rec.serial} {rec.refresh} "
                f"{rec.retry} {rec.expire} {rec.minimum}")
    return "<opaque>"


def print_section(title, records):
    shown = [r for r in records if Type.name(r.rtype) != "OPT"]
    if not shown:
        return
    print(f";; {title} SECTION:")
    for r in shown:
        print(f"{r.name + '.':<32}{r.ttl:<8}IN\t"
              f"{Type.name(r.rtype):<8}{rdata_str(r)}")
    print()


def query_udp(server, port, wire, timeout):
    fam = socket.AF_INET6 if ":" in server else socket.AF_INET
    s = socket.socket(fam, socket.SOCK_DGRAM)
    s.settimeout(timeout)
    try:
        s.sendto(wire, (server, port))
        return s.recvfrom(65535)[0]
    finally:
        s.close()


def query_tcp(server, port, wire, timeout):
    fam = socket.AF_INET6 if ":" in server else socket.AF_INET
    s = socket.socket(fam, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect((server, port))
        s.sendall(struct.pack(">H", len(wire)) + wire)
        hdr = b""
        while len(hdr) < 2:
            chunk = s.recv(2 - len(hdr))
            if not chunk:
                raise ConnectionError("server closed connection")
            hdr += chunk
        need = struct.unpack(">H", hdr)[0]
        buf = b""
        while len(buf) < need:
            chunk = s.recv(need - len(buf))
            if not chunk:
                raise ConnectionError("short TCP response")
            buf += chunk
        return buf
    finally:
        s.close()


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="bdig", add_help=True,
        description="dig-style client for the binder DNS service")
    ap.add_argument("-p", "--port", type=int, default=53)
    ap.add_argument("-t", "--timeout", type=float, default=3.0)
    ap.add_argument("args", nargs="*",
                    help="[@server] name [type] [+tcp] [+norecurse] [+short]")
    # dig-style operands (@server, +flags, name, type) may be interleaved
    # with -p/-t anywhere on the line
    opts, extra = ap.parse_known_args(argv)
    opts.args = list(opts.args) + extra

    server, name, qtype_name = "127.0.0.1", None, "A"
    positional = []
    for a in opts.args:
        if a.startswith("@"):
            server = a[1:]
        else:
            positional.append(a)
    use_tcp = "+tcp" in positional
    recurse = "+norecurse" not in positional
    short = "+short" in positional
    words = [a for a in positional if not a.startswith("+")]
    if not words:
        ap.error("no query name given")
    name = words[0]
    if len(words) > 1:
        qtype_name = words[1].upper()
    qtype = getattr(Type, qtype_name, None)
    if not isinstance(qtype, int):
        ap.error(f"unknown query type {qtype_name!r}")

    qid = random.randint(0, 0xFFFF)
    q = make_query(name, qtype, qid=qid, rd=recurse, edns_payload=1232)
    wire = q.encode()

    t0 = time.monotonic()
    try:
        if use_tcp:
            data = query_tcp(server, opts.port, wire, opts.timeout)
        else:
            data = query_udp(server, opts.port, wire, opts.timeout)
    except (OSError, ConnectionError) as e:
        print(f";; connection error: {e}", file=sys.stderr)
        return 9
    ms = (time.monotonic() - t0) * 1000.0
    m = Message.decode(data)

    if m.tc and not use_tcp:
        print(";; Truncated, retrying in TCP mode.")
        t0 = time.monotonic()
        try:
            data = query_tcp(server, opts.port, wire, opts.timeout)
        except (OSError, ConnectionError) as e:
            print(f";; connection error: {e}", file=sys.stderr)
            return 9
        ms = (time.monotonic() - t0) * 1000.0
        use_tcp = True   # the displayed answer came over TCP
        m = Message.decode(data)

    if short:
        for r in m.answers:
            if Type.name(r.rtype) != "OPT":
                print(rdata_str(r))
        return 0 if m.rcode == Rcode.NOERROR else 1

    flags = "".join(
        f" {f}" for f, on in
        [("qr", m.qr), ("aa", m.aa), ("tc", m.tc), ("rd", m.rd),
         ("ra", m.ra)] if on)
    print(f";; ->>HEADER<<- opcode: QUERY, status: {Rcode.name(m.rcode)}, "
          f"id: {m.id}")
    print(f";; flags:{flags}; QUERY: {len(m.questions)}, "
          f"ANSWER: {len(m.answers)}, AUTHORITY: {len(m.authorities)}, "
          f"ADDITIONAL: {len(m.additionals)}")
    print()
    if m.questions:
        print(";; QUESTION SECTION:")
        for qq in m.questions:
            print(f";{qq.name + '.':<31}\tIN\t{Type.name(qq.qtype)}")
        print()
    print_section("ANSWER", m.answers)
    print_section("AUTHORITY", m.authorities)
    print_section("ADDITIONAL", m.additionals)
    proto = "TCP" if use_tcp else "UDP"
    print(f";; Query time: {ms:.1f} msec")
    print(f";; SERVER: {server}#{opts.port} ({proto})")
    return 0 if m.rcode == Rcode.NOERROR else 1


if __name__ == "__main__":
    sys.exit(main())
