"""Query DNS through glibc's resolver (libresolv) and print parsed JSON.

An INDEPENDENT DNS implementation for conformance testing: glibc's
``res_query`` builds and sends the query and ``ns_initparse``/
``ns_parserr`` parse the response — none of this repo's codec is
involved on the client side (the coverage the reference got from
shelling out to dig(1), reference test/dig.js:109-134).  Without
``--server`` it uses /etc/resolv.conf for the server address like any
stub-resolver client.

``--server HOST:PORT`` points glibc's resolver state at one server
instead: after ``res_init`` it sets ``_res`` (``__res_state()``) to one
name server at HOST:PORT, turns on EDNS0 and asks once with a 2 s
timeout (what ``nameserver HOST`` and ``options timeout:2 attempts:1
edns0`` in resolv.conf would say).  glibc keeps a ``_res`` the
application changed after ``res_init``, so no resolv.conf rewrite, no
port 53 and no root are needed.

Usage: python3 -m binder_torch.cli.libresolv_probe [--server HOST:PORT]
           NAME QTYPE
  QTYPE: A | SRV | PTR
Output: one JSON object:
  {"rcode_ok": true, "ancount": N,
   "answers": [{"name": ..., "type": N, "ttl": N, ...type fields}],
   "additional": [...same...], "opt": {"payload": N} | null}

Exit 0 on a parsed NOERROR response; 1 on lookup/parse failure (the
h_errno detail goes to stderr); 2 on bad arguments.
"""
# The counterpart of tools/libresolv_probe.py (the same parse, output
# and exit codes) with the one added option, --server.
import ctypes
import json
import socket
import sys

NS_MAXDNAME = 1025
C_IN = 1
QTYPES = {"A": 1, "PTR": 12, "SRV": 33}
NS_S_AN = 1     # answer section (arpa/nameser.h ns_sect)
NS_S_AR = 3     # additional section
RES_USE_EDNS0 = 0x00100000      # resolv.h
#: what ``options timeout:2 attempts:1`` sets (resolv.h RES_TIMEOUT,
#: RES_DFLRETRY in seconds and tries)
SERVER_RETRANS_S = 2
SERVER_RETRY = 1


class NsMsg(ctypes.Structure):
    # glibc arpa/nameser.h struct __ns_msg (layout stable since glibc 2.x)
    _fields_ = [
        ("_msg", ctypes.c_void_p),
        ("_eom", ctypes.c_void_p),
        ("_id", ctypes.c_uint16),
        ("_flags", ctypes.c_uint16),
        ("_counts", ctypes.c_uint16 * 4),
        ("_sections", ctypes.c_void_p * 4),
        ("_sect", ctypes.c_int),
        ("_rrnum", ctypes.c_int),
        ("_msg_ptr", ctypes.c_void_p),
    ]


class NsRr(ctypes.Structure):
    # glibc arpa/nameser.h struct __ns_rr
    _fields_ = [
        ("name", ctypes.c_char * NS_MAXDNAME),
        ("rtype", ctypes.c_uint16),
        ("rr_class", ctypes.c_uint16),
        ("ttl", ctypes.c_uint32),
        ("rdlength", ctypes.c_uint16),
        ("rdata", ctypes.c_void_p),
    ]


class SockaddrIn(ctypes.Structure):
    # netinet/in.h struct sockaddr_in; port and address in network order
    _fields_ = [
        ("sin_family", ctypes.c_ushort),
        ("sin_port", ctypes.c_uint8 * 2),
        ("sin_addr", ctypes.c_uint8 * 4),
        ("sin_zero", ctypes.c_uint8 * 8),
    ]


class ResState(ctypes.Structure):
    # the leading fields of glibc resolv/bits/types/res_state.h
    # struct __res_state, the ones --server sets
    _fields_ = [
        ("retrans", ctypes.c_int),
        ("retry", ctypes.c_int),
        ("options", ctypes.c_ulong),
        ("nscount", ctypes.c_int),
        ("nsaddr_list", SockaddrIn * 3),
    ]


def parse_server(value: str):
    """``HOST:PORT`` (an IPv4 address) → ``(packed address, port)``."""
    host, sep, port = value.rpartition(":")
    if not sep:
        raise ValueError(f"--server {value!r}: expected HOST:PORT")
    return socket.inet_aton(host), int(port)


def point_at(server: str) -> None:
    """Initialise the resolver, then make ``_res`` name ``server`` as
    its one name server, with EDNS0 on."""
    packed, port = parse_server(server)
    libc = ctypes.CDLL("libc.so.6", use_errno=True)
    libc.__res_init.argtypes = []
    libc.__res_init.restype = ctypes.c_int
    libc.__res_state.argtypes = []
    libc.__res_state.restype = ctypes.POINTER(ResState)
    if libc.__res_init() != 0:
        raise OSError(ctypes.get_errno(), "res_init failed")
    state = libc.__res_state().contents
    ns = state.nsaddr_list[0]
    ns.sin_family = socket.AF_INET
    ns.sin_port[:] = list(port.to_bytes(2, "big"))
    ns.sin_addr[:] = list(packed)
    ns.sin_zero[:] = [0] * 8
    state.nscount = 1
    state.retrans = SERVER_RETRANS_S
    state.retry = SERVER_RETRY
    state.options |= RES_USE_EDNS0


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    server = None
    if args[:1] == ["--server"] and len(args) >= 2:
        server = args[1]
        args = args[2:]
    if len(args) != 2 or args[1] not in QTYPES:
        print(__doc__.split("Usage: ", 1)[1].split("Output:", 1)[0],
              file=sys.stderr)
        return 2
    name, qtype = args[0], QTYPES[args[1]]

    res = ctypes.CDLL("libresolv.so.2", use_errno=True)
    res.res_query.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_char_p, ctypes.c_int]
    res.ns_initparse.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.POINTER(NsMsg)]
    res.ns_parserr.argtypes = [ctypes.POINTER(NsMsg), ctypes.c_int,
                               ctypes.c_int, ctypes.POINTER(NsRr)]
    res.ns_name_uncompress.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_size_t]
    if server is not None:
        try:
            point_at(server)
        except (OSError, ValueError) as e:
            print(f"--server: {e}", file=sys.stderr)
            return 2

    buf = ctypes.create_string_buffer(4096)
    n = res.res_query(name.encode(), C_IN, qtype, buf, len(buf))
    if n < 0:
        print("res_query failed (h_errno path)", file=sys.stderr)
        return 1

    msg = NsMsg()
    if res.ns_initparse(buf, n, ctypes.byref(msg)) != 0:
        print("ns_initparse failed", file=sys.stderr)
        return 1

    def uncompress(ptr: int) -> str:
        out = ctypes.create_string_buffer(NS_MAXDNAME)
        got = res.ns_name_uncompress(msg._msg, msg._eom, ptr, out,
                                     NS_MAXDNAME)
        if got < 0:
            raise ValueError("ns_name_uncompress failed")
        return out.value.decode()

    def parse_section(sect: int, count: int):
        records = []
        opt = None
        for i in range(count):
            rr = NsRr()
            if res.ns_parserr(ctypes.byref(msg), sect, i,
                              ctypes.byref(rr)) != 0:
                raise ValueError(f"ns_parserr failed ({sect},{i})")
            rd = ctypes.string_at(rr.rdata, rr.rdlength) \
                if rr.rdlength else b""
            rec = {"name": rr.name.decode(), "type": rr.rtype,
                   "ttl": rr.ttl}
            if rr.rtype == 41:          # OPT: class carries the payload
                opt = {"payload": rr.rr_class}
                continue
            if rr.rtype == 1 and len(rd) == 4:
                rec["address"] = socket.inet_ntoa(rd)
            elif rr.rtype == 33 and len(rd) >= 6:
                rec["priority"] = (rd[0] << 8) | rd[1]
                rec["weight"] = (rd[2] << 8) | rd[3]
                rec["port"] = (rd[4] << 8) | rd[5]
                rec["target"] = uncompress(rr.rdata + 6)
            elif rr.rtype == 12:
                rec["target"] = uncompress(rr.rdata)
            records.append(rec)
        return records, opt

    try:
        answers, _ = parse_section(NS_S_AN, msg._counts[NS_S_AN])
        additional, opt = parse_section(NS_S_AR, msg._counts[NS_S_AR])
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    print(json.dumps({
        "rcode_ok": True,               # res_query returns <0 otherwise
        "ancount": msg._counts[NS_S_AN],
        "answers": answers,
        "additional": additional,
        "opt": opt,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
