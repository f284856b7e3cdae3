"""Local NIC address enumeration (os.networkInterfaces() equivalent).

The recursion layer filters its own addresses out of the upstream resolver
list to avoid recursing into itself (reference ``lib/recursion.js:356-376``,
with a 30s cache).  Python's stdlib has no getifaddrs binding, so this uses
ctypes against libc on Linux, with a getaddrinfo fallback.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import socket
from typing import List

AF_INET = socket.AF_INET
AF_INET6 = socket.AF_INET6


class _sockaddr(ctypes.Structure):
    _fields_ = [("sa_family", ctypes.c_ushort),
                ("sa_data", ctypes.c_char * 14)]


class _sockaddr_in(ctypes.Structure):
    _fields_ = [("sin_family", ctypes.c_ushort),
                ("sin_port", ctypes.c_uint16),
                ("sin_addr", ctypes.c_ubyte * 4)]


class _sockaddr_in6(ctypes.Structure):
    _fields_ = [("sin6_family", ctypes.c_ushort),
                ("sin6_port", ctypes.c_uint16),
                ("sin6_flowinfo", ctypes.c_uint32),
                ("sin6_addr", ctypes.c_ubyte * 16)]


class _ifaddrs(ctypes.Structure):
    pass


_ifaddrs._fields_ = [
    ("ifa_next", ctypes.POINTER(_ifaddrs)),
    ("ifa_name", ctypes.c_char_p),
    ("ifa_flags", ctypes.c_uint),
    ("ifa_addr", ctypes.POINTER(_sockaddr)),
    ("ifa_netmask", ctypes.POINTER(_sockaddr)),
    ("ifa_ifu", ctypes.POINTER(_sockaddr)),
    ("ifa_data", ctypes.c_void_p),
]


def local_addresses() -> List[str]:
    """All IPv4/IPv6 addresses assigned to local interfaces."""
    try:
        return _getifaddrs()
    except (OSError, AttributeError):
        return _fallback()


def _getifaddrs() -> List[str]:
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                       use_errno=True)
    addrlist = ctypes.POINTER(_ifaddrs)()
    if libc.getifaddrs(ctypes.byref(addrlist)) != 0:
        raise OSError(ctypes.get_errno(), "getifaddrs failed")
    out: List[str] = []
    try:
        node = addrlist
        while node:
            ifa = node.contents
            sa = ifa.ifa_addr
            if sa:
                family = sa.contents.sa_family
                if family == AF_INET:
                    sin = ctypes.cast(sa,
                                      ctypes.POINTER(_sockaddr_in)).contents
                    out.append(socket.inet_ntop(AF_INET,
                                                bytes(sin.sin_addr)))
                elif family == AF_INET6:
                    sin6 = ctypes.cast(
                        sa, ctypes.POINTER(_sockaddr_in6)).contents
                    out.append(socket.inet_ntop(AF_INET6,
                                                bytes(sin6.sin6_addr)))
            node = ifa.ifa_next
    finally:
        libc.freeifaddrs(addrlist)
    return out


def _fallback() -> List[str]:
    out = ["127.0.0.1", "::1"]
    try:
        for info in socket.getaddrinfo(socket.gethostname(), None):
            addr = info[4][0]
            if addr not in out:
                out.append(addr)
    except socket.gaierror:
        pass
    return out
