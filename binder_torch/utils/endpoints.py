"""Shared "host[:port]" / "[v6][:port]" endpoint parsing.

One implementation for every surface that names network endpoints as
strings: resolver lists (reference ``lib/recursion.js`` resolver
entries) and ZooKeeper connect strings (reference deployment shape,
``README.md:36-39``).
"""
from __future__ import annotations

from typing import Tuple


def parse_endpoint(entry: str, default_port: int) -> Tuple[str, int]:
    """``"h"``, ``"h:53"``, ``"[::1]"``, ``"[::1]:53"``, bare ``"::1"``."""
    entry = entry.strip()
    if entry.startswith("["):
        host, _, port_s = entry[1:].partition("]")
        port_s = port_s.lstrip(":")
        return host, int(port_s) if port_s else default_port
    if entry.count(":") == 1:          # v4/hostname with port
        host, _, port_s = entry.partition(":")
        return host, int(port_s)
    return entry, default_port         # bare host (incl. bare v6)
