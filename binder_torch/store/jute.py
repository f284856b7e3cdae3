"""ZooKeeper jute wire-format primitives + protocol constants.

Shared by the client (``zk_client.py``) and the in-process test server
(``zk_testserver.py``).  The format is the public ZooKeeper client
protocol: big-endian primitives, length-prefixed frames, and the opcode
set of ZooKeeper 3.4 (the version the reference deploys against,
reference ``Makefile:75-77``).
"""
from __future__ import annotations

import struct
from typing import Optional


class OpCode:
    NOTIFICATION = 0
    CREATE = 1
    DELETE = 2
    EXISTS = 3
    GETDATA = 4
    SETDATA = 5
    GETCHILDREN = 8
    SYNC = 9
    PING = 11
    GETCHILDREN2 = 12
    CLOSE = -11
    SETWATCHES = 101


class Err:
    OK = 0
    NONODE = -101
    NODEEXISTS = -110
    NOTEMPTY = -111
    SESSIONEXPIRED = -112
    BADVERSION = -103


class EventType:
    CREATED = 1
    DELETED = 2
    DATA_CHANGED = 3
    CHILDREN_CHANGED = 4


class KeeperState:
    SYNC_CONNECTED = 3
    EXPIRED = -112


# xids with special meaning on the wire
XID_WATCHER_EVENT = -1
XID_PING = -2


class Buf:
    """Bounds-checked big-endian reader."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("jute: short read")
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def boolean(self) -> bool:
        return self._take(1)[0] != 0

    def buffer(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        return self._take(n)

    def string(self) -> str:
        b = self.buffer()
        return "" if b is None else b.decode("utf-8")

    def remaining(self) -> int:
        return len(self.data) - self.off


def i32(v: int) -> bytes:
    return struct.pack(">i", v)


def i64(v: int) -> bytes:
    return struct.pack(">q", v)


def boolean(v: bool) -> bytes:
    return b"\x01" if v else b"\x00"


def buffer(b: Optional[bytes]) -> bytes:
    if b is None:
        return i32(-1)
    return i32(len(b)) + b


def string(s: str) -> bytes:
    return buffer(s.encode("utf-8"))


def frame(payload: bytes) -> bytes:
    return i32(len(payload)) + payload


# Stat record: czxid, mzxid, ctime, mtime (i64); version, cversion,
# aversion (i32); ephemeralOwner (i64); dataLength, numChildren (i32);
# pzxid (i64)
STAT_FMT = ">qqqqiiiqiiq"
STAT_LEN = struct.calcsize(STAT_FMT)
_NUM_CHILDREN = struct.Struct(">i")
_NUM_CHILDREN_OFF = struct.calcsize(STAT_FMT[:10])


def pack_stat(czxid=0, mzxid=0, ctime=0, mtime=0, version=0, cversion=0,
              aversion=0, ephemeral_owner=0, data_length=0,
              num_children=0, pzxid=0) -> bytes:
    return struct.pack(STAT_FMT, czxid, mzxid, ctime, mtime, version,
                       cversion, aversion, ephemeral_owner, data_length,
                       num_children, pzxid)


def stat_num_children(buf: Buf) -> int:
    """The ``numChildren`` of the Stat at ``buf``'s offset, read in
    place: the reader does not move."""
    return _NUM_CHILDREN.unpack_from(buf.data, buf.off + _NUM_CHILDREN_OFF)[0]


def read_stat(buf: Buf) -> dict:
    vals = struct.unpack(STAT_FMT, buf._take(STAT_LEN))
    keys = ("czxid", "mzxid", "ctime", "mtime", "version", "cversion",
            "aversion", "ephemeralOwner", "dataLength", "numChildren",
            "pzxid")
    return dict(zip(keys, vals))
