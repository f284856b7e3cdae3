"""In-process LDAPv3 server — the UFDS stand-in for tests and dev rigs.

The reference has **zero** automated coverage of its UFDS integration
(SURVEY §4: recursion is exercised only in real deployments).  This
server closes that gap the same way ``store/zk_testserver.py`` does for
ZooKeeper: a real asyncio server speaking the real wire protocol, backed
by an in-memory DIT, so :class:`~binder_torch.recursion.ufds.LdapClient`
and the recursion refresh loop get protocol-level tests.

Supported: simple bind (credential check), search with base/one/sub
scopes and the filter subset in :mod:`binder_torch.recursion.ufds`
(equality / presence / and / or / not), unbind.  Everything else gets
an ``unwillingToPerform`` result.
"""
from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional

from binder_torch.recursion import ber
from binder_torch.recursion.ufds import (
    APP_BIND_REQUEST,
    APP_BIND_RESPONSE,
    APP_SEARCH_DONE,
    APP_SEARCH_ENTRY,
    APP_SEARCH_REQUEST,
    APP_UNBIND_REQUEST,
    SCOPE_BASE,
    SCOPE_ONE,
    SCOPE_SUB,
    eval_filter,
    normalize_dn,
)

RESULT_SUCCESS = 0
RESULT_PROTOCOL_ERROR = 2
RESULT_INVALID_CREDENTIALS = 49
RESULT_UNWILLING = 53


def _decode_filter(tag: int, content: bytes):
    """Wire filter → the same AST eval_filter consumes."""
    kind = tag & 0x1F
    if kind == 3:      # equalityMatch
        parts = ber.decode_all(content)
        return ("eq", parts[0][1].decode("utf-8", "replace").lower(),
                parts[1][1].decode("utf-8", "replace"))
    if kind == 7:      # present
        return ("present", content.decode("utf-8", "replace").lower())
    if kind in (0, 1):  # and / or
        return ("and" if kind == 0 else "or",
                [_decode_filter(t, c) for t, c in ber.decode_all(content)])
    if kind == 2:      # not
        t, c = ber.decode_all(content)[0]
        return ("not", _decode_filter(t, c))
    raise ber.BerError(f"unsupported filter choice {kind}")


class LdapTestServer:
    """``async with LdapTestServer(...) as srv: ...`` → ``srv.port``."""

    def __init__(self, *, bind_dn: str = "cn=root", password: str = "secret",
                 entries: Optional[Dict[str, Dict[str, List[str]]]] = None,
                 host: str = "127.0.0.1", ssl_context=None,
                 log: Optional[logging.Logger] = None) -> None:
        self.bind_dn = normalize_dn(bind_dn)
        self.password = password
        # dn (normalized) -> {attr(lower): [values]}
        self.entries: Dict[str, Dict[str, List[str]]] = {}
        for dn, attrs in (entries or {}).items():
            self.add_entry(dn, attrs)
        self.host = host
        self.ssl_context = ssl_context   # serve ldaps when set
        self.port: Optional[int] = None
        self.log = log or logging.getLogger("binder.ldap.testserver")
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()   # live client connections
        self.bind_count = 0
        self.search_count = 0

    def add_entry(self, dn: str, attrs: Dict[str, List[str]]) -> None:
        self.entries[normalize_dn(dn)] = {
            k.lower(): list(v) for k, v in attrs.items()}

    def remove_entry(self, dn: str) -> None:
        self.entries.pop(normalize_dn(dn), None)

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, 0, ssl=self.ssl_context)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # drop live clients first: a peer mid-TLS-handshake or
            # retrying connects keeps a handler alive, and on 3.12+
            # wait_closed() waits for all handlers — unbounded
            for w in list(self._writers):
                w.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5)
            except asyncio.TimeoutError:
                self.log.warning("ldap testserver: wait_closed timed out")
            self._server = None

    async def __aenter__(self) -> "LdapTestServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- connection handling --

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        buf = b""
        bound = False
        self._writers.add(writer)
        try:
            while True:
                total = ber.frame_length(buf)
                if not total:
                    chunk = await reader.read(65536)
                    if not chunk:
                        return
                    buf += chunk
                    continue
                frame, buf = buf[:total], buf[total:]
                tag, content, _ = ber.decode_tlv(frame)
                if tag != ber.SEQUENCE:
                    return
                parts = ber.decode_all(content)
                msgid = ber.decode_int(parts[0][1])
                op_tag, op = parts[1]

                if op_tag == APP_BIND_REQUEST:
                    bound = self._do_bind(writer, msgid, op)
                elif op_tag == APP_SEARCH_REQUEST:
                    if not bound:
                        self._send_result(writer, msgid, APP_SEARCH_DONE,
                                          RESULT_UNWILLING, "bind first")
                    else:
                        self._do_search(writer, msgid, op)
                elif op_tag == APP_UNBIND_REQUEST:
                    return
                else:
                    self._send_result(writer, msgid, APP_SEARCH_DONE,
                                      RESULT_UNWILLING, "unsupported op")
                await writer.drain()
        except (ber.BerError, ConnectionError, OSError) as e:
            self.log.debug("ldap testserver connection error: %s", e)
        finally:
            self._writers.discard(writer)
            writer.close()

    def _do_bind(self, writer, msgid: int, op: bytes) -> bool:
        self.bind_count += 1
        parts = ber.decode_all(op)
        ok = False
        diag = "invalid credentials"
        if len(parts) >= 3:
            dn = normalize_dn(parts[1][1].decode("utf-8", "replace"))
            pw = parts[2][1].decode("utf-8", "replace")
            if parts[2][0] != 0x80:
                diag = "only simple auth supported"
            else:
                ok = dn == self.bind_dn and pw == self.password
        self._send_result(writer, msgid, APP_BIND_RESPONSE,
                          RESULT_SUCCESS if ok else RESULT_INVALID_CREDENTIALS,
                          "" if ok else diag)
        return ok

    def _do_search(self, writer, msgid: int, op: bytes) -> None:
        self.search_count += 1
        try:
            parts = ber.decode_all(op)
            base = normalize_dn(parts[0][1].decode("utf-8", "replace"))
            scope = ber.decode_int(parts[1][1])
            flt = _decode_filter(*parts[6])
            want = [a.decode("utf-8", "replace").lower()
                    for _, a in ber.decode_all(parts[7][1])]
        except (ber.BerError, IndexError) as e:
            self._send_result(writer, msgid, APP_SEARCH_DONE,
                              RESULT_PROTOCOL_ERROR, str(e))
            return
        for dn, attrs in self.entries.items():
            if not _in_scope(dn, base, scope):
                continue
            if not eval_filter(flt, attrs):
                continue
            send = {k: v for k, v in attrs.items()
                    if not want or k in want}
            writer.write(self._encode_entry(msgid, dn, send))
        self._send_result(writer, msgid, APP_SEARCH_DONE, RESULT_SUCCESS, "")

    @staticmethod
    def _encode_entry(msgid: int, dn: str,
                      attrs: Dict[str, List[str]]) -> bytes:
        attr_parts = [
            ber.encode_seq([
                ber.encode_str(name),
                ber.encode_seq([ber.encode_str(v) for v in vals],
                               tag=ber.SET),
            ]) for name, vals in attrs.items()]
        entry = ber.encode_seq([
            ber.encode_str(dn),
            ber.encode_seq(attr_parts),
        ], tag=APP_SEARCH_ENTRY)
        return ber.encode_seq([ber.encode_int(msgid), entry])

    @staticmethod
    def _send_result(writer, msgid: int, tag: int, code: int,
                     diag: str) -> None:
        result = ber.encode_seq([
            ber.encode_int(code, tag=ber.ENUMERATED),
            ber.encode_str(""),      # matchedDN
            ber.encode_str(diag),
        ], tag=tag)
        writer.write(ber.encode_seq([ber.encode_int(msgid), result]))


def _in_scope(dn: str, base: str, scope: int) -> bool:
    if scope == SCOPE_BASE:
        return dn == base
    if not (dn == base or dn.endswith("," + base)):
        return False
    if scope == SCOPE_ONE:
        return dn != base and "," not in dn[:len(dn) - len(base) - 1]
    return scope == SCOPE_SUB
