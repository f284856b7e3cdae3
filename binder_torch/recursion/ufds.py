"""UFDS resolver discovery: a from-scratch LDAPv3 client.

The reference discovers other datacenters' binders with the ``ufds`` npm
package: ``listResolvers(region)`` runs the logical search ``sdc-ldap
search -b 'region=<region>, o=smartdc' objectclass=resolver``
(``lib/recursion.js:16-19,202-219``), and UFDS's own address is resolved
*through binder's ZK mirror* before connecting, since binder IS the DNS
(``lib/recursion.js:105-127``).  This module rebuilds that stack natively:

- :class:`LdapClient` — asyncio LDAPv3 (RFC 4511) over the BER codec:
  simple bind, search (equality / presence / and / or / not filters),
  unbind.  TLS optional (``ldaps://`` URLs — internal directories use
  self-signed certs, so verification is off by default, matching the
  reference deployment's ldapjs configuration; the ``recursion.ufds.ca``
  config knob opts into CA-verified TLS, which the reference cannot do).
- :class:`UfdsResolverSource` — the :class:`ResolverSource` implementation
  wired into :class:`~binder_torch.recursion.recursion.Recursion` when the
  config carries ``recursion.ufds.url`` (sapi template
  ``sapi_manifests/binder/template:12-27``).
"""
from __future__ import annotations

import asyncio
import logging
import ssl
from typing import Dict, List, Optional, Sequence, Tuple

from binder_torch.recursion import ber

# LDAP application tags (RFC 4511 §4.1.1), constructed form
APP_BIND_REQUEST = 0x60
APP_BIND_RESPONSE = 0x61
APP_UNBIND_REQUEST = 0x42   # primitive NULL
APP_SEARCH_REQUEST = 0x63
APP_SEARCH_ENTRY = 0x64
APP_SEARCH_DONE = 0x65

SCOPE_BASE = 0
SCOPE_ONE = 1
SCOPE_SUB = 2

RESULT_SUCCESS = 0

CONNECT_TIMEOUT = 3.0       # sapi template connectTimeout: 3000
REQUEST_TIMEOUT = 120.0     # sapi template clientTimeout: 120000


class LdapError(Exception):
    def __init__(self, msg: str, result_code: Optional[int] = None) -> None:
        super().__init__(msg)
        self.result_code = result_code


# -- filters ----------------------------------------------------------------

def parse_filter(s: str):
    """Parse an RFC 4515 filter string into an AST:
    ('eq', attr, val) | ('present', attr) | ('and'|'or', [..]) |
    ('not', node).  Substring/extensible matching is out of scope (the
    reference's one query needs none of it)."""
    s = s.strip()
    if not s.startswith("("):
        s = "(" + s + ")"
    node, pos = _parse_one(s, 0)
    if pos != len(s):
        raise LdapError(f"trailing garbage in filter: {s[pos:]!r}")
    return node


def _parse_one(s: str, pos: int):
    if s[pos] != "(":
        raise LdapError(f"expected '(' at {pos} in {s!r}")
    pos += 1
    if pos >= len(s):
        raise LdapError("unterminated filter")
    c = s[pos]
    if c in "&|":
        kids = []
        pos += 1
        while pos < len(s) and s[pos] == "(":
            kid, pos = _parse_one(s, pos)
            kids.append(kid)
        if pos >= len(s) or s[pos] != ")":
            raise LdapError("unterminated and/or filter")
        return ("and" if c == "&" else "or", kids), pos + 1
    if c == "!":
        kid, pos = _parse_one(s, pos + 1)
        if pos >= len(s) or s[pos] != ")":
            raise LdapError("unterminated not filter")
        return ("not", kid), pos + 1
    end = s.find(")", pos)
    if end < 0:
        raise LdapError("unterminated comparison")
    body = s[pos:end]
    if "=" not in body:
        raise LdapError(f"no '=' in filter component {body!r}")
    attr, _, val = body.partition("=")
    attr = attr.strip()
    if not attr:
        raise LdapError("empty attribute in filter")
    if val == "*":
        return ("present", attr), end + 1
    if "*" in val:
        raise LdapError("substring filters not supported")
    return ("eq", attr, val), end + 1


def encode_filter(node) -> bytes:
    kind = node[0]
    if kind == "eq":
        return ber.encode_seq(
            [ber.encode_str(node[1]), ber.encode_str(node[2])], tag=0xA3)
    if kind == "present":
        return ber.encode_str(node[1], tag=0x87)
    if kind == "and":
        return ber.encode_seq([encode_filter(k) for k in node[1]], tag=0xA0)
    if kind == "or":
        return ber.encode_seq([encode_filter(k) for k in node[1]], tag=0xA1)
    if kind == "not":
        return ber.encode_seq([encode_filter(node[1])], tag=0xA2)
    raise LdapError(f"unknown filter node {kind!r}")


def eval_filter(node, attrs: Dict[str, List[str]]) -> bool:
    """Evaluate a filter AST against a case-folded attribute dict
    (used by the in-process test directory)."""
    kind = node[0]
    if kind == "eq":
        vals = attrs.get(node[1].lower(), [])
        return any(v.lower() == node[2].lower() for v in vals)
    if kind == "present":
        return node[1].lower() in attrs
    if kind == "and":
        return all(eval_filter(k, attrs) for k in node[1])
    if kind == "or":
        return any(eval_filter(k, attrs) for k in node[1])
    if kind == "not":
        return not eval_filter(node[1], attrs)
    raise LdapError(f"unknown filter node {kind!r}")


def normalize_dn(dn: str) -> str:
    return ",".join(part.strip().lower() for part in dn.split(","))


# -- client -----------------------------------------------------------------

class LdapClient:
    """Asyncio LDAPv3 client: connect / simple bind / search / unbind."""

    def __init__(self, host: str, port: int = 389, *, tls: bool = False,
                 tls_context: Optional[ssl.SSLContext] = None,
                 server_name: Optional[str] = None,
                 connect_timeout: float = CONNECT_TIMEOUT,
                 request_timeout: float = REQUEST_TIMEOUT,
                 log: Optional[logging.Logger] = None) -> None:
        self.host = host
        self.port = port
        self.tls = tls
        # a caller-built verifying context (None keeps the
        # reference-compatible trust-anything default); server_name is
        # the certificate identity to check when it differs from the
        # dialed host (UFDS is dialed by ZK-resolved IP, verified
        # against its DNS name)
        self.tls_context = tls_context
        self.server_name = server_name
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self.log = log or logging.getLogger("binder.ldap")
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._msgid = 0
        self._buf = b""

    @property
    def connected(self) -> bool:
        return self._writer is not None and not self._writer.is_closing()

    async def connect(self) -> None:
        sslctx = None
        kwargs = {}
        if self.tls:
            if self.tls_context is not None:
                sslctx = self.tls_context
            else:
                # internal DC directory, self-signed certs (reference
                # ldapjs config does the equivalent); opt into
                # verification via UfdsResolverSource's `ca` knob
                sslctx = ssl.create_default_context()
                sslctx.check_hostname = False
                sslctx.verify_mode = ssl.CERT_NONE
            if self.server_name:
                kwargs["server_hostname"] = self.server_name
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port, ssl=sslctx,
                                    **kwargs),
            self.connect_timeout)
        self._buf = b""

    async def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.write(
                    ber.encode_seq([ber.encode_int(self._next_id()),
                                    ber.tlv(APP_UNBIND_REQUEST, b"")]))
                await self._writer.drain()
            except (ConnectionError, OSError):
                pass
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError, asyncio.CancelledError):
                pass
        self._reader = self._writer = None

    def _next_id(self) -> int:
        self._msgid += 1
        return self._msgid

    async def _send(self, msgid: int, op: bytes) -> None:
        if not self.connected:
            raise LdapError("not connected")
        self._writer.write(ber.encode_seq([ber.encode_int(msgid), op]))
        await self._writer.drain()

    async def _read_message(self) -> Tuple[int, int, bytes]:
        """Read one LDAPMessage → (msgid, op_tag, op_content)."""
        while True:
            total = ber.frame_length(self._buf)
            if total:
                frame, self._buf = self._buf[:total], self._buf[total:]
                tag, content, _ = ber.decode_tlv(frame)
                if tag != ber.SEQUENCE:
                    raise LdapError(f"bad LDAPMessage tag {tag:#x}")
                parts = ber.decode_all(content)
                if len(parts) < 2 or parts[0][0] != ber.INTEGER:
                    raise LdapError("malformed LDAPMessage")
                return (ber.decode_int(parts[0][1]),
                        parts[1][0], parts[1][1])
            chunk = await asyncio.wait_for(self._reader.read(65536),
                                           self.request_timeout)
            if not chunk:
                raise LdapError("connection closed by server")
            self._buf += chunk

    @staticmethod
    def _parse_result(content: bytes) -> Tuple[int, str]:
        parts = ber.decode_all(content)
        if len(parts) < 3:
            raise LdapError("malformed LDAPResult")
        code = ber.decode_int(parts[0][1])
        diag = parts[2][1].decode("utf-8", "replace")
        return code, diag

    async def bind(self, dn: str, password: str) -> None:
        msgid = self._next_id()
        op = ber.encode_seq([
            ber.encode_int(3),                     # version
            ber.encode_str(dn),
            ber.encode_str(password, tag=0x80),    # simple auth [0]
        ], tag=APP_BIND_REQUEST)
        await self._send(msgid, op)
        rid, tag, content = await self._read_message()
        if rid != msgid or tag != APP_BIND_RESPONSE:
            raise LdapError(f"unexpected bind reply (id {rid}, tag {tag:#x})")
        code, diag = self._parse_result(content)
        if code != RESULT_SUCCESS:
            raise LdapError(f"bind failed: {diag or code}", code)

    async def search(self, base: str, filter_str: str, *,
                     scope: int = SCOPE_SUB,
                     attributes: Sequence[str] = ()) \
            -> List[Tuple[str, Dict[str, List[str]]]]:
        """Return [(dn, {attr: [values]}), ...]; attr keys lowercased."""
        msgid = self._next_id()
        op = ber.encode_seq([
            ber.encode_str(base),
            ber.encode_int(scope, tag=ber.ENUMERATED),
            ber.encode_int(0, tag=ber.ENUMERATED),   # derefAliases: never
            ber.encode_int(0),                       # sizeLimit
            ber.encode_int(0),                       # timeLimit
            ber.encode_bool(False),                  # typesOnly
            encode_filter(parse_filter(filter_str)),
            ber.encode_seq([ber.encode_str(a) for a in attributes]),
        ], tag=APP_SEARCH_REQUEST)
        await self._send(msgid, op)

        entries: List[Tuple[str, Dict[str, List[str]]]] = []
        while True:
            rid, tag, content = await self._read_message()
            if rid != msgid:
                continue   # stale reply from an abandoned operation
            if tag == APP_SEARCH_ENTRY:
                entries.append(self._parse_entry(content))
            elif tag == APP_SEARCH_DONE:
                code, diag = self._parse_result(content)
                if code != RESULT_SUCCESS:
                    raise LdapError(f"search failed: {diag or code}", code)
                return entries
            else:
                raise LdapError(f"unexpected search reply tag {tag:#x}")

    @staticmethod
    def _parse_entry(content: bytes) -> Tuple[str, Dict[str, List[str]]]:
        parts = ber.decode_all(content)
        if len(parts) != 2:
            raise LdapError("malformed SearchResultEntry")
        dn = parts[0][1].decode("utf-8", "replace")
        attrs: Dict[str, List[str]] = {}
        for tag, body in ber.decode_all(parts[1][1]):
            kv = ber.decode_all(body)
            if len(kv) != 2:
                continue
            name = kv[0][1].decode("utf-8", "replace").lower()
            vals = [v.decode("utf-8", "replace")
                    for _, v in ber.decode_all(kv[1][1])]
            attrs[name] = vals
        return dn, attrs


# -- the ResolverSource implementation --------------------------------------

def parse_ldap_url(url: str) -> Tuple[str, Optional[str], Optional[int]]:
    """'ldaps://host[:port]' → (scheme, host, port); bracketed IPv6
    literals ('ldaps://[fd00::5]:636') keep their colons."""
    scheme, sep, rest = url.partition("://")
    if not sep:
        scheme, rest = "ldaps", url
    if rest.startswith("["):
        end = rest.find("]")
        if end < 0:
            raise LdapError(f"unterminated IPv6 literal in {url!r}")
        host, rest = rest[1:end], rest[end + 1:]
        port = rest[1:] if rest.startswith(":") else ""
    else:
        host, _, port = rest.partition(":")
    try:
        return scheme.lower(), host or None, int(port) if port else None
    except ValueError:
        raise LdapError(f"bad port in ldap url {url!r}")


class UfdsResolverSource:
    """Resolver discovery against a UFDS LDAP directory.

    ``init`` resolves the directory's DNS name through binder's own ZK
    mirror — binder *is* the DNS, so it can't use a stub resolver
    (``lib/recursion.js:105-127``) — then binds.  ``list_resolvers``
    searches ``region=<region>, o=smartdc`` for ``objectclass=resolver``
    entries carrying ``datacenter`` and ``ip`` attributes
    (``lib/recursion.js:16-19`` and the ufds client's listResolvers)."""

    def __init__(self, config: dict,
                 log: Optional[logging.Logger] = None) -> None:
        self.url = config.get("url", "")
        self.bind_dn = config.get("bindDN", "")
        self.bind_password = config.get("bindPassword", "")
        self.connect_timeout = config.get("connectTimeout", 3000) / 1000.0
        self.request_timeout = config.get("clientTimeout", 120000) / 1000.0
        # CA verification opt-in (beats the reference: lib/recursion.js
        # 129-148 trusts any certificate).  `ca` is a PEM bundle path;
        # when set, the chain is verified against it and the certificate
        # identity is checked against `tlsServerName` if given, else the
        # url's DNS name (the dial target itself is usually a
        # ZK-resolved IP).  Unset keeps the reference-compatible
        # trust-anything default.  Built once here so a bad CA path is
        # an immediate config error, not a silently retried warning.
        self.ca = config.get("ca")
        self.tls_server_name = config.get("tlsServerName")
        if self.tls_server_name and not self.ca:
            # identity pinning without a trust root would silently fall
            # back to the trust-anything context — refuse instead
            raise LdapError("ufds.tlsServerName requires ufds.ca")
        self._tls_context: Optional[ssl.SSLContext] = None
        self._server_name: Optional[str] = None
        if self.ca:
            try:
                self._tls_context = ssl.create_default_context(
                    cafile=self.ca)
            except (OSError, ssl.SSLError) as e:
                raise LdapError(f"cannot load ufds.ca {self.ca!r}: {e}")
            url_host = None
            if self.url:
                try:
                    _, h, _ = parse_ldap_url(self.url)
                except LdapError:
                    h = None   # init() re-parses and raises with context
                if h and not _is_address(h):
                    url_host = h
            self._server_name = self.tls_server_name or url_host
            if self._server_name is None:
                # nothing to check the certificate identity against
                # (address-literal url, no pinned name): chain
                # verification only
                self._tls_context.check_hostname = False
        self.log = log or logging.getLogger("binder.ufds")
        self.client: Optional[LdapClient] = None
        self._addr: Optional[Tuple[str, int, bool]] = None

    async def init(self, zk_cache) -> None:
        scheme, host, port = parse_ldap_url(self.url)
        tls = scheme == "ldaps"
        if port is None:
            port = 636 if tls else 389
        addr = host
        if addr is None:
            raise LdapError(f"no host in ufds url {self.url!r}")
        # resolve through the ZK mirror unless the config already names an
        # address literal
        if not _is_address(addr):
            if not zk_cache.is_ready():
                raise LdapError("ZK is not yet available")
            node = zk_cache.lookup(addr)
            data = getattr(node, "data", None)
            kids = getattr(node, "children", None) or []
            if (node is None or not data or data.get("type") != "service"
                    or not kids):
                raise LdapError("not yet able to resolve ufds")
            kid = kids[0]
            addr = kid.data[kid.data["type"]]["address"]
        self._addr = (addr, port, tls)
        await self._connect()

    async def _connect(self) -> None:
        assert self._addr is not None
        if self.client is not None:
            # init retries / reconnects must not leak the previous socket
            await self.client.close()
            self.client = None
        host, port, tls = self._addr
        client = LdapClient(host, port, tls=tls,
                            tls_context=self._tls_context,
                            server_name=self._server_name,
                            connect_timeout=self.connect_timeout,
                            request_timeout=self.request_timeout,
                            log=self.log)
        await client.connect()
        try:
            await client.bind(self.bind_dn, self.bind_password)
        except BaseException:
            await client.close()
            raise
        self.client = client
        self.log.info("UFDS connected (%s:%d%s)", host, port,
                      " tls" if tls else "")

    async def list_resolvers(self, region_name: str) -> List[Dict[str, str]]:
        if self.client is None or not self.client.connected:
            if self._addr is None:
                raise LdapError("UFDS is not available yet.")
            await self._connect()
        base = f"region={region_name}, o=smartdc"
        try:
            entries = await self.client.search(
                base, "(objectclass=resolver)",
                attributes=("datacenter", "ip"))
        except (LdapError, ber.BerError, ConnectionError, OSError,
                asyncio.TimeoutError):
            # drop the connection so the next refresh reconnects — a
            # malformed frame also poisons the stream buffer, so the
            # connection is unusable either way
            await self.close()
            raise
        out = []
        for dn, attrs in entries:
            dc = (attrs.get("datacenter") or [""])[0]
            ip = (attrs.get("ip") or [""])[0]
            if dc and ip:
                out.append({"datacenter": dc, "ip": ip})
            else:
                self.log.warning("UFDS resolver entry %s missing "
                                 "datacenter/ip, skipping", dn)
        return out

    async def close(self) -> None:
        if self.client is not None:
            await self.client.close()
            self.client = None


def _is_address(host: str) -> bool:
    import ipaddress
    try:
        ipaddress.ip_address(host)
        return True
    except ValueError:
        return False
