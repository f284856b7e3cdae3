"""DC membership from a watched ``/dcs`` subtree.

The reference discovers other datacenters' binders through UFDS
(``sdc-ldap search objectclass=resolver``, ``lib/recursion.js:202-219``)
— a second coordination system bolted onto the first.  Here the store we
already watch carries the membership: each child of ``/dcs`` is one
datacenter record,

    /dcs/<dc-name>  ->  {"zones": ["east", ...],        # zone cuts owned
                         "peers": ["10.0.0.1:53", ...]}  # its binders

and membership changes propagate exactly like any other mutation — the
children watcher sees a DC join or leave, the data watcher sees its peer
set change, and the registry pushes the new map to whoever registered a
change callback (the Federation, which refreshes the recursion routing
table immediately rather than waiting for the 5-minute discovery poll).

Zone-cut labels are the datacenter labels of the qname routing scheme:
a DC whose record says ``"zones": ["east"]`` is authoritative for
``*.east.<dnsDomain>``.
"""
from __future__ import annotations

import inspect
import json
import logging
import time
from typing import Callable, Dict, List, Optional

DCS_PATH = "/dcs"


class DcRegistry:
    """Watches ``/dcs`` and keeps the live DC-record map.

    Works against any :class:`~binder_torch.store.interface.StoreClient`:
    delivery is purely push-based (children watcher on ``/dcs``, data
    watcher per child), so the fake store's synchronous events and real
    ZooKeeper's async ones both land here — including shard
    ``ReplicaStore`` workers, whose ``/dcs`` subtree is fanned through
    the supervisor's mutation log (``pnode``/``pgone`` frames) so a
    worker sees a DC join or leave exactly like the owner does.
    ``static_records`` seeds the map for config-pinned membership
    (deployments whose store carries no ``/dcs`` at all).
    """

    def __init__(self, store, *, self_name: str, path: str = DCS_PATH,
                 static_records: Optional[List[dict]] = None,
                 log: Optional[logging.Logger] = None,
                 recorder=None) -> None:
        self.store = store
        self.path = "/" + path.strip("/") if path.strip("/") else DCS_PATH
        self.self_name = self_name
        self.log = log or logging.getLogger("binder.federation")
        self.recorder = recorder
        #: dc name -> {"name", "zones", "peers"} (normalized)
        self.records: Dict[str, dict] = {}
        self._watched: set = set()
        self._cbs: List[Callable[[], None]] = []
        self.last_event_mono: Optional[float] = None
        self.joins = 0
        self.leaves = 0
        self._started = False
        for rec in (static_records or []):
            name = str(rec.get("name", "")) or None
            if name is None:
                continue
            norm = self._normalize(name, json.dumps(rec).encode("utf-8"))
            if norm is not None:
                self.records[name] = norm

    # -- lifecycle --

    def start(self) -> None:
        """Attach the watches.  Current state (if the store is
        connected and ``/dcs`` exists) is delivered synchronously by
        the watcher contract; later sessions resync via on_session."""
        if self._started:
            return
        self._started = True
        self.store.watcher(self.path).on("children", self._on_children)
        self.store.on_session(self._resync)

    def on_change(self, cb: Callable[[], None]) -> None:
        self._cbs.append(cb)

    # -- event plumbing --

    def _resync(self) -> None:
        """Session (re-)establishment: pull current state when the
        store reads synchronously (FakeStore family).  Real ZooKeeper
        re-delivers through its re-registered watches instead; its
        getters are coroutines and are skipped here."""
        get_children = getattr(self.store, "get_children", None)
        get_data = getattr(self.store, "get_data", None)
        if (not callable(get_children) or not callable(get_data)
                or inspect.iscoroutinefunction(get_children)):
            return
        kids = get_children(self.path)
        if kids is None:
            # /dcs absent (or the store went dark): keep what we have —
            # a local-session blip must not evict the membership map
            return
        self._on_children(kids)
        for k in kids:
            data = get_data(self.path + "/" + k)
            if data is not None:
                self._on_data(k, data)

    def _on_children(self, kids) -> None:
        names = set(kids or [])
        for k in sorted(names - self._watched):
            self._watched.add(k)
            # the data watcher delivers the child's current record
            # synchronously on attach (fake store) or shortly after
            # (real ZK) — dc-join fires from _on_data either way
            self.store.watcher(self.path + "/" + k).on(
                "data", lambda data, _k=k: self._on_data(_k, data))
        changed = False
        for k in sorted(self._watched - names):
            self._watched.discard(k)
            if self.records.pop(k, None) is not None:
                changed = True
                self.leaves += 1
                self._event("dc-leave", dc=k)
        if changed:
            self.last_event_mono = time.monotonic()
            self._notify()

    def _on_data(self, dc: str, data) -> None:
        rec = self._normalize(dc, data)
        if rec is None:
            # garbage record: a DC we can't route to is a DC we don't
            # know — drop any previous state rather than keep routing
            # on stale peers
            if self.records.pop(dc, None) is not None:
                self.last_event_mono = time.monotonic()
                self._notify()
            return
        prev = self.records.get(dc)
        if prev == rec:
            return
        self.records[dc] = rec
        self.last_event_mono = time.monotonic()
        if prev is None:
            self.joins += 1
            self._event("dc-join", dc=dc, zones=",".join(rec["zones"]),
                        peers=len(rec["peers"]))
        self._notify()

    def _normalize(self, dc: str, data) -> Optional[dict]:
        try:
            obj = json.loads(bytes(data).decode("utf-8")) if data else None
        except (ValueError, UnicodeDecodeError):
            obj = None
        if not isinstance(obj, dict):
            self.log.warning("federation: undecodable DC record at %s/%s",
                             self.path, dc)
            return None
        zones = obj.get("zones") or [dc]
        peers = obj.get("peers") or []
        if not isinstance(zones, list) or not isinstance(peers, list):
            self.log.warning("federation: malformed DC record at %s/%s",
                             self.path, dc)
            return None
        return {"name": dc,
                "zones": [str(z).lower() for z in zones],
                "peers": [str(p) for p in peers]}

    def _event(self, kind: str, **fields) -> None:
        if self.recorder is not None:
            try:
                self.recorder.record(kind, **fields)
            except Exception:  # noqa: BLE001 — observability never fatal
                pass

    def _notify(self) -> None:
        for cb in list(self._cbs):
            try:
                cb()
            except Exception:  # noqa: BLE001 — one consumer must not
                self.log.exception("federation: change callback failed")

    # -- the routing view --

    def foreign_zone_map(self) -> Dict[str, List[str]]:
        """zone label -> peer addresses, excluding our own DC — exactly
        the shape the recursion routing table consumes."""
        out: Dict[str, List[str]] = {}
        for dc, rec in self.records.items():
            if dc == self.self_name:
                continue
            for z in rec["zones"]:
                lst = out.setdefault(z, [])
                for p in rec["peers"]:
                    if p not in lst:
                        lst.append(p)
        return out

    def zone_owner(self, zone: str) -> Optional[str]:
        """Owning (foreign) DC name for a zone label, or None."""
        for dc, rec in self.records.items():
            if dc != self.self_name and zone in rec["zones"]:
                return dc
        return None

    def introspect(self) -> dict:
        last = self.last_event_mono
        return {
            "path": self.path,
            "self": self.self_name,
            "dcs": {dc: {"zones": list(rec["zones"]),
                         "peers": list(rec["peers"])}
                    for dc, rec in sorted(self.records.items())},
            "joins": self.joins,
            "leaves": self.leaves,
            "last_event_age_seconds": (
                None if last is None else time.monotonic() - last),
        }
