"""In-memory fake coordination store.

Stands in for ZooKeeper in tests and benchmarks — the piece the reference
lacks entirely (SURVEY §4: its tests require a live ZK at 127.0.0.1:2181).
Implements the ``StoreClient`` interface with synchronous watch delivery:

- ``mkdirp/create/set_data/delete/rmr`` mutate the znode tree and fire the
  affected watchers exactly like a ZK server would (children event on the
  parent, data event on the node).
- Initial state is delivered when a listener attaches to a watcher, which
  is when the mirror cache rebinds (matching zkstream's register-then-fetch
  behavior the cache relies on, reference ``lib/zk.js:209-223``).
- ``expire_session()`` simulates ZK session loss + re-establishment: the
  ``session`` callbacks re-fire and the cache rebuilds its watch tree
  (reference ``lib/zk.js:45-47``).
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from binder_torch.store.interface import (SessionStateMixin, StoreClient,
                                          Watcher)


class _Node:
    __slots__ = ("data", "children")

    def __init__(self, data: bytes = b"") -> None:
        self.data = data
        self.children: Dict[str, _Node] = {}


class FakeStore(SessionStateMixin, StoreClient):
    def __init__(self, recorder=None) -> None:
        self._init_session_state(recorder)
        self._root = _Node()
        self._watchers: Dict[str, Watcher] = {}
        # mirror fast binding: registered node SOURCES (a MirrorCache's
        # domain->TreeNode index).  Events route straight to the bound
        # node by domain — no Watcher object, no stored path string, no
        # binding dict of our own: the mirror's node index IS the watch
        # table, so the per-znode watch costs literally nothing extra.
        # That is what makes a million-name mirror affordable.
        self._sources: List[Dict[str, object]] = []
        self._session_cbs: List[Callable[[], None]] = []
        self._connected = False

    # -- StoreClient interface --

    def on_session(self, cb: Callable[[], None]) -> None:
        self._session_cbs.append(cb)
        if self._connected:
            cb()

    def watcher(self, path: str) -> Watcher:
        w = self._watchers.get(path)
        if w is None:
            w = _FakeWatcher(self, path)
            self._watchers[path] = w
        return w

    def bind_source(self, nodes: Dict[str, object]) -> bool:
        """Register a mirror's domain->node index as the watch table:
        fired events route to ``nodes[domain]`` directly."""
        if nodes not in self._sources:
            self._sources.append(nodes)
        return True

    def bind_node(self, path: str, node) -> None:
        """With source routing the bind itself is just the initial
        state delivery — membership in the mirror's node index (the
        registered source) is what keeps events flowing."""
        n = self._find(path)
        if n is None or not self._connected:
            return
        # same delivery order as the generic watcher path: children
        # (creating the kid nodes) before data
        node.on_children_changed(sorted(n.children))
        node.on_data_changed(n.data)

    def unbind_node(self, path: str, node) -> None:
        """No-op: unbinding is the node leaving its mirror's index."""

    def is_connected(self) -> bool:
        return self._connected

    def close(self) -> None:
        self._session_transition("closed", "close() called")
        self._connected = False

    # -- session simulation --

    def start_session(self) -> None:
        self._connected = True
        self._session_transition("connected", "start_session")
        for cb in list(self._session_cbs):
            cb()

    def expire_session(self) -> None:
        """Session loss immediately followed by a new session."""
        self._connected = False
        self._session_transition("expired", "expire_session")
        self.start_session()

    def lose_session(self) -> None:
        """Session loss with NO re-establishment: the store goes dark
        and the mirror starts aging — the silent staleness failure the
        introspection layer exists to surface."""
        self._connected = False
        self._session_transition("degraded", "lose_session")

    # -- tree access --

    def _find(self, path: str) -> Optional[_Node]:
        node = self._root
        for part in _parts(path):
            node = node.children.get(part)
            if node is None:
                return None
        return node

    def exists(self, path: str) -> bool:
        return self._find(path) is not None

    def get_data(self, path: str) -> Optional[bytes]:
        n = self._find(path)
        return None if n is None else n.data

    def get_children(self, path: str) -> Optional[List[str]]:
        n = self._find(path)
        return None if n is None else sorted(n.children)

    # -- mutations (the registrar-equivalent write surface) --

    def mkdirp(self, path: str, data: bytes = b"") -> None:
        """Create *path* and any missing parents (test/helper.js zkMkdirP
        analog, reference ``test/helper.js:98-129``)."""
        node = self._root
        parent_path = "/"
        prefix = ""
        for part in _parts(path):
            prefix += "/" + part
            child = node.children.get(part)
            if child is None:
                child = _Node()
                node.children[part] = child
                self._fire_children(parent_path, node)
            node = child
            parent_path = prefix
        if data:
            node.data = data
            self._fire_data(prefix, node)

    def create(self, path: str, data: bytes = b"") -> None:
        parent_path, name = _split(path)
        parent = self._find(parent_path)
        if parent is None:
            raise KeyError(f"no such parent: {parent_path}")
        if name in parent.children:
            raise KeyError(f"node exists: {path}")
        parent.children[name] = _Node(data)
        self._fire_children(parent_path, parent)
        if data:
            self._fire_data(path, parent.children[name])

    def set_data(self, path: str, data: bytes) -> None:
        node = self._find(path)
        if node is None:
            raise KeyError(f"no such node: {path}")
        node.data = data
        self._fire_data(path, node)

    def delete(self, path: str) -> None:
        parent_path, name = _split(path)
        parent = self._find(parent_path)
        if parent is None or name not in parent.children:
            raise KeyError(f"no such node: {path}")
        if parent.children[name].children:
            raise KeyError(f"node has children: {path}")
        del parent.children[name]
        self._fire_children(parent_path, parent)

    def rmr(self, path: str) -> None:
        """Recursive delete (test/helper.js zkRmr analog)."""
        node = self._find(path)
        if node is None:
            return
        for kid in list(node.children):
            self.rmr(path.rstrip("/") + "/" + kid)
        self.delete(path)

    # convenience for fixtures
    def put_json(self, path: str, obj) -> None:
        data = json.dumps(obj).encode("utf-8")
        if self.exists(path):
            self.set_data(path, data)
        else:
            self.mkdirp(path, data)

    # -- watch plumbing --

    def _fire_children(self, path: str, node: _Node) -> None:
        if not self._connected:
            return
        w = self._watchers.get(path)
        if w is not None:
            w.emit("children", sorted(node.children))
        if self._sources:
            dom = _path_domain(path)
            for src in self._sources:
                tn = src.get(dom)
                if tn is not None:
                    tn.on_children_changed(sorted(node.children))

    def _fire_data(self, path: str, node: _Node) -> None:
        if not self._connected:
            return
        w = self._watchers.get(path)
        if w is not None:
            w.emit("data", node.data)
        if self._sources:
            dom = _path_domain(path)
            for src in self._sources:
                tn = src.get(dom)
                if tn is not None:
                    tn.on_data_changed(node.data)


class _FakeWatcher(Watcher):
    """Watcher that delivers current state as soon as a listener attaches."""

    __slots__ = ("_store",)

    def __init__(self, store: FakeStore, path: str) -> None:
        super().__init__(path)
        self._store = store

    def on(self, event: str, cb: Callable) -> None:
        super().on(event, cb)
        node = self._store._find(self.path)
        if node is None or not self._store._connected:
            return
        if event == "children":
            cb(sorted(node.children))
        elif event == "data":
            cb(node.data)

    def bind_node(self, tn) -> None:
        super().bind_node(tn)
        node = self._store._find(self.path)
        if node is None or not self._store._connected:
            return
        # same delivery order as two on() calls: children (creating the
        # kid nodes) before data
        tn.on_children_changed(sorted(node.children))
        tn.on_data_changed(node.data)


def load_state(store: FakeStore, nodes: Mapping[str, object]) -> int:
    """Load a plain ``path -> node data`` mapping into the store tree.

    Each value is the node's data: ``bytes`` as they are, anything else
    encoded as JSON exactly as :meth:`FakeStore.put_json` encodes it.
    Missing parents are created with empty data, as ``mkdirp`` creates
    them.  Like :func:`populate_synthetic` this inserts directly and
    fires no watcher, so call it BEFORE ``start_session()``; the mirror
    picks the whole tree up on its initial build.  Returns the number
    of entries loaded."""
    for path, data in nodes.items():
        if not isinstance(data, bytes):
            data = json.dumps(data).encode("utf-8")
        node = store._root
        for part in _parts(path):
            nxt = node.children.get(part)
            if nxt is None:
                nxt = _Node()
                node.children[part] = nxt
            node = nxt
        node.data = data
    return len(nodes)


def populate_synthetic(store: FakeStore, domain: str, hosts: int,
                       racks: int = 0,
                       subtree: str = "zs") -> int:
    """Bulk-build a synthetic production-scale zone directly into the
    store tree (bench/smoke surface, zone_scale axis): ``hosts``
    host records spread across ``racks`` service-style parents under
    ``<subtree>.<domain>``, with deterministic unique addresses.

    Builds the zone as a :func:`load_state` mapping — watcher firing is
    pointless before a session starts, and at a million names the
    per-node ``mkdirp`` path walk would dominate the build.  Call BEFORE
    ``start_session()``; the mirror picks the whole zone up on its
    initial build.  Returns the number of host nodes created."""
    if racks <= 0:
        racks = max(1, min(1024, hosts // 512))
    base = "/" + "/".join(p for p in reversed(
        (subtree + "." + domain).split(".")) if p)
    nodes: Dict[str, bytes] = {}
    rack_paths = []
    for r in range(racks):
        rp = f"{base}/r{r:04d}"
        nodes[rp] = (b'{"type": "service", "service": {"srvce": "_zs", '
                     b'"proto": "_tcp", "port": 80}}')
        rack_paths.append(rp)
    for i in range(hosts):
        addr = f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}"
        nodes[f"{rack_paths[i % racks]}/h{i:06d}"] = (
            b'{"type": "host", "host": {"address": "%s"}}'
            % addr.encode())
    load_state(store, nodes)
    return hosts


def _parts(path: str) -> List[str]:
    return [p for p in path.split("/") if p]


def _path_domain(path: str) -> str:
    """``/com/foo/web -> web.foo.com`` — the (case-preserving) inverse
    of ``cache.domain_to_path``, used to route fired events to bound
    mirror nodes.  Case sensitivity matches the historical exact-path
    watcher match: a store path whose case differs from the mirror's
    lowercased registration never matched before and still doesn't."""
    return ".".join(reversed([p for p in path.split("/") if p]))


def _split(path: str) -> Tuple[str, str]:
    parts = _parts(path)
    if not parts:
        raise KeyError("cannot operate on root")
    return "/" + "/".join(parts[:-1]), parts[-1]
