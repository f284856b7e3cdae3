"""Coordination-store client interface.

The reference binds its cache directly to zkstream (reference
``lib/zk.js:33-39``) — its biggest testability gap (SURVEY §4: every test
needs a live ZooKeeper).  The rebuild defines this narrow interface instead,
with two implementations:

- ``binder_torch.store.fake.FakeStore`` — in-memory, synchronous; used by
  tests and ``bench.py``.
- ``binder_torch.store.zk_client.ZKClient`` — real ZooKeeper wire protocol
  (jute) over asyncio.

Semantics modeled on zkstream's surface as consumed by the cache:

- The client emits a ``session`` event whenever a (new) session is
  established; the cache responds by re-binding its whole watch tree
  (reference ``lib/zk.js:45-47``).
- ``watcher(path)`` returns a ``Watcher`` handle.  Registering listeners is
  idempotent w.r.t. rebinds: the cache clears listeners and re-adds them on
  every rebind.  After (re)registration the store fires the current state —
  a ``children`` event with the current child names and a ``data`` event
  with the current node bytes — and again on every subsequent change.
- Watch events carry state, not deltas: ``children`` always delivers the
  full current child list.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List

#: Session states shared by every StoreClient implementation.  The
#: distinction between "never-connected" and "degraded" is the one the
#: plain is_connected() bool could not express: a binder that has not
#: yet reached its ensemble serves nothing, while one whose session was
#: lost keeps serving an aging mirror — operationally very different
#: failures (the second is the silent one the introspection layer
#: exists to surface).
SESSION_STATES = ("never-connected", "connected", "degraded", "expired",
                  "closed")


class SessionStateMixin:
    """Session state machine + transition history for store clients.

    Tracks the exact monotonic timestamp of every state transition so
    ``disconnected_seconds()`` is measured, never inferred, and keeps a
    bounded transition history (the reconnect/backoff record served by
    the introspection snapshot).  An optional flight recorder receives
    a ``session-transition`` event per edge."""

    def _init_session_state(self, recorder=None, history: int = 64) -> None:
        self._session_state = "never-connected"
        self._state_since = time.monotonic()
        # monotonic instant the session was lost (set on leaving
        # "connected", cleared on re-entering it); None while connected
        # or never connected
        self._disconnected_since = None
        self.session_establishments = 0
        self._transitions = deque(maxlen=history)
        self._session_recorder = recorder

    def _session_transition(self, new: str, reason: str = "") -> None:
        old = self._session_state
        if new == old:
            return
        now = time.monotonic()
        self._session_state = new
        self._state_since = now
        if new == "connected":
            self._disconnected_since = None
            self.session_establishments += 1
        elif old == "connected":
            self._disconnected_since = now
        self._transitions.append({
            "t_mono": now, "t_wall": time.time(),
            "from": old, "to": new, "reason": reason,
        })
        rec = self._session_recorder
        if rec is not None:
            rec.record("session-transition", frm=old, to=new,
                       reason=reason)

    def session_state(self) -> str:
        return self._session_state

    def disconnected_seconds(self):
        """Exact seconds since the session was lost: 0.0 while
        connected, None when no session was ever established (there is
        no loss instant to measure from), else the measured age of the
        connected→lost transition."""
        if self._session_state == "connected":
            return 0.0
        if self._disconnected_since is None:
            return None
        return time.monotonic() - self._disconnected_since

    def session_transitions(self) -> List[dict]:
        """Bounded transition history, oldest first."""
        return list(self._transitions)


class Watcher:
    """Per-path watch handle: holds ``children`` and ``data`` listeners.

    Mirrors zkstream's watcher EventEmitter surface (``childrenChanged`` /
    ``dataChanged``) as used at reference ``lib/zk.js:215-219``.

    Storage is deliberately compact (one watcher per mirrored znode
    means a million of these at production zone scale): slots instead
    of a ``__dict__``, and each event's listeners held as None / the
    single callback / a tuple — the mirror registers exactly one per
    event, so the common case allocates no container at all.  The
    ``_listeners`` dict view is materialized on demand for
    introspection and tests.
    """

    __slots__ = ("path", "_children", "_data")

    def __init__(self, path: str) -> None:
        self.path = path
        self._children = None
        self._data = None

    @staticmethod
    def _add(slot, cb):
        if slot is None:
            return cb
        if type(slot) is tuple:
            return slot + (cb,)
        return (slot, cb)

    def on(self, event: str, cb: Callable) -> None:
        if event == "children":
            self._children = self._add(self._children, cb)
        elif event == "data":
            self._data = self._add(self._data, cb)
        else:
            raise KeyError(event)

    def bind_node(self, node) -> None:
        """Attach a mirror TreeNode as the listener for BOTH events.

        The node object itself is stored and its
        ``on_children_changed``/``on_data_changed`` handlers are
        resolved at emit time — one reference instead of two
        bound-method objects, which at one watcher per znode is tens of
        MB at production zone scale.  Subclasses that deliver initial
        state on listener attach must override this the same way they
        override ``on``."""
        self._children = self._add(self._children, node)
        self._data = self._add(self._data, node)

    def clear(self) -> None:
        """Remove all listeners (reference removeAllListeners,
        ``lib/zk.js:211-214``)."""
        self._children = None
        self._data = None

    @staticmethod
    def _resolve(entry, event: str) -> Callable:
        if callable(entry):
            return entry
        return (entry.on_children_changed if event == "children"
                else entry.on_data_changed)

    def emit(self, event: str, *args) -> None:
        slot = self._children if event == "children" else self._data
        if slot is None:
            return
        if type(slot) is tuple:
            for entry in slot:
                self._resolve(entry, event)(*args)
        else:
            self._resolve(slot, event)(*args)

    @property
    def _listeners(self) -> Dict[str, List[Callable]]:
        """Dict-of-lists view of the compact listener slots (kept for
        tests/introspection; mutations to the view are NOT applied)."""
        out = {}
        for event, slot in (("children", self._children),
                            ("data", self._data)):
            if slot is None:
                out[event] = []
            elif type(slot) is tuple:
                out[event] = [self._resolve(e, event) for e in slot]
            else:
                out[event] = [self._resolve(slot, event)]
        return out

    @property
    def has_listeners(self) -> bool:
        return self._children is not None or self._data is not None


class StoreClient:
    """Abstract coordination-store client (zkstream-equivalent surface)."""

    def on_session(self, cb: Callable[[], None]) -> None:
        """Register a callback fired on every session (re-)establishment."""
        raise NotImplementedError

    def watcher(self, path: str) -> Watcher:
        """Return the watch handle for *path* (created on first use).

        After the caller attaches listeners, the store must deliver the
        current state of the node (children + data) and keep delivering on
        changes, for as long as the session lasts.
        """
        raise NotImplementedError

    # -- mirror-node fast binding --
    #
    # The mirror registers EXACTLY one listener pair per znode — one
    # TreeNode.  The generic path (watcher object + listener slots) is
    # ~190 bytes per node, which at a million names is the difference
    # between a mirror that fits and one that doesn't.  Stores that can
    # route events straight to a bound node override these with a bare
    # domain->node dict: the fake store and the shard replica feed
    # route synchronously, and the real ZooKeeper client uses the index
    # both for dispatch and to batch its wire watches (one data watch
    # per znode, children watches only where children can exist —
    # zk_client module docstring).  The default declines and keeps the
    # historical per-path watcher semantics.

    def bind_source(self, nodes) -> bool:
        """Offer the mirror's domain->node index as a direct event
        routing table.  Stores that can route events by domain accept
        and return True — per-node binds then carry no per-node state
        at all.  The default declines; such stores keep per-path
        watcher objects."""
        return False

    def bind_node(self, path: str, node) -> None:
        """Bind *node* as the sole listener for *path*: clears any
        previous listeners, attaches the node for both events, and
        delivers current state (same contract as two ``on`` calls)."""
        w = self.watcher(path)
        w.clear()
        w.bind_node(node)

    def unbind_node(self, path: str, node) -> None:
        """Detach *node* from *path* (no-op if it is not bound)."""
        self.watcher(path).clear()

    def is_connected(self) -> bool:
        raise NotImplementedError

    def syncing(self) -> bool:
        """True while a fetch for a watched path is outstanding.  The
        default suits stores that deliver state synchronously."""
        return False

    def connecting(self) -> bool:
        """True while the first session is still being established: no
        session yet, and the first connection attempt has not ended.
        The default suits stores whose session starts synchronously."""
        return False

    def close(self) -> None:
        raise NotImplementedError
