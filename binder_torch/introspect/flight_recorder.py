"""Bounded in-memory flight recorder for notable runtime events.

The reference binder's postmortem story is mdb against a core file;
this is the living-process equivalent: a fixed-capacity ring of
structured events (session transitions, watch storms, slow queries,
resolver errors, loop stalls, mirror rebuilds) that costs one deque
append per event, is embedded in the introspection snapshot, and is
dumped to disk on SIGUSR2 — so the minutes *leading up to* an incident
survive the incident.

Thread-safe: events are recorded from the event loop, scrape threads
read snapshots, and the SIGUSR2 dump may run from either.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from collections import deque
from typing import Dict, List, Optional

#: Event-type catalog (see docs/observability.md).  record() accepts
#: any string — these are the types the stock wiring emits.
EVENT_TYPES = (
    "session-transition",   # store session state machine edge
    "mirror-rebuild",       # full mirror re-sync (session event)
    "watch-storm",          # mutation rate over MirrorCache.STORM_THRESHOLD
    "slow-query",           # query latency over SLOW_QUERY_MS
    "resolver-error",       # query handler raised (engine error path)
    "loop-stall",           # event-loop lag over the watchdog threshold
    "verify-violation",     # serving-plane invariant check failed
    "dump",                 # a SIGUSR2/explicit dump was taken
)

DEFAULT_CAPACITY = 512


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 log: Optional[logging.Logger] = None) -> None:
        self.capacity = capacity
        self.log = log or logging.getLogger("binder.flight")
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.recorded = 0                   # total ever recorded
        self.by_type: Dict[str, int] = {}
        self._dump_path: Optional[str] = None

    def record(self, etype: str, **data) -> None:
        """Append one event.  ``data`` values must be JSON-serializable
        (enforced at dump time with ``default=str``, so a bad value can
        degrade one field, never the recorder)."""
        now = time.monotonic()
        with self._lock:
            self._seq += 1
            self.recorded += 1
            self.by_type[etype] = self.by_type.get(etype, 0) + 1
            self._events.append({
                "seq": self._seq, "type": etype,
                "t_mono": now, "t_wall": time.time(), **data,
            })

    @property
    def dropped(self) -> int:
        """Events pushed out of the ring by newer ones."""
        with self._lock:
            return self.recorded - len(self._events)

    def events(self, last: Optional[int] = None) -> List[dict]:
        """Snapshot of the ring, oldest first (seq strictly ascending);
        ``last`` limits to the most recent N."""
        with self._lock:
            evs = list(self._events)
        if last is not None and last < len(evs):
            evs = evs[len(evs) - last:]
        return evs

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "recorded": self.recorded,
                "dropped": self.recorded - len(self._events),
                "by_type": dict(self.by_type),
            }

    # -- dumping --

    def default_dump_path(self) -> str:
        return self._dump_path or f"/tmp/binder-flight-{os.getpid()}.json"

    def dump(self, path: Optional[str] = None) -> str:
        """Write the whole ring (plus counters) to ``path`` as JSON and
        record a ``dump`` event; returns the path written."""
        path = path or self.default_dump_path()
        payload = {
            "dumped_at": time.time(),
            "pid": os.getpid(),
            **self.stats(),
            "events": self.events(),
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, default=str, indent=1)
            f.write("\n")
        os.replace(tmp, path)       # readers never see a partial dump
        self.record("dump", path=path, events=len(payload["events"]))
        self.log.info("flight recorder dumped %d event(s) to %s",
                      len(payload["events"]), path)
        return path

    def install_sigusr2(self, loop=None,
                        path: Optional[str] = None) -> None:
        """Arm SIGUSR2 → dump().  With an asyncio loop the handler runs
        as a loop callback (safe with the running server); without one,
        a plain signal handler (the dump only touches the lock and a
        file, both safe outside the loop)."""
        if path:
            self._dump_path = path

        def on_sigusr2(*_args) -> None:
            try:
                self.dump()
            except OSError as e:
                self.log.error("flight recorder dump failed: %s", e)

        if loop is not None:
            loop.add_signal_handler(signal.SIGUSR2, on_sigusr2)
        else:
            signal.signal(signal.SIGUSR2, on_sigusr2)
