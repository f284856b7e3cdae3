"""Tracing probes — the rebuild's answer to the reference's DTrace USDT
provider (``lib/server.js:24-29``: provider ``binder``, probes
``op-req-start`` / ``op-req-done`` fired per query with lazily-built
JSON arguments).

Linux has no USDT-from-script equivalent, so the provider here is a
pluggable fan-out with the same two properties the reference relies on:

- **zero cost when disabled** — ``fire()`` takes a *callable* producing
  the probe arguments, evaluated only if some backend is attached
  (dtrace's ``p1.fire(function () { return [query]; })`` semantics);
- **observable from outside the process** — the ``ftrace`` backend
  writes ``binder:<probe>: <json>`` markers to the kernel trace buffer
  (``/sys/kernel/tracing/trace_marker``), visible in ``trace-cmd`` /
  ``perfetto`` alongside scheduler events, which is how the dtrace
  one-liners in the reference's runbooks translate.

In-process consumers (tests, a future ``binder-dtrace`` analog) use
``subscribe``.  Backend selection: ``BINDER_PROBES=ftrace|log|off``
(default off).
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, Dict, List, Optional

log = logging.getLogger("binder.probes")


class Probe:
    __slots__ = ("name", "provider")

    def __init__(self, provider: "ProbeProvider", name: str) -> None:
        self.provider = provider
        self.name = name

    @property
    def enabled(self) -> bool:
        return bool(self.provider._sinks)

    def fire(self, argf: Callable[[], object]) -> None:
        """Evaluate ``argf`` and deliver only if somebody is listening."""
        # snapshot: _sinks is replaced wholesale (copy-on-write under the
        # provider lock), never mutated in place, so this local reference
        # is a stable list even while another thread (a test detaching
        # its sink mid-load, the ftrace close path) subscribes or
        # unsubscribes concurrently — no sink is skipped, nothing raises
        sinks = self.provider._sinks
        if not sinks:
            return
        try:
            args = argf()
        except Exception as e:  # noqa: BLE001 — probes must never take
            log.debug("probe %s argf failed: %s", self.name, e)  # down serving
            return
        for sink in sinks:
            try:
                sink(self.name, args)
            except Exception as e:  # noqa: BLE001
                log.debug("probe sink failed for %s: %s", self.name, e)


class ProbeProvider:
    """``provider.probe("op-req-start").fire(lambda: {...})``."""

    TRACE_MARKER_PATHS = (
        "/sys/kernel/tracing/trace_marker",
        "/sys/kernel/debug/tracing/trace_marker",
    )

    def __init__(self, name: str = "binder",
                 backend: Optional[str] = None) -> None:
        self.name = name
        self._probes: Dict[str, Probe] = {}
        # copy-on-write: mutated only by replacement under _sinks_lock;
        # Probe.fire() iterates a snapshot reference without the lock
        self._sinks: List[Callable[[str, object], None]] = []
        self._sinks_lock = threading.Lock()
        self._marker = None
        backend = (backend if backend is not None
                   else os.environ.get("BINDER_PROBES", "off")).lower()
        if backend == "ftrace":
            self._attach_ftrace()
        elif backend == "log":
            self.subscribe(self._log_sink)
        # anything else (off/unknown): no sinks, probes disabled

    def probe(self, probe_name: str) -> Probe:
        p = self._probes.get(probe_name)
        if p is None:
            p = self._probes[probe_name] = Probe(self, probe_name)
        return p

    def subscribe(self, fn: Callable[[str, object], None]) -> None:
        with self._sinks_lock:
            self._sinks = self._sinks + [fn]

    def unsubscribe(self, fn: Callable[[str, object], None]) -> None:
        with self._sinks_lock:
            sinks = list(self._sinks)
            try:
                sinks.remove(fn)
            except ValueError:
                return
            self._sinks = sinks

    # -- backends --

    def _attach_ftrace(self) -> None:
        for path in self.TRACE_MARKER_PATHS:
            try:
                self._marker = open(path, "w", buffering=1)
                self.subscribe(self._ftrace_sink)
                log.info("probes: ftrace markers to %s", path)
                return
            except OSError:
                continue
        log.warning("probes: BINDER_PROBES=ftrace but no writable "
                    "trace_marker; probes disabled")

    def _ftrace_sink(self, probe_name: str, args: object) -> None:
        try:
            self._marker.write(
                f"{self.name}:{probe_name}: "
                f"{json.dumps(args, default=str, separators=(',', ':'))}\n")
        except OSError:
            pass

    def _log_sink(self, probe_name: str, args: object) -> None:
        log.info("%s:%s: %s", self.name, probe_name,
                 json.dumps(args, default=str, separators=(",", ":")))

    def close(self) -> None:
        if self._marker is not None:
            # detach the sink too, or probes stay 'enabled' and fire
            # into the closed file on every query
            self.unsubscribe(self._ftrace_sink)
            try:
                self._marker.close()
            except OSError:
                pass
            self._marker = None
