"""Fold the balancer's stats-socket counters into the Prometheus scrape.

The balancer puts per-stage cycle attribution (frame-parse / cache-probe /
backend-write / reply-relay) on the balancer's stats socket, readable
by ``bin/balstat`` — but dashboards scrape the *backend's* ``/metrics``
endpoint.  This pre-expose hook reads the stats socket at scrape time
and re-exports the stage counters, so ONE scrape covers the C and
Python layers of the deployment unit.

Counter semantics: the balancer reports absolute totals since its own
start.  The fold takes deltas against the last-seen totals (baseline
reset when totals regress, i.e. the balancer restarted), so the
Prometheus series stays monotonic across balancer restarts — the same
discipline as BinderServer's fast-path fold.
"""
from __future__ import annotations

import json
import logging
import socket
import threading
from typing import Optional


class BalancerStatsFold:
    def __init__(self, collector, stats_path: str,
                 timeout: float = 0.5,
                 log: Optional[logging.Logger] = None) -> None:
        self.stats_path = stats_path
        self.timeout = timeout
        self.log = log or logging.getLogger("binder.metrics")
        self._lock = threading.Lock()
        self._last: dict = {}            # stage -> {"cycles", "ops"}
        self._cycles = collector.counter(
            "binder_balancer_stage_cycles",
            "balancer per-stage exclusive TSC cycles (folded from the "
            "stats socket; divide by binder_balancer_cycles_per_us)")
        self._ops = collector.counter(
            "binder_balancer_stage_ops",
            "balancer per-stage timed-region count")
        self._cycles_per_us = collector.gauge(
            "binder_balancer_cycles_per_us",
            "balancer lifetime-calibrated TSC rate")
        self._up = collector.gauge(
            "binder_balancer_up",
            "1 when the balancer stats socket answered the last scrape")
        self._children: dict = {}        # stage -> (cycles, ops) handles
        collector.on_expose(self.fold)

    def read_stats(self) -> dict:
        """One stats-socket round trip (the balancer writes the whole
        JSON document and closes)."""
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.settimeout(self.timeout)
        try:
            c.connect(self.stats_path)
            buf = b""
            while True:
                chunk = c.recv(65536)
                if not chunk:
                    break
                buf += chunk
        finally:
            c.close()
        return json.loads(buf)

    def _handles(self, stage: str):
        h = self._children.get(stage)
        if h is None:
            labels = {"stage": stage}
            h = (self._cycles.labelled(labels), self._ops.labelled(labels))
            self._children[stage] = h
        return h

    def fold(self) -> None:
        # scrapes run on ThreadingHTTPServer threads: serialize, or two
        # concurrent scrapes double-count the delta
        with self._lock:
            try:
                stats = self.read_stats()
            except (OSError, ValueError):
                # no balancer (not running / not configured on this
                # box) is a normal state, not a scrape error
                self._up.set(0.0)
                return
            self._up.set(1.0)
            self._cycles_per_us.set(float(stats.get("cycles_per_us", 0.0)))
            for stage, cell in (stats.get("stage_cycles") or {}).items():
                if not isinstance(cell, dict):
                    continue
                cyc = int(cell.get("cycles", 0))
                ops = int(cell.get("ops", 0))
                last = self._last.get(stage, {"cycles": 0, "ops": 0})
                if cyc < last["cycles"] or ops < last["ops"]:
                    last = {"cycles": 0, "ops": 0}   # balancer restarted
                ch_cyc, ch_ops = self._handles(stage)
                if cyc > last["cycles"]:
                    ch_cyc.inc(cyc - last["cycles"])
                if ops > last["ops"]:
                    ch_ops.inc(ops - last["ops"])
                self._last[stage] = {"cycles": cyc, "ops": ops}
