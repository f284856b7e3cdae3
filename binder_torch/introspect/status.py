"""Kang-style status snapshot: the binder's state, externally visible.

The reference ships kang endpoints because its dominant production
failure is *silent*: a binder serving an aging ZK mirror after session
loss, or an event-loop stall, with every individual query looking
fine.  The :class:`Introspector` assembles one consistent JSON snapshot
of the state side — store session state machine, mirror staleness,
answer-cache economics, the in-flight query table (the trace IDs
and phase stamps), recursion peers, loop-lag watchdog, and the flight
recorder — served over HTTP by the metrics server's ``/status`` route
and pretty-printed by ``bin/bstat``.

Consistency: the snapshot is built ON the event loop (via
``call_soon_threadsafe`` from scrape threads) whenever a loop handle is
known, so it can never observe the mirror mid-mutation; without a loop
(tests, tools) it is built inline against the synchronous fake store.
"""
from __future__ import annotations

import asyncio
import os
import threading
import time
from typing import Optional

from binder_torch.store.interface import SESSION_STATES

SNAPSHOT_VERSION = 1

#: events embedded in the snapshot (the dump file carries the full ring)
SNAPSHOT_EVENTS = 50


class Introspector:
    def __init__(self, *, server=None, zk_cache=None, store=None,
                 recursion=None, recorder=None, watchdog=None,
                 collector=None, name: str = "binder") -> None:
        self.server = server
        self.zk_cache = zk_cache if zk_cache is not None else (
            server.zk_cache if server is not None else None)
        self.store = store if store is not None else (
            getattr(self.zk_cache, "store", None))
        self.recursion = recursion if recursion is not None else (
            server.resolver.recursion if server is not None else None)
        self.recorder = recorder if recorder is not None else (
            getattr(server, "recorder", None))
        self.watchdog = watchdog
        self.name = name
        self.started_mono = time.monotonic()
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        if collector is not None:
            self._register_metrics(collector)

    def set_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        """Bind the event loop snapshots must be consistent with."""
        self.loop = loop

    def _register_metrics(self, collector) -> None:
        # one-hot state series: the PromQL-friendly encoding (alert on
        # binder_zk_session_state{state="degraded"} == 1)
        g = collector.gauge(
            "binder_zk_session_state",
            "coordination-store session state machine (1 on the "
            "current state's series, 0 elsewhere)")
        for state in SESSION_STATES:
            g.set_function(
                lambda s=state: 1.0 if self._store_state() == s else 0.0,
                {"state": state})
        collector.gauge(
            "binder_inflight_queries",
            "queries currently in flight past the synchronous serve "
            "path (recursion forwards, async handlers)"
        ).set_function(self._inflight_count)

    def _store_state(self) -> str:
        st = self.store
        if st is None:
            return "never-connected"
        getter = getattr(st, "session_state", None)
        if getter is not None:
            return getter()
        return "connected" if st.is_connected() else "never-connected"

    def _inflight_count(self) -> float:
        if self.server is None:
            return 0.0
        return float(len(self.server.engine.inflight))

    # -- snapshot assembly --

    def snapshot(self) -> dict:
        """One consistent snapshot.  From a foreign thread with a live
        loop bound, the build runs as a loop callback (the loop is the
        only mutator of the structures read); inline otherwise."""
        loop = self.loop
        if loop is not None and loop.is_running():
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is not loop:
                box: list = []
                done = threading.Event()

                def build() -> None:
                    try:
                        box.append(self._build())
                    except Exception as e:  # noqa: BLE001 — surface it
                        box.append(e)
                    finally:
                        done.set()

                loop.call_soon_threadsafe(build)
                if done.wait(timeout=2.0) and box:
                    if isinstance(box[0], Exception):
                        raise box[0]
                    return box[0]
                # loop wedged: an inline best-effort build is exactly
                # what an operator diagnosing the wedge needs
        return self._build()

    def _build(self) -> dict:
        return {
            "service": {
                "name": self.name,
                "pid": os.getpid(),
                "version": SNAPSHOT_VERSION,
                "uptime_seconds": time.monotonic() - self.started_mono,
                "generated_at": time.time(),
            },
            "store": self._store_section(),
            "mirror": self._mirror_section(),
            "answer_cache": self._cache_section(),
            "tcp": self._tcp_section(),
            "inflight": self._inflight_section(),
            "recursion": self._recursion_section(),
            "federation": self._federation_section(),
            "precompile": self._precompile_section(),
            "verify": self._verify_section(),
            "policy": self._policy_section(),
            "loop": (self.watchdog.snapshot()
                     if self.watchdog is not None else None),
            "flight_recorder": self._recorder_section(),
        }

    def _precompile_section(self) -> Optional[dict]:
        """Mutation-time precompiler state (null when the feature is
        off): queue depth vs its bound is the backlog signal the
        operations runbook keys on."""
        pc = getattr(self.server, "_precompiler", None) \
            if self.server is not None else None
        return None if pc is None else pc.introspect()

    def _verify_section(self) -> Optional[dict]:
        """Serving-plane verification state (null when the feature is
        off): per-invariant check/violation/skip counts, the recent
        violations table, audit progress, and the mutation-to-glass
        propagation stage latencies (docs/observability.md)."""
        vf = getattr(self.server, "_verify", None) \
            if self.server is not None else None
        return None if vf is None else vf.introspect()

    def _store_section(self) -> dict:
        st = self.store
        now = time.monotonic()
        out = {
            "backend": type(st).__name__ if st is not None else None,
            "state": self._store_state(),
            "connected": bool(st.is_connected()) if st is not None
            else False,
            "disconnected_seconds": None,
            "session_establishments": getattr(
                st, "session_establishments", 0),
            "transitions": [],
        }
        getter = getattr(st, "disconnected_seconds", None)
        if getter is not None:
            out["disconnected_seconds"] = getter()
        for tr in getattr(st, "session_transitions", lambda: [])():
            out["transitions"].append({
                "t_wall": tr["t_wall"],
                "age_seconds": now - tr["t_mono"],
                "from": tr["from"], "to": tr["to"],
                "reason": tr["reason"],
            })
        return out

    def _mirror_section(self) -> dict:
        zc = self.zk_cache
        if zc is None:
            return {"ready": False, "domain": None, "generation": 0,
                    "epoch": 0, "nodes": 0, "names": 0,
                    "reverse_entries": 0, "interned_names": 0,
                    "staleness_seconds": None,
                    "last_rebuild_age_seconds": None,
                    "rebuild": {"pending": 0, "chunks": 0,
                                "last_duration_seconds": None}}
        now = time.monotonic()
        rebuild = getattr(zc, "last_rebuild_mono", None)
        staleness = getattr(zc, "staleness_seconds", lambda: None)()
        pool = getattr(zc, "pool", None)
        return {
            "ready": zc.is_ready(),
            "domain": zc.domain,
            "generation": zc.gen,
            "epoch": zc.epoch,
            # zone scale: every bench/status reading carries
            # the size it was measured at ("nodes" kept as the
            # historical alias of the name count)
            "nodes": len(zc.nodes),
            "names": len(zc.nodes),
            "reverse_entries": len(zc.rev_lookup),
            "interned_names": len(pool) if pool is not None else 0,
            "staleness_seconds": staleness,
            "last_rebuild_age_seconds": (
                None if rebuild is None else now - rebuild),
            # chunked session-rebuild state (pending>0 == a re-mirror
            # is streaming underneath live serving right now)
            "rebuild": getattr(zc, "rebuild_info", lambda: {
                "pending": 0, "chunks": 0,
                "last_duration_seconds": None})(),
        }

    def _cache_section(self) -> dict:
        if self.server is None:
            return {"size": 0, "entries": 0, "hits": 0, "misses": 0,
                    "hit_ratio": 0.0, "invalidations": 0,
                    "expiry_ms": 0.0, "neg_hits": 0,
                    "compiled_entries": 0, "compiled_serves": 0,
                    "compiled_installs": 0}
        return self.server.answer_cache.stats()

    def _tcp_section(self) -> dict:
        """Stream-lane state (dns/stream.py): live connection table
        plus accept/promotion/coalesce/drop counters — the "why is TCP
        slow / shedding" section the runbook keys on
        (docs/operations.md)."""
        if self.server is not None:
            return self.server.engine.tcp_introspect()
        return {"open_conns": 0, "max_conns": 0,
                "idle_timeout_seconds": 0.0, "max_write_buffer": 0,
                "cap_refusals": 0, "accepts": 0, "fast_serves": 0,
                "promotions": 0, "oneshot_closes": 0,
                "idle_timeouts": 0, "slow_reader_drops": 0,
                "coalesced_writes": 0, "coalesced_frames": 0,
                "half_closes": 0, "rst_drops": 0}

    def _inflight_section(self) -> dict:
        queries = []
        if self.server is not None:
            for q in list(self.server.engine.inflight.values()):
                queries.append({
                    "trace": q.trace_id,
                    "name": q.name(),
                    "type": q.qtype_name(),
                    "client": q.src[0],
                    "protocol": q.protocol,
                    "age_ms": q.latency_ms(),
                    "phase": q.last_phase(),
                    "phases": dict(q.times),
                })
        return {"count": len(queries), "queries": queries}

    def _recursion_section(self) -> Optional[dict]:
        rec = self.recursion
        return None if rec is None else rec.introspect()

    def _federation_section(self) -> Optional[dict]:
        """Multi-DC federation state (null when this binder is not
        federated): DC registry membership, per-peer health, the
        foreign-answer cache, and failover convergence — the "which
        datacenter owns this name and is it alive" summary the
        operations runbook keys on (docs/federation.md)."""
        fed = getattr(self.server, "federation", None) \
            if self.server is not None else None
        return None if fed is None else fed.introspect()

    def _policy_section(self) -> Optional[dict]:
        """Degradation policy engine state (null when the whole layer
        is off): the stale-serve state machine, overload admission
        counters, and the recursion breakers' worst state — the
        "is binder degraded, and what is it doing about it" summary
        the runbook keys on (docs/degradation.md)."""
        srv = self.server
        pol = getattr(srv, "_policy", None) if srv is not None else None
        adm = getattr(srv, "_admission", None) if srv is not None else None
        rrl = getattr(srv, "_rrl", None) if srv is not None else None
        brk = (getattr(self.recursion, "breakers", None)
               if self.recursion is not None else None)
        if pol is None and adm is None and rrl is None and brk is None:
            return None
        return {
            "degradation": None if pol is None else pol.introspect(),
            "admission": None if adm is None else adm.introspect(
                srv.engine if srv is not None else None),
            "rrl": None if rrl is None else rrl.introspect(),
            "breakers_open": 0 if brk is None else brk.open_count(),
        }

    def _recorder_section(self) -> Optional[dict]:
        if self.recorder is None:
            return None
        out = self.recorder.stats()
        out["events"] = self.recorder.events(last=SNAPSHOT_EVENTS)
        return out
