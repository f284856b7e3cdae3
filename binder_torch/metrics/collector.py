"""Prometheus-style metric collectors + text exposition.

Artedi/triton-metrics equivalent (reference ``lib/server.js:31-34,456-469``
and ``main.js:134-152``), built on the stdlib only.  Provides the same
three binder metrics with the same names:

- ``binder_requests_completed``        counter,   labeled by qtype
- ``binder_request_latency_seconds``   histogram, labeled by qtype
- ``binder_response_size_bytes``       histogram, labeled by qtype

plus a ``/metrics`` scrape endpoint served on service-port+1000 (the Triton
convention, reference ``main.js:144-151``).
"""
from __future__ import annotations

import logging
import threading
from bisect import bisect_left
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

# artedi's default buckets are log-linear; these are the standard prometheus
# client defaults, which cover the same DNS-latency range.
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
DEFAULT_SIZE_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
# Per-stage attribution histograms (binder_query_stage_seconds): single
# phases run from a few µs (mirror probe, splice) up to cross-DC RTTs in
# ms, so the grid extends two decades below the request-latency buckets.
DEFAULT_STAGE_BUCKETS = (
    0.000005, 0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)


def _fmt_value(v: float) -> str:
    """A sample's value: the short ``%g`` form where it is exact, else
    every digit (a CLOCK_MONOTONIC timestamp or a running CPU total
    would lose its fraction to six significant digits)."""
    short = f"{v:g}"
    return short if float(short) == v else repr(float(v))


def _labels_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class CounterChild:
    """Pre-resolved label handle — the per-query fast path skips the
    label-dict sort entirely (prometheus-client 'child' pattern)."""

    __slots__ = ("_counter", "_key")

    def __init__(self, counter: "Counter", key: Tuple) -> None:
        self._counter = counter
        self._key = key

    def inc(self, by: float = 1.0) -> None:
        c = self._counter
        with c._lock:
            c._values[self._key] = c._values.get(self._key, 0.0) + by


class Counter:
    def __init__(self, name: str, help: str) -> None:
        self.name = name
        self.help = help
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def labelled(self, labels: Optional[Dict[str, str]] = None) \
            -> CounterChild:
        return CounterChild(self, _labels_key(labels))

    def increment(self, labels: Optional[Dict[str, str]] = None,
                  by: float = 1.0) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self._values.get(_labels_key(labels), 0.0)

    def total(self) -> float:
        """Sum over every label set — the per-shard stats reports use
        this for requests-completed without building an exposition."""
        with self._lock:
            return sum(self._values.values())

    def expose(self, static: Tuple[Tuple[str, str], ...] = ()) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        for key, v in sorted(self._values.items()):
            lines.append(f"{self.name}{_fmt_labels(static + key)} "
                         f"{_fmt_value(v)}")
        return "\n".join(lines)


class Gauge:
    """Point-in-time value collector.  Besides ``set()``, a label set can
    be bound to a callable sampled at scrape time (``set_function``) —
    how structural values like mirrored-node counts are exported without
    bookkeeping on the mutation paths (the reference gets the analogous
    zkstream client gauges for free by passing its artedi collector in,
    ``lib/zk.js:26-38``)."""

    def __init__(self, name: str, help: str) -> None:
        self.name = name
        self.help = help
        self._values: Dict[Tuple, float] = {}
        self._functions: Dict[Tuple, object] = {}
        self._lock = threading.Lock()

    def set(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_labels_key(labels)] = value

    def set_function(self, fn, labels: Optional[Dict[str, str]] = None) \
            -> None:
        with self._lock:
            self._functions[_labels_key(labels)] = fn

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        key = _labels_key(labels)
        fn = self._functions.get(key)
        if fn is not None:
            return float(fn())
        return self._values.get(key, 0.0)

    def expose(self, static: Tuple[Tuple[str, str], ...] = ()) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        with self._lock:
            merged = dict(self._values)
            for key, fn in self._functions.items():
                try:
                    merged[key] = float(fn())
                except Exception:  # noqa: BLE001 — one bad sampler must
                    continue       # not take down the whole scrape
        for key, v in sorted(merged.items()):
            lines.append(f"{self.name}{_fmt_labels(static + key)} "
                         f"{_fmt_value(v)}")
        return "\n".join(lines)


class HistogramChild:
    """Pre-resolved label handle.  ``observe`` touches exactly one
    (non-cumulative) bucket cell via bisect instead of incrementing every
    bucket ≥ value; exposition re-accumulates to the cumulative
    prometheus form."""

    __slots__ = ("_hist", "_key", "_cells")

    def __init__(self, hist: "Histogram", key: Tuple) -> None:
        self._hist = hist
        self._key = key
        with hist._lock:
            self._cells = hist._counts.setdefault(
                key, [0] * (len(hist.buckets) + 1))

    def observe(self, value: float) -> None:
        h = self._hist
        with h._lock:
            self._cells[bisect_left(h.buckets, value)] += 1
            h._sums[self._key] = h._sums.get(self._key, 0.0) + value

    def merge(self, cells: Sequence[int], sum_delta: float) -> None:
        """Bulk-add externally accumulated (non-cumulative) bucket cells —
        how natively counted observations (the fast-path drain) fold in at
        scrape time.  ``cells`` must match this histogram's layout:
        len(buckets)+1 with the +Inf cell last."""
        h = self._hist
        with h._lock:
            for i, delta in enumerate(cells):
                if delta:
                    self._cells[i] += delta
            h._sums[self._key] = h._sums.get(self._key, 0.0) + sum_delta


class Histogram:
    # _counts stores per-bucket (NON-cumulative) cells, one extra slot
    # for +Inf; cumulative conversion happens at scrape time
    def __init__(self, name: str, help: str,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> None:
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def labelled(self, labels: Optional[Dict[str, str]] = None) \
            -> HistogramChild:
        return HistogramChild(self, _labels_key(labels))

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        key = _labels_key(labels)
        with self._lock:
            cells = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            cells[bisect_left(self.buckets, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value

    def count(self, labels: Optional[Dict[str, str]] = None) -> int:
        return sum(self._counts.get(_labels_key(labels), ()))

    def expose(self, static: Tuple[Tuple[str, str], ...] = ()) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        for key in sorted(self._counts):
            cells = self._counts[key]
            full = static + key
            running = 0
            for i, b in enumerate(self.buckets):
                running += cells[i]
                # no escapes inside f-string expressions (a backslash
                # there is a SyntaxError before Python 3.12)
                le = 'le="%g"' % b
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(full, le)} "
                    f"{running}")
            total = running + cells[len(self.buckets)]
            inf = 'le="+Inf"'
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels(full, inf)} {total}")
            lines.append(f"{self.name}_sum{_fmt_labels(full)} "
                         f"{_fmt_value(self._sums.get(key, 0.0))}")
            lines.append(f"{self.name}_count{_fmt_labels(full)} {total}")
        return "\n".join(lines)


class MetricsCollector:
    """Registry of named collectors (artedi createCollector analog)."""

    def __init__(self,
                 static_labels: Optional[Dict[str, str]] = None) -> None:
        self._collectors: Dict[str, object] = {}
        self.static_labels = static_labels or {}
        self._expose_hooks: List = []

    def on_expose(self, fn) -> None:
        """Register a pre-scrape hook (e.g. folding natively accumulated
        fast-path counts into the collectors)."""
        self._expose_hooks.append(fn)

    def counter(self, name: str, help: str = "") -> Counter:
        c = self._collectors.get(name)
        if c is None:
            c = Counter(name, help)
            self._collectors[name] = c
        return c  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        h = self._collectors.get(name)
        if h is None:
            h = Histogram(name, help, buckets)
            self._collectors[name] = h
        return h  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self._collectors.get(name)
        if g is None:
            g = Gauge(name, help)
            self._collectors[name] = g
        return g  # type: ignore[return-value]

    def get(self, name: str):
        return self._collectors.get(name)

    def fold(self) -> None:
        """Run the pre-scrape fold hooks WITHOUT building exposition
        text — how a shard worker keeps its natively counted serves
        current in the 1 Hz stats frames it sends the supervisor."""
        for fn in self._expose_hooks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — a fold bug must not
                logging.getLogger("binder.metrics").exception(
                    "fold hook %r failed", fn)   # stop the stats loop

    def expose(self) -> str:
        for fn in self._expose_hooks:
            try:
                fn()
            except Exception:  # noqa: BLE001 — scrape must not 500 on a
                # fold-in bug, but a silently-failing hook means natively
                # counted queries vanish from dashboards: log it
                logging.getLogger("binder.metrics").exception(
                    "pre-scrape hook %r failed", fn)
        static = _labels_key({k: str(v) for k, v in
                              self.static_labels.items() if v is not None})
        return "\n".join(c.expose(static)
                         for c in self._collectors.values()) + "\n"


class MetricsServer:
    """Threaded HTTP scrape server on service-port+1000
    (triton-metrics analog).  Besides ``/metrics``, serves the
    kang-style introspection snapshot on ``/status`` (and the kang
    alias ``/kang/snapshot``) when ``status_source`` is set to a
    callable returning a JSON-serializable object — one port covers
    both the time-series and the state views."""

    def __init__(self, collector: MetricsCollector, address: str = "0.0.0.0",
                 port: int = 0) -> None:
        self.collector = collector
        # set post-construction (the Introspector needs the running
        # server wired first); consulted per request
        self.status_source = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, body: bytes, ctype: str,
                       code: int = 200) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                import json as _json
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._reply(outer.collector.expose().encode(),
                                "text/plain; version=0.0.4")
                    return
                if (path in ("/status", "/kang/snapshot")
                        and outer.status_source is not None):
                    try:
                        snap = outer.status_source()
                        body = _json.dumps(snap, default=str,
                                           indent=1).encode()
                    except Exception as e:  # noqa: BLE001 — a snapshot
                        # bug must answer 500, not hang the scraper
                        body = _json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}).encode()
                        self._reply(body, "application/json", 500)
                        return
                    self._reply(body, "application/json")
                    return
                self.send_response(404)
                self.end_headers()

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer((address, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
