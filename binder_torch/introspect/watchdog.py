"""Event-loop-lag watchdog.

The binder's whole serve path lives on one asyncio loop; anything that
blocks it (a synchronous log sink, a GC pause, a runaway zone refill)
stalls *every* query at once while no individual query looks wrong.
The watchdog samples a monotonic timer on the loop itself: it asks to
wake after ``interval`` seconds and measures how late the wakeup
actually ran.  That lateness IS the scheduling delay every other
callback experienced in the same window.

Samples land in the ``binder_loop_lag_seconds`` histogram; a sample
over ``stall_threshold`` also fires a ``loop-stall`` flight-recorder
event carrying the measured lag.
"""
from __future__ import annotations

import asyncio
import time
from typing import Optional

#: Lag grid: the loop's normal jitter is sub-millisecond; anything in
#: the right half of this grid is a serving-visible stall.
DEFAULT_LAG_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0)

METRIC_LOOP_LAG = "binder_loop_lag_seconds"

#: lag at which a sample is a stall (a ``loop-stall`` event); the loop
#: accountant's ``long-callback`` events use the same threshold
DEFAULT_STALL_THRESHOLD_S = 0.25


class LoopLagWatchdog:
    def __init__(self, collector=None, recorder=None,
                 interval: float = 0.1,
                 stall_threshold: float = DEFAULT_STALL_THRESHOLD_S) -> None:
        self.interval = interval
        self.stall_threshold = stall_threshold
        self.recorder = recorder
        self.samples = 0
        self.stalls = 0
        self.last_lag = 0.0
        self.max_lag = 0.0
        self.last_sample_mono: Optional[float] = None
        self._task: Optional[asyncio.Task] = None
        self._hist_child = None
        if collector is not None:
            self._hist_child = collector.histogram(
                METRIC_LOOP_LAG,
                "event-loop scheduling lag sampled by the watchdog "
                "(how late a timer callback ran)",
                buckets=DEFAULT_LAG_BUCKETS).labelled()
            collector.gauge(
                "binder_loop_lag_max_seconds",
                "largest event-loop lag observed since start"
            ).set_function(lambda: self.max_lag)

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.ensure_future(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while True:
            before = time.monotonic()
            await asyncio.sleep(self.interval)
            now = time.monotonic()
            self._observe(max(0.0, now - before - self.interval), now)

    def _observe(self, lag: float, now: float) -> None:
        """Record one lag sample (separated from the loop for tests)."""
        self.samples += 1
        self.last_lag = lag
        self.last_sample_mono = now
        if lag > self.max_lag:
            self.max_lag = lag
        if self._hist_child is not None:
            self._hist_child.observe(lag)
        if lag >= self.stall_threshold and self.recorder is not None:
            self.stalls += 1
            self.recorder.record("loop-stall", lag_s=round(lag, 6),
                                 threshold_s=self.stall_threshold)

    def snapshot(self) -> dict:
        return {
            "interval_seconds": self.interval,
            "stall_threshold_seconds": self.stall_threshold,
            "samples": self.samples,
            "stalls": self.stalls,
            "last_lag_seconds": self.last_lag,
            "max_lag_seconds": self.max_lag,
        }
