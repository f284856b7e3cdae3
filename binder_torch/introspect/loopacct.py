"""Event-loop CPU accounting by activity, and the boot's phases.

A shard worker's one event-loop core goes to several things at once:
the UDP drain (the C lane, the Python lane, ``sendmmsg``, the query-log
ring), the mutation feed from the supervisor and the refill work it
schedules (precompile, zone refresh, verification), and the 1 Hz stats
frame.  The supervisor's goes to its ZooKeeper read loop, the owner
mirror, and the per-link fan-out.  A server behind ``mbalancer`` splits
its core between its balancer links (the same lanes) and its own
session's reads and mirror.  The loop-lag watchdog says WHEN the
loop was late; this says WHAT held it.

Each instrumented loop entry point brackets its synchronous work with
``ACCOUNT.begin(activity)`` / ``ACCOUNT.end()``; a span never straddles
an ``await``.  A span reads the monotonic clock alone and is credited
with its self wall time (its wall less its children's).  The thread's
CPU clock is a system call under gVisor (2.4 us idle on the H100 host
and far more under load: reading it at every loop callback cost a
worker 7-9% of its CPU a query), so it is read once an interval: the
loop made by :meth:`LoopAccountant.loop` closes its interval as it
enters its selector, once :data:`INTERVAL_S` has passed, and
:meth:`LoopAccountant.settle` closes one outside a span.  The
interval's CPU is shared among the spans that ran in it by self wall
time: an activity gets the interval's CPU in proportion to its spans'
wall over the thread's busy wall (the interval less the loop's wait in
its selector, the activity ``select``, which is counted by wall and by
call).  In the accounted loop the busy wall no span covers is the
activity ``dispatch``: asyncio's own work between callbacks (its ready
queue, timers and selector events) and the loop callbacks no span
names (a transport's reads).  So every activity of one interval runs at the
interval's one CPU-to-wall ratio; a single callback's own CPU is
measured only for a ``long-callback``.  Once bound, the accountant
names the cyclic garbage collector's older collections ``gc`` (a young
one stays with the code that allocated).  The totals fold into the
process's collector at scrape time, labelled by ``activity``:

- ``binder_loop_cpu_seconds_total``: the activity's CPU seconds;
  ``activity="other"`` is the process's CPU (``time.process_time``)
  less every named activity, so the family sums to what ``/proc``
  reads for the process: the threads beside the loop's (the scrape
  threads), and the loop's own dispatch where it is not the accounted
  loop;
- ``binder_loop_wall_seconds_total``: the activity's wall seconds
  (``select``'s is the loop's wait; its CPU is what the interval spent
  beyond its busy wall, the selector's system calls, and so reads low
  where the interval's CPU falls short of its busy wall);
- ``binder_loop_callbacks_total``: the spans it ran.

A top-level span whose wall time reaches the watchdog's stall
threshold records a ``long-callback`` flight-recorder event: the
activity, its start on ``time.monotonic``, its wall, its CPU (read at
its end: the thread's CPU since its interval opened, at most its wall,
so a bound from above that tells a callback that burned its wall from
one that was blocked or descheduled), and its cause as the call site
gives it (the propagation trace id in flight, or the datagrams
drained).  Every ``loop-stall`` then has the callback that held the
loop beside it.

Boot phases: each process records the phases of its start-up it ran
(start and end on ``time.monotonic``, which is CLOCK_MONOTONIC and so
one axis across the processes of a host, plus the CPU they took) as
the gauges ``binder_boot_phase_seconds``, ``binder_boot_phase_end_
seconds`` and ``binder_boot_phase_cpu_seconds`` and one ``boot-phase``
flight event each.

One accountant per process (:data:`ACCOUNT`), as there is one CPU
clock per process to divide: every instrumented module imports it;
``main.py`` binds it to the process's collector and flight recorder in
every server process.  Unbound (the modules used as a library, as
tests do), a span is one attribute test and reads no clock, and
nothing is counted or exported; boot phases are kept and exported once
bound.
Spans are kept per thread; the activities' totals are written by the
loop thread alone (the collector is watched on the thread that bound
the accountant) and read by the scrape threads.
"""
from __future__ import annotations

import asyncio
import collections.abc
import functools
import gc
import selectors
import threading
import time
from typing import Dict, Optional, Tuple

from binder_torch.introspect.watchdog import DEFAULT_STALL_THRESHOLD_S

METRIC_CPU = "binder_loop_cpu_seconds_total"
METRIC_WALL = "binder_loop_wall_seconds_total"
METRIC_CALLBACKS = "binder_loop_callbacks_total"
METRIC_PHASE = "binder_boot_phase_seconds"
METRIC_PHASE_END = "binder_boot_phase_end_seconds"
METRIC_PHASE_CPU = "binder_boot_phase_cpu_seconds"

#: the CPU no named activity took
OTHER = "other"
#: the loop's wait in its selector
SELECT = "select"
#: the cyclic garbage collector's generation 1 and 2 collections
GC = "gc"
#: the accounted loop's own work between the callbacks it runs
DISPATCH = "dispatch"

#: how often the loop thread's CPU clock is read, and its CPU shared out
INTERVAL_S = 0.1

_cpu_ns = time.thread_time_ns
_wall_ns = time.monotonic_ns


class Activity:
    """One activity's running totals (nanoseconds, self time), and
    its wall in the thread interval still open."""

    __slots__ = ("name", "cpu_ns", "wall_ns", "calls", "pending_wall")

    def __init__(self, name: str) -> None:
        self.name = name
        self.cpu_ns = 0
        self.wall_ns = 0
        self.calls = 0
        self.pending_wall = 0


class _Thread:
    """A thread's spans, and the interval it has open: its start (CPU
    and wall), the activities that ran in it, and the loop's idle wait
    in it."""

    __slots__ = ("stack", "cpu0", "wall0", "ran", "select_wall", "ratio")

    def __init__(self) -> None:
        self.stack: list = []
        self.cpu0 = _cpu_ns()
        self.wall0 = _wall_ns()
        self.ran: set = set()
        self.select_wall = 0
        # the last interval's CPU over its busy wall: what a span's
        # CPU is taken to be before its interval closes
        self.ratio = 1.0


class LoopAccountant:
    def __init__(self,
                 stall_threshold: float = DEFAULT_STALL_THRESHOLD_S) -> None:
        self._acts: Dict[str, Activity] = {}
        self._tls = threading.local()
        # every thread's state by thread id, for the scrape thread's
        # view of the intervals still open
        self._threads: Dict[int, _Thread] = {}
        self.threshold_ns = int(stall_threshold * 1e9)
        self.interval_ns = int(INTERVAL_S * 1e9)
        self.recorder = None
        self._collector = None
        # per-activity figures already folded into the counters
        self._folded: Dict[str, Tuple[int, int, int]] = {}
        self._other_folded = 0
        self._children: Dict[str, tuple] = {}
        self._phases: Dict[tuple, tuple] = {}
        self._gc = self.activity(GC)
        self._gc_thread: Optional[int] = None
        self._select = self.activity(SELECT)
        self._dispatch = self.activity(DISPATCH)
        # concurrent scrapes fold one at a time
        self._fold_lock = threading.Lock()

    def activity(self, name: str) -> Activity:
        """The handle a call site passes to :meth:`begin` (resolve it
        once, not per call)."""
        act = self._acts.get(name)
        if act is None:
            act = self._acts[name] = Activity(name)
        return act

    def _thread(self) -> _Thread:
        try:
            return self._tls.state
        except AttributeError:
            st = self._tls.state = _Thread()
            self._threads[threading.get_ident()] = st
            return st

    # -- spans --

    def begin(self, act: Activity) -> None:
        if self._collector is None:
            return
        try:
            stack = self._tls.state.stack
        except AttributeError:
            stack = self._thread().stack
        # [activity, start wall, children's wall]
        stack.append([act, _wall_ns(), 0])

    def end(self, cause=None) -> int:
        """Close the innermost span; returns a top-level span's CPU
        estimate (its wall at the last interval's ratio), a nested
        one's 0, and 0 unbound.  ``cause`` (a value, or a callable
        evaluated only then) goes into the ``long-callback`` event of a
        top-level span over the stall threshold."""
        if self._collector is None:
            return 0
        w1 = _wall_ns()
        try:
            st = self._tls.state
            act, w0, child_wall = st.stack.pop()
        except (AttributeError, IndexError):
            return 0
        dw = w1 - w0
        own_wall = dw - child_wall
        act.wall_ns += own_wall
        act.calls += 1
        act.pending_wall += own_wall
        st.ran.add(act)
        stack = st.stack
        if stack:
            stack[-1][2] += dw
            return 0
        if dw >= self.threshold_ns and self.recorder is not None:
            # rare: the thread's CPU since its interval opened, capped
            # at the span's wall, bounds the span's own from above
            self._long_callback(act, w0, dw,
                                min(dw, _cpu_ns() - st.cpu0), cause)
        return int(dw * st.ratio)

    def settle(self) -> None:
        """Close the calling thread's interval now, sharing its CPU out
        (outside every span: the accounted loop does it at its
        selector; a loop without one, and tests, here)."""
        st = self._thread()
        if not st.stack:
            self._settle(st, _wall_ns())

    def _settle(self, st: _Thread, now: int, loop: bool = False) -> None:
        cpu = _cpu_ns()
        spent = cpu - st.cpu0
        busy = now - st.wall0 - st.select_wall
        ratio = spent / busy if busy > 0 else 0.0
        ratio = min(1.0, max(0.0, ratio))
        covered = 0
        for act in st.ran:
            covered += act.pending_wall
            act.cpu_ns += int(act.pending_wall * ratio)
            act.pending_wall = 0
        if loop and busy > covered:
            # the accounted loop's busy wall no span covers: its own
            # dispatch (ready queue, timers, transports' I/O callbacks)
            act = self._dispatch
            act.wall_ns += busy - covered
            act.cpu_ns += int((busy - covered) * ratio)
            act.calls += 1
        if loop and spent > busy:
            # CPU beyond the busy wall was spent in the selector's wait:
            # its system calls (an epoll_wait is CPU under gVisor)
            self._select.cpu_ns += spent - max(busy, 0)
        st.ran = set()
        st.ratio = ratio
        st.cpu0 = cpu
        st.wall0 = now
        st.select_wall = 0

    def wrap(self, name: str, fn, cause=None):
        """``fn`` as one span of activity ``name`` per call (a loop
        callback, a reader, a method: :meth:`spans`); unbound, a plain
        call."""
        act = self.activity(name)
        acct, begin, end = self, self.begin, self.end

        @functools.wraps(fn)
        def accounted(*args, **kwargs):
            if acct._collector is None:
                return fn(*args, **kwargs)
            begin(act)
            try:
                return fn(*args, **kwargs)
            finally:
                end(cause)
        return accounted

    def spans(self, name: str):
        """Decorator: each call of the function is one span of
        activity ``name``."""
        return lambda fn: self.wrap(name, fn)

    def steps(self, name: str, coro) -> "Steps":
        """``coro`` for a task, each of its steps (a run from one await
        to the next) one span of activity ``name``: the coroutine
        machinery of a task that no callback span covers."""
        return Steps(self, self.activity(name), coro)

    def _on_gc(self, phase: str, info: dict) -> None:
        if (info["generation"] == 0
                or threading.get_ident() != self._gc_thread):
            return
        if phase == "start":
            self.begin(self._gc)
        else:
            self.end()

    def loop(self) -> asyncio.AbstractEventLoop:
        """A selector event loop that closes its thread's interval as
        it enters its selector, and whose selector's ``select`` is the
        activity ``select``: the loop's wait between callbacks, by wall
        and by call."""
        accountant, act = self, self._select

        class AccountedSelector(selectors.DefaultSelector):
            def select(self, timeout=None):
                if accountant._collector is None:
                    return super().select(timeout)
                st = accountant._thread()
                w0 = _wall_ns()
                if w0 - st.wall0 >= accountant.interval_ns:
                    accountant._settle(st, w0, loop=True)
                try:
                    return super().select(timeout)
                finally:
                    dw = _wall_ns() - w0
                    act.wall_ns += dw
                    act.calls += 1
                    st.select_wall += dw

        return asyncio.SelectorEventLoop(AccountedSelector())

    def _long_callback(self, act: Activity, w0: int, dw: int, dc: int,
                       cause) -> None:
        if callable(cause):
            try:
                cause = cause()
            except Exception:  # noqa: BLE001 — evidence, best effort
                cause = None
        self.recorder.record("long-callback", activity=act.name,
                             start_mono=w0 / 1e9, wall_s=dw / 1e9,
                             cpu_s=dc / 1e9, cause=cause)

    # -- boot phases --

    @staticmethod
    def phase_start() -> Tuple[float, float]:
        """``(monotonic, process CPU)`` now: a phase's start."""
        return time.monotonic(), time.process_time()

    def phase_end(self, phase: str, started: Tuple[float, float],
                  cpu_s: Optional[float] = None, **labels) -> None:
        """Record ``phase`` from ``started`` (:meth:`phase_start`) to
        now; its CPU is the process's since then unless ``cpu_s``
        says otherwise (a phase that shares the loop with others)."""
        if cpu_s is None:
            cpu_s = time.process_time() - started[1]
        self.boot_phase(phase, started[0], time.monotonic(), cpu_s,
                        **labels)

    def boot_phase(self, phase: str, start: float, end: float,
                   cpu_s: float, **labels) -> None:
        labels = {"phase": phase,
                  **{k: str(v) for k, v in labels.items()}}
        key = tuple(sorted(labels.items()))
        self._phases[key] = (labels, start, end, cpu_s)
        if self._collector is not None:
            self._export_phase(labels, start, end, cpu_s)

    def _export_phase(self, labels: dict, start: float, end: float,
                      cpu_s: float) -> None:
        c = self._collector
        c.gauge(METRIC_PHASE, "seconds a boot phase took (end - start)"
                ).set(end - start, labels)
        c.gauge(METRIC_PHASE_END, "when a boot phase ended, on "
                "CLOCK_MONOTONIC (time.monotonic; one axis across the "
                "processes of a host)").set(end, labels)
        c.gauge(METRIC_PHASE_CPU, "CPU seconds a boot phase took"
                ).set(cpu_s, labels)
        if self.recorder is not None:
            self.recorder.record("boot-phase", start_mono=start,
                                 end_mono=end, seconds=end - start,
                                 cpu_s=cpu_s, **labels)

    # -- export --

    def bind(self, collector, recorder=None,
             stall_threshold: Optional[float] = None) -> None:
        """Export into ``collector`` (folded at each scrape) and record
        flight events into ``recorder``; phases recorded before the
        bind are exported now."""
        self._collector = collector
        self.recorder = recorder
        self._folded, self._children, self._other_folded = {}, {}, 0
        if stall_threshold is not None:
            self.threshold_ns = int(stall_threshold * 1e9)
        self._families = (
            collector.counter(METRIC_CPU, "event-loop CPU seconds by "
                              "activity (self time; activity=\"other\" "
                              "is the process's CPU no activity "
                              "named)"),
            collector.counter(METRIC_WALL, "event-loop wall seconds by "
                              "activity (self time)"),
            collector.counter(METRIC_CALLBACKS, "event-loop spans run by "
                              "activity"))
        self._other_child = self._families[0].labelled(
            {"activity": OTHER})
        self._other_child.inc(0)
        collector.on_expose(self.fold)
        self._gc_thread = threading.get_ident()
        if self._on_gc not in gc.callbacks:
            gc.callbacks.append(self._on_gc)
        for labels, start, end, cpu_s in list(self._phases.values()):
            self._export_phase(labels, start, end, cpu_s)

    def unbind(self) -> None:
        """Stop exporting, recording and watching the collector."""
        self._collector = self.recorder = None
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def fold(self) -> None:
        """Fold the totals since the last scrape into the counters."""
        with self._fold_lock:
            self._fold()

    def _fold(self) -> None:
        # spans in progress first: one that ends while this runs then
        # counts twice and "other" reads low, never high
        in_progress = self._in_progress_ns()
        named = 0
        for name, act in list(self._acts.items()):
            cpu, wall, calls = act.cpu_ns, act.wall_ns, act.calls
            named += cpu
            if not calls:
                continue
            children = self._children.get(name)
            if children is None:
                labels = {"activity": name}
                children = self._children[name] = tuple(
                    fam.labelled(labels) for fam in self._families)
            f_cpu, f_wall, f_calls = self._folded.get(name, (0, 0, 0))
            children[0].inc((cpu - f_cpu) / 1e9)
            children[1].inc((wall - f_wall) / 1e9)
            children[2].inc(calls - f_calls)
            self._folded[name] = (cpu, wall, calls)
        # CPU of the spans in progress belongs to their activities once
        # they end: it is not "other" now either
        other = time.process_time_ns() - named - in_progress
        if other > self._other_folded:
            self._other_child.inc((other - self._other_folded) / 1e9)
            self._other_folded = other

    def _in_progress_ns(self) -> int:
        """CPU the threads' open intervals have not shared out yet,
        taken as their busy wall so far at each thread's last ratio."""
        now = _wall_ns()
        out = 0
        for st in list(self._threads.values()):
            busy = now - st.wall0 - st.select_wall
            if busy > 0:
                out += int(busy * st.ratio)
        return out

    def totals(self) -> Dict[str, Tuple[int, int, int]]:
        """``{activity: (cpu_ns, wall_ns, calls)}`` (tests, status)."""
        return {name: (a.cpu_ns, a.wall_ns, a.calls)
                for name, a in self._acts.items()}


class Steps(collections.abc.Coroutine):
    """A coroutine whose every step its task runs is one span
    (:meth:`LoopAccountant.steps`); unbound, a plain step."""

    __slots__ = ("_acct", "_act", "_coro")

    def __init__(self, acct: LoopAccountant, act: Activity, coro) -> None:
        self._acct, self._act, self._coro = acct, act, coro

    def send(self, value):
        acct = self._acct
        if acct._collector is None:
            return self._coro.send(value)
        acct.begin(self._act)
        try:
            return self._coro.send(value)
        finally:
            acct.end()

    def throw(self, *exc):
        acct = self._acct
        if acct._collector is None:
            return self._coro.throw(*exc)
        acct.begin(self._act)
        try:
            return self._coro.throw(*exc)
        finally:
            acct.end()

    def close(self) -> None:
        self._coro.close()

    def __await__(self):
        return self._coro.__await__()


#: the process's accountant
ACCOUNT = LoopAccountant()
