"""Live introspection & health layer (the kang/mdb analog).

Four pieces (docs/observability.md "State introspection"):

- :class:`~binder_torch.introspect.status.Introspector` — consistent
  JSON state snapshot served on the metrics server's ``/status`` route
  and pretty-printed by ``bin/bstat``;
- :class:`~binder_torch.introspect.flight_recorder.FlightRecorder` —
  bounded event ring (session transitions, watch storms, slow queries,
  resolver errors, loop stalls) dumped to disk on SIGUSR2;
- :class:`~binder_torch.introspect.watchdog.LoopLagWatchdog` — samples
  event-loop scheduling lag into ``binder_loop_lag_seconds`` and fires
  ``loop-stall`` events;
- :class:`~binder_torch.introspect.balancer_fold.BalancerStatsFold` —
  folds the balancer's stats-socket stage counters into the Prometheus
  scrape so one scrape covers the C and Python layers.
"""
from binder_torch.introspect.balancer_fold import BalancerStatsFold
from binder_torch.introspect.flight_recorder import FlightRecorder
from binder_torch.introspect.status import Introspector
from binder_torch.introspect.watchdog import LoopLagWatchdog

__all__ = ["BalancerStatsFold", "FlightRecorder", "Introspector",
           "LoopLagWatchdog"]
