"""Fault-injection (chaos) layer: prove behavior under failure.

- :class:`FaultPlan` — scriptable fault schedule (DSL or builder) +
  live upstream fault state;
- :class:`ChaosDriver` — plays a plan against a store (fake or ZK test
  server), a churn mutator, and the event loop;
- :class:`ChaosUpstream` — a recursion upstream applying the plan's
  packet-level faults (loss / delay / duplication / truncation /
  dead-peer).

Consumed by tests/test_torch_chaos.py, the chaos phase of
``chip_smoke.py``, and — via the ``chaos`` config block — a live server
under test (``main.py``).
"""
from binder_torch.chaos.plan import ChaosDriver, FaultPlan, UpstreamFaults
from binder_torch.chaos.upstream import ChaosUpstream

__all__ = ["ChaosDriver", "FaultPlan", "UpstreamFaults", "ChaosUpstream"]
