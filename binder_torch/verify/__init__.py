"""Serving-plane verification: incremental invariant checking +
mutation-to-glass propagation tracing.

``Verifier`` (checker.py) re-verifies only what each mutation can
affect, off the same invalidation feed the precompiler drains, with a
sampled time-budgeted background audit for drift the delta feed cannot
see.  ``PropagationTracer`` (tracer.py) stamps each mutation with a
trace context at the store event and folds per-stage latencies into
``binder_propagation_seconds``.
"""
from binder_torch.verify.checker import INVARIANTS, Verifier
from binder_torch.verify.tracer import STAGES, PropagationTracer

__all__ = ["INVARIANTS", "STAGES", "PropagationTracer", "Verifier"]
