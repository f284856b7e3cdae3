"""Graceful-degradation policy engine (docs/degradation.md).

Three cooperating levers, consuming the observability substrate:

- :class:`DegradationPolicy` — stale-serve state machine over the
  store session state (fresh / stale-serving / stale-exhausted),
  RFC 8767-style TTL clamping and a hard staleness cap;
- :class:`PeerBreakers` / :class:`CircuitBreaker` — per-upstream
  circuit breakers with exponential backoff + jitter, half-open
  probing, and the p95 hedge stagger for recursion forwards;
- :class:`AdmissionControl` — overload shedding: bounded in-flight
  table with oldest-shed and per-client token buckets for
  recursion-triggering queries;
- :class:`ResponseRateLimiter` — RRL-style per-client-prefix
  slip/drop at the UDP ingress (hostile-internet hardening).
"""
from binder_torch.policy.admission import AdmissionControl
from binder_torch.policy.breaker import CircuitBreaker, PeerBreakers
from binder_torch.policy.degrade import DegradationPolicy
from binder_torch.policy.rrl import ResponseRateLimiter

__all__ = ["AdmissionControl", "CircuitBreaker", "PeerBreakers",
           "DegradationPolicy", "ResponseRateLimiter"]
