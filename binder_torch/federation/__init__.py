"""Multi-datacenter federation: N binder clusters serving one namespace.

The reference's L5 does best-effort cross-DC resolution by forwarding
foreign names to binders in other datacenters, discovering those peers
through UFDS (``lib/recursion.js``).  This package is the rebuild's
multi-cluster layer:

- :mod:`binder_torch.federation.registry` — peer discovery from a watched
  ``/dcs`` subtree in the coordination store (DC records carry name,
  zone cuts, and peer addresses; membership changes propagate like any
  other store mutation).
- :mod:`binder_torch.federation.federation` — the serving-plane half:
  routes foreign names through the existing recursion client
  (breaker-filtered, hedged, budgeted, single-flighted), keeps a
  foreign-answer cache, and serves stale under the degradation policy
  when the owning DC is dark (TTL-clamped, withheld past the staleness
  cap — never a timeout).
"""
from binder_torch.federation.federation import Federation
from binder_torch.federation.registry import DcRegistry

__all__ = ["Federation", "DcRegistry"]
