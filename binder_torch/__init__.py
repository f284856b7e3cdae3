"""binder_torch — the PyTorch port of ``binder_tpu``, a rebuild of
TritonDataCenter/binder, a service-discovery DNS server backed by a
ZooKeeper-style coordination store (SURVEY.md has the structural
analysis).

The package mirrors ``binder_tpu/`` path for path, so each module's
counterpart is found by name.  The DNS modules are transcriptions of the
reference and stay stdlib-only; ``torch`` is imported only by
:mod:`binder_torch.graft_entry`, the module that does device work:

- ``binder_torch.dns``       — DNS wire codec + asyncio server engine.
- ``binder_torch.store``     — coordination-store client interface, ZooKeeper
                               client and test server, in-memory
                               fake store, and the watch-driven mirror cache
                               (port of ``lib/zk.js``).
- ``binder_torch.resolver``  — query resolution engine (port of
                               ``lib/server.js``).
- ``binder_torch.policy``    — stale-serve degradation, admission control
                               and response rate limiting.
- ``binder_torch.metrics``   — Prometheus-style metric collectors + scrape
                               server (artedi / triton-metrics analog).
- ``binder_torch.config``    — defaults ← JSON config file ← CLI flags merge
                               (port of ``main.js`` option handling).
- ``binder_torch.shard``     — the reuseport shard group: mirror-owner
                               supervisor, mutation-log protocol and the
                               workers' replica store.
- ``binder_torch.recursion`` — cross-DC recursion: upstream DNS client,
                               UFDS (LDAP) resolver discovery.
- ``binder_torch.federation`` — multi-DC federation over the ``/dcs``
                               registry.
- ``binder_torch.graft_entry`` — the latency summary (mean, p50, p99) and
                               the data-parallel all-reduce, on the GPU.

Chaos fault injection is not in this package yet (ROADMAP.md queue A);
a config that asks for it fails with ``ModuleNotFoundError``.

Note (SURVEY §7.0): the reference contains no tensor/ML workload; this is a
control-plane system measured on DNS queries/sec and resolve latency.
"""

__version__ = "0.1.0"
