"""Multi-shard serving: N worker processes, one mirror owner.

``main.py --shards N`` (config ``shards``) forks N workers, each
running the full serve stack on kernel-balanced ``SO_REUSEPORT``
sockets, while one supervisor holds the single ZK session/mirror and
fans mutations out over per-shard UNIX socketpair mutation logs
(snapshot + replay on attach).  See docs/operations.md "Sharded
serving" and docs/observability.md for the ``binder_shard_*`` family.
"""
from binder_torch.shard.replica import ReplicaStore, ShardLinkDown  # noqa: F401
from binder_torch.shard.supervisor import ShardSupervisor  # noqa: F401
