"""Coordination-store layer: client interface, fake store, mirror cache."""
from binder_torch.store.cache import (  # noqa: F401
    HOST_TYPES,
    MirrorCache,
    TreeNode,
    domain_to_path,
)
from binder_torch.store.fake import FakeStore  # noqa: F401
from binder_torch.store.interface import StoreClient, Watcher  # noqa: F401
