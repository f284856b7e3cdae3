"""Cross-datacenter recursion (port of lib/recursion.js)."""
from binder_torch.recursion.client import (  # noqa: F401
    DnsClient,
    UpstreamError,
)
from binder_torch.recursion.recursion import (  # noqa: F401
    Recursion,
    ResolverSource,
    StaticResolverSource,
)
from binder_torch.recursion.ufds import (  # noqa: F401
    LdapClient,
    LdapError,
    UfdsResolverSource,
)
