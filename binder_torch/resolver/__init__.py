"""Resolution engine (port of the reference's lib/server.js logic)."""
from binder_torch.resolver.engine import (  # noqa: F401
    DEFAULT_TTL,
    AnswerPlan,
    Resolver,
    SERVICE_CHILD_TYPES,
)
from binder_torch.resolver.precompile import Precompiler  # noqa: F401
