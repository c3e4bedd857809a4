"""moe_gmm kernel package."""
from . import ops, ref  # noqa: F401
