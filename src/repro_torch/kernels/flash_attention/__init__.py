"""flash_attention kernel package."""
from . import ops, ref  # noqa: F401
