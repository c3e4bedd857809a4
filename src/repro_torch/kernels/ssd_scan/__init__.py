"""ssd_scan kernel package."""
from . import ops, ref  # noqa: F401
