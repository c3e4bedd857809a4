"""Logical-axis annotations of activations, on one device.

The models annotate activations with *logical* axes ("batch", "seq",
"heads", "ff", ...), so that one model definition serves every mesh.  The
port runs on one card, so :func:`act` only checks that the annotation names
one axis per dimension and returns ``x`` unchanged; the mapping of logical
axes to a device mesh comes with the multi-device slice.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["act"]


def act(x, *logical: Optional[str]):
    """Annotate the dims of activation ``x`` with logical axes (a no-op on
    one device, after the rank check)."""
    if x is None:
        return x
    if x.ndim != len(logical):
        raise ValueError(f"act: rank {x.ndim} vs {len(logical)} logical axes")
    return x
