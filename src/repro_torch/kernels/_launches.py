"""Launch counts that concurrent host threads cannot lose.

Each op counts its kernel's launches on the wrapper function
(``fn.launches``).  ``fn.launches += 1`` is a read, an add and a write: two
threads launching at once (a cluster's thread hosts on one card) could both
read the same value and one count would be lost.  :func:`count` takes a
lock around it.
"""

from __future__ import annotations

import threading

__all__ = ["count"]

_lock = threading.Lock()


def count(fn) -> None:
    """One launch of ``fn``'s kernel."""
    with _lock:
        fn.launches += 1
