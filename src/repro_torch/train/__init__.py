"""Training substrate: so far the crash-atomic :class:`Checkpointer`, which
the durable cluster deployments write through.  The optimizer, the loop and
the fault-tolerant runner come with the training slice."""

from .checkpoint import Checkpointer  # noqa: F401

__all__ = ["Checkpointer"]
