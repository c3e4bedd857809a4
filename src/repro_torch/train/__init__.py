"""Training substrate: optimizer, loop, checkpointing, fault tolerance."""

from .checkpoint import Checkpointer  # noqa: F401
from .fault import FaultInjector, FaultTolerantRunner, remesh  # noqa: F401
from .optimizer import AdamW, cosine_warmup  # noqa: F401
from .train_loop import as_network, make_train_step, train  # noqa: F401

__all__ = ["Checkpointer", "FaultInjector", "FaultTolerantRunner", "remesh",
           "AdamW", "cosine_warmup", "as_network", "make_train_step",
           "train"]
