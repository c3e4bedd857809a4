"""Data substrate: the Emit terminal at framework scale."""

from .pipeline import (Prefetcher, SyntheticLM, TokenSource,  # noqa: F401
                       shard_batch)

__all__ = ["Prefetcher", "SyntheticLM", "TokenSource", "shard_batch"]
