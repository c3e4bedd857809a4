"""Serving: request-level continuous batching on one host.

The API is :class:`Request` in, :class:`Response` out, through a
:class:`ServeEngine` over :class:`LocalDecodeBackend` (one slot-batched
decode step in this process, on the card unless asked for the CPU).  The
clustered decode farm, durable serving state and the deprecated
``FarmScheduler`` shim come with the cluster and durable slices.
"""

from .engine import (LocalDecodeBackend, Request, Response,  # noqa: F401
                     ServeEngine, build_decode_model)
from .toy import ToyLM  # noqa: F401

__all__ = ["Request", "Response", "ServeEngine", "LocalDecodeBackend",
           "build_decode_model", "ToyLM"]
