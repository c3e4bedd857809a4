"""Serving: request-level continuous batching on one host.

The API is :class:`Request` in, :class:`Response` out, through a
:class:`ServeEngine` over :class:`LocalDecodeBackend` (one slot-batched
decode step in this process, on the card unless asked for the CPU), whose
request table and cache persist through a ``DeploymentStore`` when one is
given (``ServeEngine(store=)``, ``ServeEngine.adopt``).  The clustered
decode farm and the deprecated ``FarmScheduler`` shim come with the cluster
serving slice.
"""

from .engine import (LocalDecodeBackend, Request, Response,  # noqa: F401
                     ServeEngine, build_decode_model)
from .toy import ToyLM  # noqa: F401

__all__ = ["Request", "Response", "ServeEngine", "LocalDecodeBackend",
           "build_decode_model", "ToyLM"]
