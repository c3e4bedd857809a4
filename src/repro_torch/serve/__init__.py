"""Serving: request-level continuous batching.

The API is :class:`Request` in, :class:`Response` out, through a
:class:`ServeEngine` over :class:`LocalDecodeBackend` (one slot-batched
decode step in this process) or :class:`ClusterDecodeBackend` (the decode
farm of :func:`make_decode_farm` parked warm on a cluster deployment,
surviving host kills, scaling by an epoch bump), on the card unless asked
for the CPU.  The request table and the caches persist through a
``DeploymentStore`` when one is given (``ServeEngine(store=)``,
``ServeEngine.adopt``).  :class:`FarmScheduler` is the deprecated shim.
"""

from .engine import (ClusterDecodeBackend, LocalDecodeBackend,  # noqa: F401
                     Request, Response, ServeEngine, build_decode_model,
                     make_decode_farm)
from .scheduler import FarmScheduler  # noqa: F401
from .toy import ToyLM  # noqa: F401

__all__ = ["Request", "Response", "ServeEngine", "LocalDecodeBackend",
           "ClusterDecodeBackend", "FarmScheduler", "build_decode_model",
           "make_decode_farm", "ToyLM"]
