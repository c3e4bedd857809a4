"""Decoder LMs of the port (dense and VLM families so far)."""

from .model import Model  # noqa: F401

__all__ = ["Model"]
