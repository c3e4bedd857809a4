"""Decoder LMs of the port (dense, VLM, MoE, SSM and hybrid families)."""

from .model import Model  # noqa: F401

__all__ = ["Model"]
