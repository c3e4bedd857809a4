"""The port's models: decoder LMs (dense, VLM, MoE, SSM and hybrid
families) and the encoder-decoder (audio), behind one facade."""

from .model import Model  # noqa: F401

__all__ = ["Model"]
