"""Serving engines of the port."""

from repro_torch.serving.common import Request
from repro_torch.serving.engine import ServingEngine

__all__ = ["Request", "ServingEngine"]
