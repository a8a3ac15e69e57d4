"""Serving engines of the port: the paged single-tier ``ServingEngine``,
the one-shot two-tier ``EndCloudPipeline`` and the streaming two-tier
``EndCloudServingEngine``."""

from repro_torch.serving.common import LinkStats, Request
from repro_torch.serving.endcloud import EndCloudPipeline, plan_tiers
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.stream import EndCloudServingEngine

__all__ = [
    "EndCloudPipeline",
    "EndCloudServingEngine",
    "LinkStats",
    "Request",
    "ServingEngine",
    "plan_tiers",
]
