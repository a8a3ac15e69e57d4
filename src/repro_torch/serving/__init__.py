"""Serving engines of the port: the paged single-tier ``ServingEngine`` and
the one-shot two-tier ``EndCloudPipeline``."""

from repro_torch.serving.common import LinkStats, Request
from repro_torch.serving.endcloud import EndCloudPipeline, plan_tiers
from repro_torch.serving.engine import ServingEngine

__all__ = ["EndCloudPipeline", "LinkStats", "Request", "ServingEngine", "plan_tiers"]
