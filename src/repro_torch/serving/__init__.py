"""Serving engines of the port: the paged single-tier ``ServingEngine``,
the one-shot two-tier ``EndCloudPipeline``, the streaming two-tier
``EndCloudServingEngine``, the ``FleetServingEngine`` of many end devices
over one shared cloud, and the seeded load generator (``loadgen``)."""

from repro_torch.serving.common import LinkStats, Request, VirtualClock
from repro_torch.serving.endcloud import EndCloudPipeline, plan_tiers
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.fleet import FleetServingEngine
from repro_torch.serving.stream import EndCloudServingEngine

__all__ = [
    "EndCloudPipeline",
    "EndCloudServingEngine",
    "FleetServingEngine",
    "LinkStats",
    "Request",
    "ServingEngine",
    "VirtualClock",
    "plan_tiers",
]
