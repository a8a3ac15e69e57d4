"""Fleet-aware cloud expert sharding (the port's own copy of the two
serving-time functions of the reference's ``distributed/sharding.py``).

The fleet expert registry measures, per expert, the share of fleet traffic
whose misses drain to the cloud (``FleetExpertRegistry.cloud_expert_load``);
:func:`fleet_expert_shards` balances the experts across the cloud's
servers by that load, and :func:`shard_expert_stacks` slices the dense
stacked expert weights accordingly.  The mesh-time rules of that module
come with training on a mesh (ROADMAP queue A item 8b).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

__all__ = ["fleet_expert_shards", "shard_expert_stacks"]


def fleet_expert_shards(expert_load: Sequence[float], num_servers: int) -> List[List[int]]:
    """Greedy LPT partition of the experts over ``num_servers``: heaviest
    expert to the least-loaded server, expert id and server index breaking
    ties.  Returns one sorted expert-id list a server, covering every
    expert once."""
    if num_servers < 1:
        raise ValueError(f"num_servers={num_servers}")
    load = [float(x) for x in expert_load]
    shards: List[List[int]] = [[] for _ in range(num_servers)]
    totals = [0.0] * num_servers
    for e in sorted(range(len(load)), key=lambda e: (-load[e], e)):
        s = min(range(num_servers), key=lambda s: (totals[s], s))
        shards[s].append(e)
        totals[s] += load[e]
    return [sorted(s) for s in shards]


def shard_expert_stacks(moe_params: Dict[str, torch.Tensor],
                        shards: Sequence[Sequence[int]]) -> List[Dict[str, torch.Tensor]]:
    """Slice stacked expert weights ``{"wi": [R, E, d, f], ...}`` along the
    expert axis into one dict a server (each holds only its experts' rows)."""
    out = []
    for shard in shards:
        out.append({k: leaf.index_select(1, torch.as_tensor(list(shard), dtype=torch.long,
                                                            device=leaf.device))
                    for k, leaf in moe_params.items()})
    return out
