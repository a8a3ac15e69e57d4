"""The reference's peer-fetch scenario on the port's fleet and the
reference's, smoke llama4-scout in f32 on the CPU (``timing="modeled"``):
measured routing skew is injected on lane 0, then lane 1, so lane 1's grown
mask wants slabs lane 0 already holds and the registry sources them from
the peer over the modeled end<->end link.  Registry and isolated pools,
f32 slabs and ``quantize_experts`` (the registry prices int8 slabs): tokens,
placement, replans and every metric equal the reference's
(``test_torch_fleet.py``'s harness), peer fetches happen, both ends of each
peer transfer ride the fleet timeline, and the peer-served bytes are the
ones the isolated run fetched from the cloud.
"""

import pytest
import torch

from test_torch_fleet import bridge_pair
from test_torch_fleet_experts import PEER, check, skew_actions

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def moe():
    return bridge_pair("llama4-scout-17b-16e", 4)


@pytest.mark.parametrize("quantize", [False, True], ids=["f32-slabs", "int8-slabs"])
def test_peer_fetch_scenario(moe, quantize):
    fleet = check(moe, expert_fleet=True, actions=skew_actions(), quantize_experts=quantize,
                  **PEER)
    iso = check(moe, expert_fleet=False, actions=skew_actions(), quantize_experts=quantize,
                **PEER)
    m, mi = fleet.metrics(), iso.metrics()
    reg = fleet.expert_registry
    assert m["expert_peer_fetches"] >= 1 and mi["expert_peer_fetches"] == 0
    assert m["expert_bytes_peer"] == m["expert_peer_fetches"] * fleet.lanes[0]._slab_bytes
    assert reg.slab_bytes == fleet.lanes[0]._slab_bytes
    assert all((src, dst) == (0, 1) for src, dst, _ in reg.peer_bookings)
    # each lane's link carries its own traffic plus the peer seconds it served
    for i, lane in enumerate(fleet.lanes):
        peer_out = sum(t for src, _, t in reg.peer_bookings if src == i)
        assert fleet.timeline.busy_s[f"link{i}"] == pytest.approx(
            lane._stage_busy["link"] + lane._prefill_busy["link"] + lane.expert_wire_s + peer_out)
    assert m["expert_bytes_down"] + m["expert_bytes_peer"] == mi["expert_bytes_down"]


