"""The fleet expert store under faults, the port against the reference on
smoke llama4-scout (8 experts in 4 groups, gated experts and a shared
expert) with ``test_torch_chaos.py``'s harness: three a100 lanes at splits
2, 3 and 1 with pooled experts under the fleet registry and a modeled
end<->end LAN, in f32 on the CPU, ``timing="modeled"`` on a
``VirtualClock``.  Measured routing skew turns lane 0 hot on group 2, then
lane 1, so lane 1's new slabs come from lane 0 over the LAN
(``test_torch_fleet_experts.py``'s peer scenario).

* A ``peer_fetch_fail`` event fired by the injector meets lane 1's first
  peer fetch: one backoff, the slab re-sourced from the cloud.
* Lane 0 dies while lane 1 is fetching from it: the fetches left name a
  dead holder, re-price and take the cloud; lane 0's slabs and prefetch
  queue go with it, its slots migrate to lanes at other splits; a cloud
  server is lost and the re-sharded expert layout returned equals the
  reference's; lane 0 recovers cold and fetches its residency again.

Fire log, placement log, replans, every metric (the expert counters and
the registry's included), tokens and stamps equal the reference's.
"""

import pytest
import torch

from test_torch_chaos import assert_runs_equal, both, held_pages, run
from test_torch_fleet import bridge_pair, prompts
from test_torch_fleet_experts import skew_actions

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def moe():
    return bridge_pair("llama4-scout-17b-16e", 4)


def requests(R):
    return [R(i, p, max_new_tokens=24) for i, p in enumerate(prompts(6, 11))]


FLEET = dict(ends=lambda hw: [hw.PROFILES["a100"]] * 3, cloud=lambda hw: hw.PROFILES["a100"],
             max_batch=3, force_splits=[2, 3, 1], expert_peer_gbps=5.0, preemption=False, max_len=64,
             requests=requests)


def with_skew(extra=None):
    acts = skew_actions()

    def hook(f, tick, notes):
        if tick in acts:
            acts[tick](f)
        if extra is not None:
            extra(f, tick, notes)
    return hook


def test_peer_fault_through_the_injector(moe):
    j, t = both(moe, hook=with_skew(), faults=[(0.0, "peer_fetch_fail", dict(count=1))],
                **FLEET)
    assert_runs_equal(j, t)
    f, m = t.fleet, t.fleet.metrics()
    assert f.expert_registry.peer_fault_fallbacks == 1 == j.fleet.expert_registry.peer_fault_fallbacks
    assert m["transfer_retries"] == 1 == m["per_device"][1]["transfer_retries"]
    clean = run("torch", moe, hook=with_skew(), **FLEET)
    mc = clean.fleet.metrics()
    assert clean.tokens == t.tokens
    assert m["expert_peer_fetches"] == mc["expert_peer_fetches"] - 1 >= 1
    assert m["expert_bytes_down"] == mc["expert_bytes_down"] + f.lanes[1]._slab_bytes


def test_holder_dies_mid_peer_fetch_and_recovers_cold(moe):
    def faults(f, tick, notes):
        lane, reg = f.lanes[0], f.expert_registry
        if tick == 8:
            notes["peer_before"] = f.lanes[1].n_expert_peer_fetches
            notes["bookings_at_crash"] = len(reg.peer_bookings)
            notes["queue_1"] = len(f.lanes[1]._prefetch_queue)
            notes["held"] = [held_pages(f, i) for i in range(3)]
            notes["slabs_before"] = lane.expert_pool.slabs_in_use
            f.fail_lane(0)
            notes["slabs_after"] = lane.expert_pool.slabs_in_use
            notes["queue_0"] = len(lane._prefetch_queue)
            notes["alive"] = reg.lane_alive(0)
            notes["parked"] = sorted(f._migrating)
        elif tick == 12:
            notes["shards"] = f.fail_cloud_server()
        elif tick == 20:
            notes["prefetches_down"] = lane.n_expert_prefetches
            notes["peer_down"] = f.lanes[1].n_expert_peer_fetches
            notes["bookings_down"] = reg.peer_bookings[notes["bookings_at_crash"]:]
            f.recover_lane(0)
            notes["queue_recovered"] = len(lane._prefetch_queue)
            notes["alive_again"] = reg.lane_alive(0)

    j, t = both(moe, hook=with_skew(faults), **FLEET)
    assert_runs_equal(j, t)
    n, f = t.notes, t.fleet
    m = f.metrics()
    assert all(h > 0 for h in n["held"]) and n["queue_1"] > 0 and n["parked"]
    assert n["slabs_before"] > 0 and n["slabs_after"] == 0 and n["queue_0"] == 0
    assert not n["alive"] and n["alive_again"]
    assert n["shards"] is not None and len(n["shards"]) == 1 and f.cloud_servers == 1
    assert n["queue_recovered"] > 0
    assert f.lanes[0].n_expert_prefetches > n["prefetches_down"]  # the cold re-fetch
    assert f.lanes[0].expert_pool.slabs_in_use > 0
    assert m["migrations"] == m["migration_restores"] == len(n["parked"])
    dest = {p["request_id"]: p["device"] for p in f.placed}  # the last placement of each
    assert all(f.lanes[dest[rid]].split != 2 for rid in n["parked"])
    clean = run("torch", moe, hook=with_skew(), **FLEET)
    # a migrated request finishes under its new lane's end mask; the others
    # keep the tokens of the run without faults
    assert {r: v for r, v in clean.tokens.items() if r not in n["parked"]} == {
        r: v for r, v in t.tokens.items() if r not in n["parked"]}
    # while lane 0 was down no peer fetch came from it: lane 1's fetches
    # left after the crash took the cloud
    assert all(src != 0 for src, _, _ in n["bookings_down"])
    assert n["peer_down"] == n["peer_before"] < clean.fleet.lanes[1].n_expert_peer_fetches
