"""The port's fleet expert store (``FleetExpertRegistry`` wired through the
fleet's lanes) against the reference's on smoke llama4-scout (8 experts in
4 groups, gated experts and a shared expert), in f32 on the CPU with
``timing="modeled"``, with ``test_torch_fleet.py``'s harness: tokens,
placement log, replan events, every ``metrics()`` key, the pools drained,
two lanes on the shared cloud pool at once.

Cases: the registry against isolated pools at splits 0, 2 and 4; and the
reference's peer scenario (measured routing skew injected on one lane, then
the other, so the second lane's new slabs come from its peer over the
modeled end<->end link) with a peer fault armed (one backoff, the slab
re-sourced from the cloud, ``transfer_retries`` and the byte meters equal).
The peer scenario itself, registry and isolated, dense and int8 slabs:
``test_torch_fleet_peer.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_fleet import assert_fleets_equal, bridge_pair, run_fleet

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def moe():
    return bridge_pair("llama4-scout-17b-16e", 4)


def check(pair, **kw):
    res = [run_fleet(side, pair, **kw) for side in ("jax", "torch")]
    assert_fleets_equal(*res)
    return res[1][1]


@pytest.mark.parametrize("split", [0, 2, 4])
def test_registry_against_isolated_pools(moe, split):
    kw = dict(ends=["a100", "a100"], cloud="a100", cloud_servers=2, max_batch=2,
              force_splits=[split, split], n_req=4, new=6, seed=7)
    fleet = check(moe, expert_fleet=True, expert_peer_gbps=5.0, **kw)
    iso = check(moe, expert_fleet=False, **kw)
    assert iso.expert_registry is None
    tok = lambda f: {r.request_id: r.generated for r in f.finished}  # noqa: E731
    assert tok(fleet) == tok(iso)
    if split > 0:
        m = fleet.metrics()
        assert fleet.expert_registry.n_lanes == 2
        assert m["expert_resident_slabs"] == 2 * m["expert_unique_residents"]


def skew_actions(E=8, K=4):
    """Both lanes hot on group 2, lane 0 first: lane 1's grown mask then
    wants slabs lane 0 already holds."""
    gf = np.zeros(K)
    gf[2] = 1.0
    ef = np.zeros(E)
    ef[2 * (E // K): 3 * (E // K)] = 1.0 / (E // K)

    def hot(i):
        def act(f):
            f.lanes[i]._group_freq = gf.copy()
            f.lanes[i]._route_freq = ef.copy()
            f.update_device_state(i, type(f.lanes[i].end_state)())
        return act

    return {2: hot(0), 6: hot(1)}


PEER = dict(ends=["a100", "a100"], cloud="a100", cloud_servers=2, max_batch=2,
            force_splits=[2, 2], expert_peer_gbps=5.0, preemption=False, n_req=4, new=24,
            seed=11)


def test_peer_fault_falls_back_to_the_cloud(moe):
    acts = skew_actions()
    arm = acts[6]

    def arm_then_hot(f):
        f.expert_registry.inject_peer_faults(1)
        arm(f)

    acts[6] = arm_then_hot
    fleet = check(moe, expert_fleet=True, actions=acts, **PEER)
    m = fleet.metrics()
    assert m["transfer_retries"] == 1 == fleet.expert_registry.peer_fault_fallbacks
    assert m["per_device"][1]["transfer_retries"] == 1
    clean = check(moe, expert_fleet=True, actions=skew_actions(), **PEER)
    mc = clean.metrics()
    assert m["expert_peer_fetches"] == mc["expert_peer_fetches"] - 1
    assert m["expert_bytes_down"] == mc["expert_bytes_down"] + fleet.lanes[1]._slab_bytes
