"""The port's ``FleetServingEngine`` against the reference's on the same
weights (carried over by ``bridge.params_from_numpy``), in f32 on the CPU
with ``timing="modeled"``, on the reference fleet tests' dense model
(smoke tinyllama, 4 layers).

Every case holds the tokens, the placement log, the replan events and every
``metrics()`` key (``per_device`` included; only the wall-clock
``link_blackout_s`` is left out) equal to the reference's, the pools
drained.  Every multi-lane case also checks that two lanes held pages of
the one shared cloud pool at the same tick, one of them at a nonzero
``_cloud_base``: a lane indexing another's slot rows would change tokens
there.  Cases: one lane (which also equals the standalone engine), three
heterogeneous lanes over two cloud servers, a bandwidth cut on one lane,
a lane's replan moving blocks into and out of the one shared cloud storage
while another lane's pages live in it, speculative lanes (``spec_k=4``),
and ``defrag_kv`` mid-run.  (The expert
registry's cases: ``test_torch_fleet_experts.py``.)
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import hardware as jhw
from repro.models.model import build_model
from repro.serving.common import Request as JRequest
from repro.serving.fleet import FleetServingEngine as JFleet
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import hardware as thw
from repro_torch.models.model import Model
from repro_torch.serving import EndCloudServingEngine, FleetServingEngine, Request

torch.set_num_threads(1)

WALL_CLOCK = {"link_blackout_s"}


def bridge_pair(name, layers):
    jcfg = jsmoke(jget(name)).replace(num_layers=layers, dtype="float32", param_dtype="float32")
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = smoke_config(get_config(name)).replace(num_layers=layers, dtype="float32",
                                                 param_dtype="float32")
    return (jm, jp), (Model(cfg, device="cpu"), params_from_numpy(jax.tree.map(np.asarray, jp),
                                                                  "cpu"))


@pytest.fixture(scope="module")
def tiny():
    return bridge_pair("tinyllama-1.1b", 4)


def profiles(hw):
    """The reference fleet tests' simulated devices."""
    return {
        "weak": hw.DeviceProfile("weak-end", peak_gflops=0.5, mem_gb=4.0, mem_bw_gbs=25.0,
                                 net_gbps=0.25),
        "mid": hw.DeviceProfile("mid-end", peak_gflops=2.0, mem_gb=8.0, mem_bw_gbs=50.0,
                                net_gbps=1.0),
        "strong": hw.DeviceProfile("strong-end", peak_gflops=4.0, mem_gb=16.0,
                                   mem_bw_gbs=100.0, net_gbps=2.0),
        "cloud": hw.DeviceProfile("cloud-sim", peak_gflops=24.0, mem_gb=80.0, mem_bw_gbs=500.0,
                                  net_gbps=2.0),
        "a100": hw.PROFILES["a100"],
    }


def prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 500, size=int(rng.integers(4, 16))).astype(np.int32)
            for _ in range(n)]


def run_fleet(side, pair, *, ends, cloud="cloud", n_req=6, new=8, seed=0, actions=None,
              requests=None, **kw):
    """Serve ``n_req`` requests through a fleet of ``ends`` (profile names)
    on the reference (``side="jax"``) or the port, calling
    ``actions[tick](fleet)`` before that tick.  Returns (tokens by request
    id, fleet, the most lanes that held shared cloud pages at one tick)."""
    (jm, jp), (tm, tp) = pair
    jx = side == "jax"
    hw = jhw if jx else thw
    prof = profiles(hw)
    kw.setdefault("max_len", 64)
    fleet = (JFleet if jx else FleetServingEngine)(
        jm if jx else tm, jp if jx else tp, end_profiles=[prof[e] for e in ends],
        cloud_profile=prof[cloud], timing="modeled", **kw)
    R = JRequest if jx else Request
    reqs = ([R(i, p, max_new_tokens=new) for i, p in enumerate(prompts(n_req, seed))]
            if requests is None else [R(*a, **k) for a, k in requests])
    for r in reqs:
        fleet.submit(r)
    tick = most_live = 0
    while fleet.busy():
        if actions and tick in actions:
            actions[tick](fleet)
        fleet.step()
        most_live = max(most_live, sum(
            fleet.cloud_pool.mapped_for(range(l._cloud_base, l._cloud_base + l.max_batch)) > 0
            for l in fleet.lanes))
        tick += 1
        assert tick < 2000
    return {r.request_id: list(r.generated) for r in reqs}, fleet, most_live


def strip(m):
    if isinstance(m, dict):
        return {k: strip(v) for k, v in m.items() if k not in WALL_CLOCK}
    if isinstance(m, list):
        return [strip(v) for v in m]
    return m


def assert_fleets_equal(jres, tres, *, min_live=2):
    (jtok, jf, _), (ttok, tf, live) = jres, tres
    assert ttok == jtok
    assert all(len(t) > 0 for t in ttok.values())
    assert tf.placed == jf.placed
    assert tf.replan_events == jf.replan_events
    jm_, tm_ = jf.metrics(), tf.metrics()
    assert set(tm_) == set(jm_)
    assert strip(tm_) == strip(jm_)
    for jl, tl in zip(jf.lanes, tf.lanes):
        assert (tl.link.bytes_up, tl.link.bytes_down, tl.link.bytes_peer) == (
            jl.link.bytes_up, jl.link.bytes_down, jl.link.bytes_peer)
        assert tl.stage_trace_counts() == jl.stage_trace_counts()
        assert tl._cloud_base == jl._cloud_base
        assert tl.end_pool.pages_in_use == 0
    assert tf.cloud_pool.pages_in_use == tf.cloud_pool.pages_reserved == 0
    assert tf.timeline.busy_s == jf.timeline.busy_s
    assert tf.timeline.makespan_s == jf.timeline.makespan_s
    # two lanes' cloud rows live at one tick, one of them past lane 0's block
    assert live >= min_live
    if min_live >= 2:
        assert tf.lanes[1]._cloud_base > 0


def check(pair, min_live=2, **kw):
    res = [run_fleet(side, pair, **kw) for side in ("jax", "torch")]
    assert_fleets_equal(*res, min_live=min_live)
    return res[1]


def test_single_lane_equals_reference_and_standalone(tiny):
    """One lane: the reference fleet's tokens and metrics, and the
    standalone engine's tokens at the same split."""
    kw = dict(ends=["a100"], cloud="a100", cloud_servers=1, max_batch=4, force_splits=[2])
    j = run_fleet("jax", tiny, **kw)
    t = run_fleet("torch", tiny, **kw)
    assert_fleets_equal(j, t, min_live=1)
    (_, (tm, tp)) = tiny
    eng = EndCloudServingEngine(tm, tp, end_profile=thw.PROFILES["a100"],
                                cloud_profile=thw.PROFILES["a100"], max_batch=4, max_len=64,
                                force_split=2, timing="modeled")
    reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts(6))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert {r.request_id: r.generated for r in reqs} == t[0]
    assert t[1].lanes[0].split == 2


def test_heterogeneous_lanes_share_the_cloud(tiny):
    """Strong, mid and weak ends over two cloud servers: placement reaches
    every device and the shared cloud carries every lane's cloud seconds."""
    _, tf, _ = check(tiny, ends=["strong", "mid", "weak"], cloud_servers=2, max_batch=2,
                     max_spill=10.0, n_req=9, new=6, seed=3)
    assert {ev["device"] for ev in tf.placed} == {0, 1, 2}
    lane_cloud = sum(l._stage_busy["cloud"] + l._prefill_busy["cloud"] for l in tf.lanes)
    assert tf.metrics()["cloud_busy_s"] == pytest.approx(lane_cloud)
    assert [l._cloud_base for l in tf.lanes] == [0, 2, 4]
    # one cloud storage (the pool's pages, from the lowest split on) and one
    # copy of the compute-type weights behind every lane
    R = tf.cfg.block_repeat
    leaf = tf.cloud_kv.blocks["pos0"]["k"]
    assert leaf.shape[:2] == (R - min(l.split for l in tf.lanes), tf.cloud_pool.num_pages + 1)
    assert all(l._cloud_kv is tf.cloud_kv and l._cparams is tf.lanes[0]._cparams
               for l in tf.lanes)


@pytest.mark.parametrize("direction", ["to_cloud", "to_end"])
def test_lane_replan_across_the_shared_storage(tiny, direction):
    """Lane 1 re-splits while lane 0's pages live in the shared cloud
    storage: a blackout moves its blocks [0, 3) into the storage, below
    the lowest split it held so far (the storage grows downward, and only
    lane 1's pages are written); a faster link moves its blocks [0, R)
    out of it.  Tokens and metrics stay the reference's."""
    held = []

    def spy(f):
        lane = f.lanes[1]
        if hasattr(lane, "_resplit_shared"):  # the port's lane
            inner = lane._resplit_shared

            def resplit(*a):
                held.append([f.cloud_pool.mapped_for(l._own_cloud()) for l in f.lanes])
                return inner(*a)
            lane._resplit_shared = resplit

    if direction == "to_cloud":
        kw = dict(ends=["mid", "strong"], cloud="a100", force_splits=[2, 3])
        act = {0: spy, 3: lambda f: f.observe_bandwidth(1, 0.001),
               8: lambda f: f.observe_bandwidth(1, 1.0)}
        moves = [(3, 0)]
    else:
        kw = dict(ends=["a100", "a100"], cloud="cloud", force_splits=[1, 0])
        act = {0: spy, **{t: (lambda f: f.observe_bandwidth(1, 5.0)) for t in range(3, 8)}}
        moves = [(0, tiny[1][0].cfg.block_repeat)]
    _, tf, _ = check(tiny, cloud_servers=2, max_batch=2, n_req=8, new=16, actions=act, **kw)
    assert [(ev["old_split"], ev["new_split"]) for ev in tf.replan_events] == moves
    assert len(held) == 1 and all(n > 0 for n in held[0])
    assert tf.cloud_kv.base == min(kw["force_splits"] + [s for _, s in moves])


def test_bandwidth_cut_replans_only_that_lane(tiny):
    R = tiny[1][0].cfg.block_repeat
    act = {3: lambda f: f.observe_bandwidth(1, 0.25 * 0.05)}
    _, tf, _ = check(tiny, ends=["mid", "weak"], cloud_servers=1, max_batch=2,
                     force_splits=[R, R], actions=act)
    assert tf.replan_events and all(ev["device"] == 1 for ev in tf.replan_events)
    assert tf.lanes[1].split != R and tf.lanes[0].split == R


def test_speculative_lanes(tiny):
    _, tf, _ = check(tiny, ends=["a100", "a100"], cloud="a100", cloud_servers=2, max_batch=2,
                     force_splits=[2, 1], spec_k=4, link_rtt_s=0.05, prefill_chunk=8, n_req=5)
    m = tf.metrics()
    assert m["spec_rounds"] > 0 and m["spec_rollbacks"] >= 0
    assert all(pd["spec_plan_k"] > 1 for pd in m["per_device"])


def test_defrag_mid_run(tiny):
    """``defrag_kv`` compacts the shared pool and permutes the one cloud
    storage every lane views, once."""
    moved = []

    def defrag(f):
        before = f.cloud_pool.table.copy()
        f.defrag_kv()
        mapped = f.cloud_pool.table[f.cloud_pool.table >= 0]
        assert sorted(mapped.tolist()) == list(range(mapped.size))  # compact
        moved.append(not np.array_equal(before, f.cloud_pool.table))

    act = {t: defrag for t in (5, 9, 13, 17)}
    check(tiny, ends=["a100", "a100", "a100"], cloud="a100", cloud_servers=2, max_batch=2,
          force_splits=[2, 1, 3], n_req=10, new=10, actions=act)
    assert any(moved)  # some defrag moved live pages, on both sides


def test_placement_order_within_and_across_classes(tiny):
    """The frontend places in stable (priority, arrival) order: a later
    large request of the same class waits its turn, a later interactive one
    goes first; under FIFO admission arrival order alone."""
    big = np.arange(60, dtype=np.int32) % 500
    small = np.arange(4, dtype=np.int32)
    kw = dict(ends=["strong"], max_batch=1)
    for reqs, admission, order in (
        ([((0, small), dict(max_new_tokens=4)), ((1, big), dict(max_new_tokens=16))],
         "priority", [0, 1]),
        ([((0, big), dict(max_new_tokens=16, priority=2)),
          ((1, small), dict(max_new_tokens=4, priority=0))], "priority", [1, 0]),
        ([((0, big), dict(max_new_tokens=16, priority=2)),
          ((1, small), dict(max_new_tokens=4, priority=0))], "fifo", [0, 1]),
    ):
        res = [run_fleet(side, tiny, requests=reqs, admission=admission, max_len=128, **kw)
               for side in ("jax", "torch")]
        assert_fleets_equal(*res, min_live=1)
        assert [ev["request_id"] for ev in res[1][1].placed] == order


def test_fault_half_raises(tiny):
    """The fault entry points are ported (the fleet under faults against
    the reference: ``test_torch_chaos*.py``): each changes the fleet's
    state, and the oversized submit is still refused.  The name is the one
    the test had while they raised."""
    (_, (tm, tp)) = tiny
    f = FleetServingEngine(tm, tp, end_profiles=[thw.PROFILES["a100"]] * 2,
                           cloud_profile=thw.PROFILES["a100"], max_batch=2, max_len=64,
                           timing="modeled", cloud_servers=2)
    lane = f.lanes[0]
    f.fail_lane(0)
    assert f.lane_alive == [False, True] and f.lane_failures == 1 and not f.busy()
    f.recover_lane(0)
    assert f.lane_alive == [True, True] and f.lane_recoveries == 1
    nominal = lane.bw.gbps
    f.set_link_rate(0, nominal / 1000)
    assert lane.link_degraded and lane._pending_plan.split_layer == 0
    f.set_link_rate(0, nominal)
    assert not lane.link_degraded
    with pytest.raises(RuntimeError, match="registry"):
        f.inject_peer_faults(1)  # a dense fleet has no expert store
    f.inject_transfer_faults(0, 1)
    lane.inject_transfer_faults(1)
    assert lane._transfer_faults == 2
    assert f.fail_cloud_server() is None and f.cloud_servers == 1
    assert f.timeline.n_servers("cloud") == 1 and f.metrics()["cloud_server_failures"] == 1
    with pytest.raises(RuntimeError, match="last cloud server"):
        f.fail_cloud_server()
    assert lane.evacuate() == ([], {}, 0)
    with pytest.raises(ValueError, match="max_len"):
        f.submit(Request(0, np.arange(20, dtype=np.int32), max_new_tokens=60))
    assert f.waiting == []
