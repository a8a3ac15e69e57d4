"""The port's fleet planning pieces against the reference's, numpy and
Python only (no model): ``fleet_cloud_share``, ``plan_fleet_splits``,
``place_fleet`` (with and without ``order``, ``capacity``, ``loads``,
``measured_gbps``, ``max_spill`` and ``expert_cost``), the eq. 10
``priority`` and its time terms, the peer link model,
``fleet_device_mask`` / ``shard_masks_for_fleet``, the registry's
``group_cost`` in ``group_priority_from_freq``, ``fleet_expert_shards`` /
``shard_expert_stacks``, the multi-server ``StageTimeline`` on the cases of
``tests/test_timeline.py``, ``FleetExpertRegistry`` on the cases of
``tests/test_expert_pool.py``'s registry section, ``HealthMonitor``'s backoff and
``StallGuard``, and ``PagePool.add_slots`` / ``mapped_for``, each
operation's result equal to the reference's.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import expertpool as jep
from repro.core import hardware as jhw
from repro.core import pipeline as jpl
from repro.core import selection as jsel
from repro.distributed import sharding as jsh
from repro.serving import common as jcommon
from repro.serving.fleet import FleetServingEngine as JFleet
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import expertpool as tep
from repro_torch.core import hardware as thw
from repro_torch.core import pipeline as tpl
from repro_torch.core import selection as tsel
from repro_torch.distributed import sharding as tsh
from repro_torch.serving import common as tcommon
from repro_torch.serving.fleet import FleetServingEngine as TFleet
from repro_torch.serving.endcloud import block_gflops

SIDES = ((jhw, jpl, jsel), (thw, tpl, tsel))


def sim_profiles(hw):
    """``tests/test_fleet.py``'s simulated devices, then every profile."""
    return [
        hw.DeviceProfile("weak-end", peak_gflops=0.5, mem_gb=4.0, mem_bw_gbs=25.0, net_gbps=0.25),
        hw.DeviceProfile("mid-end", peak_gflops=2.0, mem_gb=8.0, mem_bw_gbs=50.0, net_gbps=1.0),
        hw.DeviceProfile("strong-end", peak_gflops=4.0, mem_gb=16.0, mem_bw_gbs=100.0,
                         net_gbps=2.0),
        hw.DeviceProfile("cloud-sim", peak_gflops=24.0, mem_gb=80.0, mem_bw_gbs=500.0,
                         net_gbps=2.0),
        hw.DeviceProfile("dead-end", peak_gflops=1e-6, mem_gb=1e-9, mem_bw_gbs=1.0,
                         net_gbps=0.01),
    ] + [hw.PROFILES[k] for k in sorted(hw.PROFILES)]


def fleets(hw):
    """Device sets: the simulated trio, the chip smoke's fleet, and every
    single profile."""
    p = {q.name: q for q in sim_profiles(hw)}
    sets = [["weak-end", "mid-end", "strong-end"], ["jetson-orin", "jetson-orin", "phone-soc"],
            ["a100", "phone-soc"]]
    sets += [[k] for k in p]
    return [[p[k] for k in s] for s in sets]


STATES = [dict(), dict(mem_free=0.3), dict(cpu_free=0.5, bandwidth_free=0.2, power_free=0.7),
          dict(mem_free=1e-6)]


@pytest.mark.parametrize("cloud_servers", [1, 2, 4])
@pytest.mark.parametrize("ratio", [1.0, 0.25])
def test_fleet_splits_and_share_equal_the_reference(cloud_servers, ratio):
    cfg = get_config("switch-base")
    lg = [block_gflops(cfg)] * cfg.block_repeat
    out = []
    for hw, pl, _ in SIDES:
        res = []
        for devs in fleets(hw):
            for cloud in ("a100", "cloud-sim"):
                cc = {q.name: q for q in sim_profiles(hw)}[cloud]
                ccap = hw.capability(cc, hw.DeviceState())
                caps = [hw.capability(d, hw.DeviceState()) for d in devs]
                res.append(dataclasses.asdict(pl.fleet_cloud_share(ccap, cloud_servers, len(devs))))
                for pins in (None, [1] * len(devs)):
                    plans = pl.plan_fleet_splits(
                        lg, 2.0 * cfg.d_model, caps, ccap, cloud_servers=cloud_servers,
                        compression_ratio=ratio, edge_boundary=True, pin_splits=pins)
                    res.append([dataclasses.asdict(p) for p in plans])
        out.append(res)
    assert out[0] == out[1]


def _tasks(rng, n, task_cls):
    return [task_cls(i, gflops=float(rng.uniform(0.1, 80.0)),
                     comm_bytes=float(rng.uniform(10.0, 1e6)), request_id=i,
                     priority_class=int(rng.integers(0, 3)))
            for i in range(n)]


@pytest.mark.parametrize("seed", range(6))
def test_place_fleet_equals_the_reference(seed):
    """Random tasks and devices, every option alone and together."""
    out = []
    for hw, pl, _ in SIDES:
        rng = np.random.default_rng(seed)
        devs = fleets(hw)[seed % 3]
        n = len(devs)
        caps = [hw.capability(d, hw.DeviceState()) for d in devs]
        tasks = _tasks(rng, 9, pl.Task)
        cfg = pl.SchedulerConfig(alpha=float(rng.uniform(0.1, 0.9)),
                                 t_end=float(rng.choice([1e9, 60.0])))
        order = [int(i) for i in rng.permutation(len(tasks))]
        opts = dict(loads=list(rng.uniform(0, 100, n)),
                    measured_gbps=list(rng.uniform(0.01, 2.0, n)),
                    capacity=[int(c) for c in rng.integers(0, 4, n)],
                    expert_cost=list(rng.uniform(0, 1e-3, n)))
        res = [pl.place_fleet(tasks, caps, cfg)]
        for k, v in opts.items():
            res.append(pl.place_fleet(tasks, caps, cfg, **{k: v}))
        for spill in (None, 1.5, 10.0):
            res.append(pl.place_fleet(tasks, caps, cfg, order=order, max_spill=spill, **opts))
        res.append([pl.priority(t, pl.comm_time(t, 0.3, 0.5), cfg.eps) for t in tasks])
        res.append([pl.exec_time(t, caps[0]) for t in tasks])
        res.append([(pl.peer_link_gbps(a, b), pl.peer_link_gbps(a, b, lan_gbps=5.0),
                     pl.peer_comm_time(1e6, a, b), pl.peer_comm_time(1e6, a, b, lan_gbps=5.0))
                    for a, b in itertools.product([0.05, 0.3, 2.0], repeat=2)])
        with pytest.raises(ValueError, match="permutation"):
            pl.place_fleet(tasks, caps, cfg, order=[0] * len(tasks))
        with pytest.raises(ValueError, match="expert_cost"):
            pl.place_fleet(tasks, caps, cfg, expert_cost=[0.0] * (n + 1))
        out.append(res)
    assert out[0] == out[1]


@pytest.mark.parametrize("name", ["switch-base", "llama4-scout-17b-16e"])
@pytest.mark.parametrize("smoke", [False, True])
def test_fleet_masks_equal_the_reference(name, smoke):
    out = []
    for (hw, _, sel), (cfgf, smk) in zip(SIDES, ((jget, jsmoke), (get_config, smoke_config))):
        cfg = smk(cfgf(name)) if smoke else cfgf(name)
        m = cfg.moe
        res = []
        for devs in fleets(hw):
            for st in STATES:
                states = [hw.DeviceState(**st)] * len(devs)
                for eps in (1.0, 0.5):
                    res.append(sel.shard_masks_for_fleet(
                        devs, states, cfg.d_model, m.d_ff_expert, m.num_experts, m.num_groups,
                        gated=cfg.ffn_gated, eps=eps, selection_cap=m.local_selection_cap,
                        group_priority=list(range(m.num_groups))[::-1]).tolist())
        out.append(res)
    assert out[0] == out[1]
    assert any(sum(row) == 1 for res in out[1] for row in res)  # the never-empty rule fired


@pytest.mark.parametrize("seed", range(4))
def test_group_priority_with_cost_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        K = int(rng.choice([2, 4, 8]))
        gfs = [None, rng.uniform(0, 1, K), np.ones(K) / K]
        gf = gfs[int(rng.choice(3, p=[0.1, 0.6, 0.3]))]
        costs = [None, rng.uniform(0, 2, K), np.zeros(K), rng.uniform(0, 1, K + 1)]
        cost = costs[int(rng.integers(4))]
        assert tsel.group_priority_from_freq(gf, K, group_cost=cost) == \
            jsel.group_priority_from_freq(gf, K, group_cost=cost)


@pytest.mark.parametrize("seed", range(4))
def test_expert_shards_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    load = list(rng.choice([0.0, 1.0, 4.0, 5.0], size=8)) if seed % 2 else list(rng.uniform(0, 1, 16))
    for servers in (1, 2, 3, 4):
        shards = tsh.fleet_expert_shards(load, servers)
        assert shards == jsh.fleet_expert_shards(load, servers)
        w = np.arange(2 * len(load) * 3 * 2, dtype=np.float32).reshape(2, len(load), 3, 2)
        got = tsh.shard_expert_stacks({"wi": torch.from_numpy(w), "wo": torch.from_numpy(w + 1)},
                                      shards)
        want = jsh.shard_expert_stacks({"wi": jnp.asarray(w), "wo": jnp.asarray(w + 1)}, shards)
        for g, wd in zip(got, want):
            for k in ("wi", "wo"):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(wd[k]))
    with pytest.raises(ValueError):
        tsh.fleet_expert_shards(load, 0)


# -- the multi-server StageTimeline on tests/test_timeline.py's cases ---------

TIMELINE_CASES = {
    "multi_server": (dict(resources=["cloud"], capacity={"cloud": 2}),
                     [("cloud", 0.0, 1.0)] * 3),
    "backfill": (dict(resources=["cloud"]), [("cloud", 100.0, 5.0), ("cloud", 10.0, 5.0)]),
    "fcfs_gap": (dict(resources=["end"]),
                 [("end", 0.0, 2.0), ("end", 5.0, 2.0), ("end", 0.0, 3.0), ("end", 0.0, 3.0)]),
    "gap_too_small": (dict(resources=["end"]),
                      [("end", 0.0, 2.0), ("end", 3.0, 2.0), ("end", 0.0, 2.0)]),
    "isolation": (dict(resources=["end", "link"]), [("end", 0.0, 4.0), ("link", 0.0, 1.0)]),
    "add_resource": (dict(resources=["cloud"], capacity={"cloud": 2}),
                     [("cloud", 0.0, 1.0), ("+end0", 1), ("end0", 0.0, 2.0), ("+cloud", 1),
                      ("+end0", 1), ("cloud", 0.0, 1.0)]),
    "zero_service": (dict(resources=["end"]), [("end", 3.0, 0.0), ("end", 0.0, 1.0)]),
    "three_servers_random": (dict(resources=["cloud", "end"], capacity={"cloud": 3}), None),
}


@pytest.mark.parametrize("case", sorted(TIMELINE_CASES))
def test_stage_timeline_equals_the_reference(case):
    kw, ops = TIMELINE_CASES[case]
    if ops is None:
        rng = np.random.default_rng(0)
        ops = [(str(rng.choice(["cloud", "end"])), float(rng.uniform(0, 50)),
                float(rng.choice([0.0, rng.uniform(0, 5)]))) for _ in range(200)]
    out = []
    for mod in (jcommon, tcommon):
        tl = mod.StageTimeline(**kw)
        res = []
        for op in ops:
            if op[0].startswith("+"):
                tl.add_resource(op[0][1:], capacity=op[1])
            else:
                res.append(tl.occupy(*op))
            res.append((dict(tl.busy_s), tl.makespan_s, tl.serial_s, tl.free_at, tl.summary(),
                        {r: tl.n_servers(r) for r in tl.busy_s}))
        out.append(res)
    assert out[0] == out[1]


# -- the registry on tests/test_expert_pool.py's cases ------------------------


def _mk_registry(ep, nl=2, E=8, slab_bytes=1000, lan_gbps=None, uplinks=(1.0, 1.0), **kw):
    reg = ep.FleetExpertRegistry(nl, E, slab_bytes, lan_gbps=lan_gbps, **kw)
    pools, books = [], []
    for g in uplinks:
        pool = ep.ExpertSlabPool(num_slabs=8, n_layers=nl, num_experts=E, max_per_layer=4)
        log = []
        reg.register_lane(pool, link_gbps=lambda g=g: g,
                          book_link=lambda r, t, log=log: (log.append((r, t)), r + t)[1])
        pools.append(pool)
        books.append(log)
    return reg, pools, books


def _registry_scenarios(ep):
    """Every operation of the reference's registry tests, its results in
    order (``tests/test_expert_pool.py``, the registry section)."""
    rec = []
    # geometry check
    reg, _, _ = _mk_registry(ep)
    bad = ep.ExpertSlabPool(num_slabs=4, n_layers=3, num_experts=8, max_per_layer=2)
    with pytest.raises(ValueError, match="geometry"):
        reg.register_lane(bad, link_gbps=lambda: 1.0, book_link=lambda r, t: r + t)
    # replicate vs dedup
    reg, pools, _ = _mk_registry(ep)
    target = np.zeros(8, bool)
    target[:4] = True
    w0, _ = reg.plan_lane(0, [0], target, None)
    rec.append(w0)
    for lid, e in w0:
        pools[0].alloc(lid, e)
    rec.append(reg.plan_lane(1, [0], target, None))
    freq = np.zeros(8)
    freq[0] = freq[1] = 0.5
    rec.append(reg.plan_lane(1, [0], target, freq))
    pools[0].evict(0, 2)
    rec.append(reg.plan_lane(1, [0], target, freq))
    # source choice without and with a LAN, and a holder that evicted
    for lan in (None, 10.0):
        reg, pools, _ = _mk_registry(ep, uplinks=(1.0, 0.5), lan_gbps=lan)
        pools[0].alloc(0, 3)
        rec.append((reg.pick_source(1, 0, 3), reg.cloud_fetch_s(1), reg.peer_fetch_s(1, 0)))
        pools[0].evict(0, 3)
        rec.append(reg.pick_source(1, 0, 3))
    # peer bookings on the source's link
    reg, _, books = _mk_registry(ep, lan_gbps=10.0)
    rec.append((reg.book_peer(0, 1, 2.0, 0.25), books, reg.peer_fetches, reg.peer_bytes,
                reg.peer_bookings))
    # fleet map, unique residents, dedup ratio
    reg, pools, _ = _mk_registry(ep)
    pools[0].alloc(0, 1)
    pools[0].alloc(0, 2)
    pools[1].alloc(0, 1)
    f = np.zeros(8)
    f[1] = 0.9
    reg.note_freq(1, f)
    rec.append((reg.fleet_map(), reg.holders(0, 1), reg.holders(0, 1, exclude=0),
                reg.unique_residents(), reg.total_residents(), reg.dedup_ratio()))
    # placement cost feeds and the cloud load
    reg, pools, _ = _mk_registry(ep, nl=2, E=8)
    target = np.zeros(8, bool)
    target[:2] = True
    rec.append(reg.lane_miss_cost_s(0, [0], target))
    pools[0].alloc(0, 0)
    pools[0].alloc(0, 1)
    rec.append((reg.lane_miss_cost_s(0, [0], target), reg.group_fetch_costs(0, [0], 4).tolist(),
                reg.expert_fetch_costs(1, [0, 1]).tolist(), reg.cloud_expert_load().tolist()))
    # armed peer faults, liveness
    reg, pools, _ = _mk_registry(ep, lan_gbps=10.0, dedup_min_freq=0.3)
    with pytest.raises(ValueError):
        reg.inject_peer_faults(0)
    reg.inject_peer_faults(2)
    rec.append([reg.take_peer_fault() for _ in range(3)] + [reg.peer_fault_fallbacks])
    pools[0].alloc(1, 5)
    reg.set_lane_alive(0, False)
    rec.append((reg.lane_alive(0), reg.holders(1, 5), reg.pick_source(1, 1, 5),
                reg.unique_residents(), reg.fleet_map()))
    reg.set_lane_alive(0, True)
    rec.append((reg.holders(1, 5), reg.pick_source(1, 1, 5), reg.dedup_min_freq, reg.n_lanes))
    return rec


def test_registry_equals_the_reference():
    assert _registry_scenarios(tep) == _registry_scenarios(jep)


@pytest.mark.parametrize("tokens", [(90, 10), (0, 0), (5, 0)])
def test_fleet_hit_rate_weighting_equals_the_reference(tokens):
    def lane(hit, t):
        return {"expert_resident_slabs": 4, "expert_slab_capacity": 8, "expert_hit_rate": hit,
                "expert_bytes_down": 3, "expert_bytes_peer": 1, "expert_bytes_up": 0,
                "expert_prefetches": 2, "expert_peer_fetches": 1, "expert_evictions": 1,
                "expert_routed_tokens": t}

    class Fake:
        expert_registry = None

    lanes = [lane(0.5, tokens[0]), lane(1.0, tokens[1])]
    assert TFleet._expert_fleet_metrics(Fake(), lanes) == JFleet._expert_fleet_metrics(Fake(),
                                                                                         lanes)
    assert TFleet._expert_fleet_metrics(Fake(), [{}]) == {}


def test_health_monitor_and_stall_guard_equal_the_reference():
    from repro.serving import faults as jf
    from repro_torch.serving import faults as tf

    out = []
    for f in (jf, tf):
        hm = f.HealthMonitor(backoff_base_s=0.02, backoff_cap_s=0.1)
        res = [hm.backoff_s(a) for a in range(-1, 6)]
        res += [f.HealthMonitor().backoff_s(a) for a in range(6)]
        g = f.StallGuard(3)
        for sig in (1, 1, 2, 2, 2):
            g.note(sig)
        res.append(g.stalled_ticks)
        with pytest.raises(RuntimeError, match="livelock.*diag"):
            g.note(2, lambda: "diag")
        g.reset()
        res.append(g.stalled_ticks)
        out.append(res)
    assert out[0] == out[1]


def test_shared_page_pool_slots_equal_the_reference():
    """``PagePool.add_slots`` and ``mapped_for``: two lanes' slot blocks in
    one pool, table for table."""
    from repro.models.kvcache import PagePool as JPool
    from repro_torch.models.kvcache import PagePool as TPool

    out = []
    for P in (JPool, TPool):
        pool = P(24, 4, 6, n_slots=0)
        res = [pool.add_slots(2), pool.add_slots(3)]
        pool.reserve(1, 4)
        pool.reserve(3, 5)
        pool.map_range(1, 0, 9)
        pool.map_range(3, 0, 17)
        res += [pool.mapped_for(range(0, 2)), pool.mapped_for(range(2, 5)),
                pool.pages_in_use, pool.pages_available, pool.table.tolist()]
        pool.free(1)
        res += [pool.mapped_for(range(0, 2)), pool.defrag().tolist(), pool.table.tolist()]
        out.append(res)
    assert out[0] == out[1]
