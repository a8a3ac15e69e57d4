"""The end tier's expert slab pool and the pieces of replanning, against the
reference: ``core/expertpool.py`` (slab bytes, store, ``write_slabs``,
``ExpertSlabPool`` decisions over random operation sequences,
``device_resident_tables``), ``core/moe.py::moe_resident`` and the resident
expert FFN's oracle ``kernels/expert_mlp/ref.py::expert_mlp_resident_ref``,
the page moves of a re-split (``page_perm``, ``resplit_paged_blocks``,
``PagePool.defrag``), the replan functions of ``core/pipeline.py``,
``group_priority_from_freq``, and the streaming engine through a memory
shrink and regrow (``benchmarks/decode_pipeline.py::run_expert`` at smoke
size), where the reference evicts and prefetches slabs.  f32, numpy inputs
made from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import expertpool as jep
from repro.core import hardware as jhw
from repro.core import moe as jmoe
from repro.core import pipeline as jpipe
from repro.core import selection as jsel
from repro.kernels.expert_mlp.ref import expert_mlp_resident_ref
from repro.models import kvcache as jkv
from repro.models.model import build_model
from repro.serving.common import Request as JRequest
from repro.serving.stream import EndCloudServingEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import expertpool as tep
from repro_torch.core import hardware as thw
from repro_torch.core import gating as tg
from repro_torch.core import moe as tmoe
from repro_torch.core import pipeline as tpipe
from repro_torch.core import selection as tsel
from repro_torch.kernels.expert_mlp import grouped_mlp_resident_plain
from repro_torch.models import kvcache as tkv
from repro_torch.models.model import Model
from repro_torch.serving import EndCloudServingEngine, Request

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

NAMES = ["switch-base", "llama4-scout-17b-16e"]


def _cfgs(name, **kw):
    jcfg = jsmoke(jget(name)).replace(dtype="float32", param_dtype="float32", **kw)
    cfg = smoke_config(get_config(name)).replace(dtype="float32", param_dtype="float32", **kw)
    return jcfg, cfg


def _np(t):
    return np.asarray(t)


# -- the pool ---------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_slab_bytes_and_store_match_reference(name):
    jcfg, cfg = _cfgs(name)
    assert tep.expert_slab_bytes(cfg) == jep.expert_slab_bytes(jcfg)
    jstore = jep.init_slab_store(jcfg, 5)
    tstore = tep.init_slab_store(cfg, 5, device="cpu")
    assert set(tstore) == set(jstore)
    for k in jstore:
        assert tuple(tstore[k].shape) == jstore[k].shape and not tstore[k].any()
        assert tstore[k].dtype == torch.float32
    # the int8 store: codes plus one f32 scale per output column
    assert tep.expert_slab_bytes(cfg, quantized=True) == jep.expert_slab_bytes(
        jcfg, quantized=True)
    jstore = jep.init_slab_store(jcfg, 5, quantized=True)
    tstore = tep.init_slab_store(cfg, 5, quantized=True, device="cpu")
    assert set(tstore) == set(jstore)
    for k in jstore:
        assert tuple(tstore[k].shape) == jstore[k].shape and not tstore[k].any()
        assert str(tstore[k].dtype).removeprefix("torch.") == str(jstore[k].dtype)


@pytest.mark.parametrize("name", NAMES)
def test_write_slabs_matches_reference(name):
    jcfg, cfg = _cfgs(name, num_layers=4)
    R, E = cfg.block_repeat, cfg.moe.num_experts
    rng = np.random.default_rng(1)
    full = {k: rng.standard_normal((R, E, *shape)).astype(np.float32)
            for k, shape in (("wi", (cfg.d_model, cfg.moe.d_ff_expert)),
                             ("wo", (cfg.moe.d_ff_expert, cfg.d_model)))}
    if cfg.ffn_gated:
        full["wg"] = rng.standard_normal(full["wi"].shape).astype(np.float32)
    asg = [(3, 0, 5), (0, R - 1, 2), (6, 1, 0), (1, 0, E - 1)]
    want = jep.write_slabs(jep.init_slab_store(jcfg, 7), {k: jnp.asarray(v) for k, v in
                                                           full.items()}, asg)
    got = tep.write_slabs(tep.init_slab_store(cfg, 7, device="cpu"),
                          {k: torch.from_numpy(v) for k, v in full.items()}, asg)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), _np(want[k]))


def _pool_pair(seed):
    rng = np.random.default_rng(seed)
    n_layers, E = int(rng.integers(1, 4)), 8
    num_slabs, per_layer = int(rng.integers(2, 12)), int(rng.integers(1, 5))
    return (jep.ExpertSlabPool(num_slabs, n_layers, E, per_layer),
            tep.ExpertSlabPool(num_slabs, n_layers, E, per_layer), rng)


def _assert_pools_equal(jp, tp):
    np.testing.assert_array_equal(tp.table, jp.table)
    np.testing.assert_array_equal(tp.last_used, jp.last_used)
    assert (tp.slabs_in_use, tp.capacity, tp._free) == (jp.slabs_in_use, jp.capacity, jp._free)


@pytest.mark.parametrize("seed", range(8))
def test_pool_decisions_match_reference(seed):
    """Random sequences of alloc, evict, plan (its evictions applied and its
    wanted experts allocated while room lasts), touch and set_capacity: the
    same decisions, tables and device tables on both sides."""
    jp, tp, rng = _pool_pair(seed)
    E = jp.num_experts
    for _ in range(60):
        op = rng.integers(5)
        layer = int(rng.integers(jp.n_layers))
        if op == 0:
            e = int(rng.integers(E))
            ok = jp.table[layer, e] < 0 and jp.resident_count(layer) < jp.max_per_layer \
                and jp.can_alloc()
            assert tp.can_alloc() == jp.can_alloc()
            if ok:
                assert tp.alloc(layer, e) == jp.alloc(layer, e)
        elif op == 1:
            res = np.nonzero(jp.table[layer] >= 0)[0]
            if len(res):
                e = int(rng.choice(res))
                assert tp.evict(layer, e) == jp.evict(layer, e)
        elif op == 2:
            active = sorted(set(rng.integers(jp.n_layers, size=rng.integers(1, 3)).tolist()))
            target = rng.random(E) < 0.4
            freq = rng.random(E) if rng.random() < 0.7 else None
            want = jp.plan(active, target, freq)
            got = tp.plan(active, target, freq)
            assert got == want
            for lid, e in want[1]:
                jp.evict(lid, e)
                tp.evict(lid, e)
            for lid, e in want[0]:
                if jp.can_alloc() and jp.resident_count(lid) < jp.max_per_layer:
                    assert tp.alloc(lid, e) == jp.alloc(lid, e)
        elif op == 3:
            active = list(range(jp.n_layers))
            target = rng.random(E) < 0.5
            jp.touch(active, target)
            tp.touch(active, target)
        else:
            cap = int(rng.integers(0, jp.num_slabs + 3))
            jp.set_capacity(cap)
            tp.set_capacity(cap)
        _assert_pools_equal(jp, tp)
        lids = list(range(jp.n_layers))
        want_t = jep.device_resident_tables(jp, lids, jp.max_per_layer)
        got_t = tep.device_resident_tables(tp, lids, tp.max_per_layer, device="cpu")
        for k in want_t:
            assert got_t[k].dtype == torch.int32
            np.testing.assert_array_equal(got_t[k].numpy(), _np(want_t[k]))


# -- moe_resident and the resident expert FFN -------------------------------


def _resident_case(cfg, jcfg, resident, ids_order=None, seed=3):
    """Layer 0 of a pool holds ``resident`` experts, the reference's params
    written into its store; returns (reference moe_resident params, the
    port's, the reference's moe params)."""
    E = cfg.moe.num_experts
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    S = len(resident) + 1  # one slot of headroom stays empty
    pool = jep.ExpertSlabPool(E, n_layers=2, num_experts=E, max_per_layer=E)
    # cycle every slab through layer 1 in a permuted order, so the
    # residents' slab ids are not ascending
    for e in ids_order or range(E):
        pool.alloc(1, e)
    for e in ids_order or range(E):
        pool.evict(1, e)
    for e in resident:
        pool.alloc(0, e)
    full = {k: p[k][None] for k in ("wi", "wg", "wo") if k in p}
    asg = [(int(pool.table[0, e]), 0, e) for e in resident]
    jstore = jep.write_slabs(jep.init_slab_store(jcfg, E), full, asg)
    jt = jep.device_resident_tables(pool, [0], S)
    jres = {"gate": p["gate"], "resident": {"ids": jt["ids"][0], "slot": jt["slot"][0],
                                            "store": jstore}}
    tres = params_from_numpy(jax.tree.map(np.asarray, jres), "cpu")
    return jres, tres, p


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("resident,mask", [
    ([0, 1, 4], [0, 1, 4]),  # the resident set is the mask
    ([0, 1, 2, 4, 6], [0, 1, 4]),  # a superset
    ([0, 4], [0, 1, 4]),  # a subset: expert 1 is routed away
    ([3, 7], None),  # no mask: only residents route
])
def test_moe_resident_matches_reference(name, resident, mask):
    jcfg, cfg = _cfgs(name)
    E = cfg.moe.num_experts
    jres, tres, p = _resident_case(cfg, jcfg, resident, ids_order=[5, 2, 7, 0, 3, 1, 6, 4])
    m = None if mask is None else np.isin(np.arange(E), mask)
    x = np.random.default_rng(4).standard_normal((16, cfg.d_model)).astype(np.float32)
    y_ref, jaux = jmoe.moe_resident(jres, jnp.asarray(x), jcfg, None if m is None else
                                    jnp.asarray(m))
    y, aux = tmoe.moe_resident(tres, torch.from_numpy(x), cfg,
                               None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(y.numpy(), _np(y_ref), rtol=1e-4, atol=1e-4)
    stats = tg.routing_stats(aux["topk_idx"], E, cfg.moe.num_groups)
    for k in ("expert_frac", "group_frac"):
        np.testing.assert_allclose(stats[k].numpy(), _np(jaux[k]), rtol=1e-6)
    assert stats["expert_frac"].numpy()[~np.isin(np.arange(E), resident)].sum() == 0
    if m is not None and set(mask) <= set(resident):
        # a resident superset of the routed experts: moe_sorted's result
        y_sorted, _ = jmoe.moe_sorted(p, jnp.asarray(x), jcfg, jnp.asarray(m))
        np.testing.assert_allclose(y.numpy(), _np(y_sorted), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_resident_ffn_matches_its_oracle(name):
    """``grouped_mlp_resident_plain`` over slot-sorted rows against the
    Pallas kernel's oracle over per-slot capacity buffers, with permuted
    slab ids, an empty slot, and rows on the garbage slot (exact 0)."""
    _, cfg = _cfgs(name)
    d, f, N = cfg.d_model, cfg.moe.d_ff_expert, 6
    rng = np.random.default_rng(5)
    store = {k: (rng.standard_normal((N + 1, *shape)) / shape[0] ** 0.5).astype(np.float32)
             for k, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    for w in store.values():
        w[N] = 0.0
    wg = store["wg"] if cfg.ffn_gated else None
    ids = np.asarray([4, 1, 2, N], np.int32)
    sizes = np.asarray([3, 0, 5, 2], np.int32)
    xs = rng.standard_normal((int(sizes.sum()), d)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in store.items()}
    got = grouped_mlp_resident_plain(
        torch.from_numpy(xs), torch.from_numpy(sizes), t["wi"],
        None if wg is None else t["wg"], t["wo"], torch.from_numpy(ids), cfg.act,
    ).numpy()
    S, C = 3, int(sizes[:3].max())
    buf = np.zeros((S, C, d), np.float32)
    start = np.concatenate([[0], np.cumsum(sizes)])
    for s in range(S):
        buf[s, : sizes[s]] = xs[start[s] : start[s + 1]]
    want = _np(expert_mlp_resident_ref(
        jnp.asarray(buf), jnp.asarray(store["wi"]), None if wg is None else jnp.asarray(wg),
        jnp.asarray(store["wo"]), jnp.asarray(ids[:S]), cfg.act))
    for s in range(S):
        np.testing.assert_allclose(got[start[s] : start[s + 1]], want[s, : sizes[s]],
                                   rtol=1e-4, atol=1e-4)
    assert (got[start[3]:] == 0).all()


# -- replanning's building blocks -------------------------------------------


def _lockstep_tables(rng, n_slots, pps, n_pages):
    """Two pools' tables mapping the same (slot, entry) set at different
    physical rows."""
    mapped = rng.random((n_slots, pps)) < 0.4
    n = int(mapped.sum())
    assert n <= n_pages
    tabs = []
    for _ in range(2):
        t = np.full((n_slots, pps), -1, np.int32)
        t[mapped] = rng.permutation(n_pages)[:n]
        tabs.append(t)
    return tabs


@pytest.mark.parametrize("seed", range(4))
def test_page_moves_match_reference(seed):
    """``page_perm`` both ways, ``resplit_paged_blocks`` in both directions,
    and ``PagePool.defrag`` on random lockstep tables."""
    rng = np.random.default_rng(seed)
    n_slots, pps, P = 4, 5, 16
    end_t, cloud_t = _lockstep_tables(rng, n_slots, pps, P)
    e2c, c2e = (tkv.page_perm(a, b, P, P) for a, b in ((end_t, cloud_t), (cloud_t, end_t)))
    np.testing.assert_array_equal(e2c, jkv.page_perm(end_t, cloud_t, P, P))
    np.testing.assert_array_equal(c2e, jkv.page_perm(cloud_t, end_t, P, P))
    R, old = 4, 2
    blocks = {w: {k: rng.standard_normal((n, P + 1, 2, 1, 4)).astype(np.float32)
                  for k in ("k", "v")} for w, n in (("end", old), ("cloud", R - old))}
    for new in (0, 1, 3, 4):
        jend, jcloud = jkv.resplit_paged_blocks(
            jax.tree.map(jnp.asarray, blocks["end"]), jax.tree.map(jnp.asarray, blocks["cloud"]),
            old, new, e2c, c2e)
        tend, tcloud = tkv.resplit_paged_blocks(
            {"pos0": {k: torch.from_numpy(v) for k, v in blocks["end"].items()}},
            {"pos0": {k: torch.from_numpy(v) for k, v in blocks["cloud"].items()}},
            old, new, e2c, c2e)
        for k in ("k", "v"):
            np.testing.assert_array_equal(tend["pos0"][k].numpy(), _np(jend[k]))
            np.testing.assert_array_equal(tcloud["pos0"][k].numpy(), _np(jcloud[k]))
    with pytest.raises(ValueError, match="lockstep"):
        bad = cloud_t.copy()
        bad[0, :] = -1
        bad[0, 0] = 0 if end_t[0, 0] < 0 else -1
        tkv.page_perm(end_t, bad, P, P)

    jpool, tpool = jkv.PagePool(P, 2, pps, n_slots=n_slots), tkv.PagePool(P, 2, pps, n_slots)
    for pool in (jpool, tpool):
        pool.table[:] = end_t
        pool._free = [p for p in range(P - 1, -1, -1) if p not in set(end_t[end_t >= 0])]
    np.testing.assert_array_equal(tpool.defrag(), jpool.defrag())
    np.testing.assert_array_equal(tpool.table, jpool.table)
    assert tpool._free == jpool._free


def _cap(rng, hw):
    return hw.Capability(gflop_budget=float(rng.uniform(0.5, 50)),
                         mem_budget_gb=float(rng.uniform(1, 16)),
                         net_gbps=float(rng.uniform(0.01, 5)))


@pytest.mark.parametrize("seed", range(6))
def test_replan_functions_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 8))
    lg = tuple(float(x) for x in rng.uniform(0.1, 2.0, n))
    caps = [(_cap(rng, jhw), _cap(rng, thw)) for _ in range(2)]
    # the same numbers on both sides
    caps = [(j, thw.Capability(**j.__dict__)) for j, _ in caps]
    kw = dict(compression_ratio=float(rng.uniform(0.1, 1)), alpha=float(rng.uniform(0, 1)),
              edge_boundary=bool(rng.integers(2)))
    jplan = jpipe.plan_pipeline_split(lg, 1536.0, caps[0][0], caps[1][0], **kw)
    tplan = tpipe.plan_pipeline_split(lg, 1536.0, caps[0][1], caps[1][1], **kw)
    for gbps in rng.uniform(0.001, 20, 4):
        want = jpipe.replan_pipeline(jplan, lg, 1536.0, caps[0][0], caps[1][0],
                                     measured_gbps=float(gbps), rel_threshold=0.15, **kw)
        got = tpipe.replan_pipeline(tplan, lg, 1536.0, caps[0][1], caps[1][1],
                                    measured_gbps=float(gbps), rel_threshold=0.15, **kw)
        assert got[1] == want[1] and got[0].__dict__ == want[0].__dict__
        assert tpipe.should_replan(tplan, got[0]) == jpipe.should_replan(jplan, want[0])
    jbw, tbw = jpipe.BandwidthEstimator(2.0), tpipe.BandwidthEstimator(2.0)
    assert tbw.gbps == jbw.gbps == 2.0
    for r in rng.uniform(0.01, 10, 6):
        if rng.random() < 0.3:
            assert tbw.set_rate(float(r)) == jbw.set_rate(float(r))
        else:
            assert tbw.observe_rate(float(r)) == jbw.observe_rate(float(r))


@pytest.mark.parametrize("freq", [None, [0.1, 0.5, 0.5, 0.2], [0.0] * 4, [np.nan, 1, 1, 1],
                                  [3.0, 1.0]])
def test_group_priority_matches_reference(freq):
    f = None if freq is None else np.asarray(freq)
    assert tsel.group_priority_from_freq(f, 4) == list(jsel.group_priority_from_freq(f, 4))


# -- the engine through a memory shrink and regrow ---------------------------


@pytest.mark.parametrize("opts", [
    {},
    # the pool's knobs: more resident slots than targets, 40% of the memory
    # budget for slabs (2 slabs, 1 after the shrink), one transfer a tick
    dict(expert_resident_slots=4, expert_mem_frac=0.4, expert_prefetch_per_tick=1),
])
def test_memory_shrink_and_regrow_match_reference(opts):
    """``benchmarks/decode_pipeline.py::run_expert`` at smoke size: a
    memory budget that holds the target set on the end layer, halved after
    6 ticks (the pool evicts at the next safe point) and restored after 6
    more with new requests (slabs are prefetched over the link timeline).
    The port takes the reference's decisions: the same tokens, counters and
    metrics."""
    name = "llama4-scout-17b-16e"
    jcfg, cfg = _cfgs(name, num_layers=4)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    slab = jep.expert_slab_bytes(jcfg)
    cap_n = int(np.floor(cfg.moe.local_selection_cap * cfg.moe.num_experts))

    def requests(cls, seed, base):
        rng = np.random.default_rng(seed)
        return [cls(base + i, rng.integers(0, 500, size=int(rng.integers(8, 24)))
                    .astype(np.int32), max_new_tokens=10) for i in range(4)]

    runs = {}
    for side, E, R, model, params, hw in (
            ("jax", JEngine, JRequest, jm, jp, jhw),
            ("torch", EndCloudServingEngine, Request, Model(cfg, device="cpu"), tp, thw)):
        end = hw.DeviceProfile("end-moe-sim", peak_gflops=2.0, mem_gb=2 * cap_n * slab / 1e9,
                               mem_bw_gbs=50.0, net_gbps=2.0)
        cloud = hw.DeviceProfile("cloud-sim", peak_gflops=6.0, mem_gb=80.0, mem_bw_gbs=500.0,
                                 net_gbps=2.0)
        eng = E(model, params, end_profile=end, cloud_profile=cloud, max_batch=4,
                max_len=128, force_split=1, timing="modeled", **opts)
        reqs = requests(R, 0, 0)
        for r in reqs:
            eng.submit(r)
        for _ in range(6):
            eng.step()
        eng.update_device_state(hw.DeviceState(mem_free=0.5))
        for _ in range(6):
            eng.step()
        evicted = eng.n_expert_evictions
        eng.update_device_state(hw.DeviceState(mem_free=1.0))
        reqs += requests(R, 1, 100)
        for r in reqs[4:]:
            eng.submit(r)
        eng.run()
        runs[side] = ([r.generated for r in reqs], eng, evicted)
    (jtok, jeng, jev), (ttok, teng, tev) = runs["jax"], runs["torch"]
    assert tev == jev and teng.n_expert_prefetches == jeng.n_expert_prefetches
    assert teng.expert_bytes_down == jeng.expert_bytes_down == teng.n_expert_prefetches * slab
    if not opts:
        assert tev == 2 and teng.n_expert_prefetches == 2  # 3 residents -> 1 -> 3
    assert tev > 0 and teng.n_expert_prefetches > 0
    # the prefetches ride the link, beside the boundary and prefill traffic
    own = teng._stage_busy["link"] + teng._prefill_busy["link"]
    assert teng.timeline.busy_s["link"] == pytest.approx(own + teng.expert_wire_s)
    assert ttok == jtok
    jm_, tm_ = jeng.metrics(), teng.metrics()
    assert {k: v for k, v in tm_.items() if k != "link_blackout_s"} == {
        k: v for k, v in jm_.items() if k != "link_blackout_s"}
    assert teng.end_pool.pages_in_use == 0
    if not opts:  # the regrown budget holds every target expert again
        assert tm_["expert_hit_rate"] == 1.0
