"""The port's streaming two-tier ``EndCloudServingEngine`` against the
reference's on the same weights (carried over by
``bridge.params_from_numpy``), in f32 on the CPU with ``timing="modeled"``:
greedy tokens, replan events, the link's byte meters, stage and chunk
counts, the expert pool's counters and every metric but the one that reads
the wall clock (``link_blackout_s``), at forced splits 0, mid and R with
the eq. 8 codec off and on, pooled against dense-mask end tiers, a hard
bandwidth replan, and the link-blackout rung.  Smoke switch-base
(non-gated GELU experts) and smoke llama4-scout (gated SiLU experts and a
shared expert).  Plus the fleet-sharing options (accepted) and the
streaming engine's fault entry points (evacuation, the cloud share,
transfer faults).
(Speculative decode and preemption are held to the reference in
``test_torch_specdecode.py`` and ``test_torch_preempt.py``.)
(The int8 streams are held to the reference in ``test_torch_stream_quant.py``.)
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import compression as jcomp
from repro.core import hardware as jhw
from repro.models.model import build_model
from repro.serving.common import Request as JRequest
from repro.serving.stream import EndCloudServingEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import hardware as thw
from repro_torch.core.expertpool import FleetExpertRegistry
from repro_torch.models.kvcache import PagePool
from repro_torch.models.model import Model
from repro_torch.serving import EndCloudServingEngine, Request
from repro_torch.serving.common import StageTimeline
from repro_torch.serving.faults import HealthMonitor

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

WALL_CLOCK = {"link_blackout_s"}  # the only metric that reads the host clock


@pytest.fixture(scope="module")
def models():
    """name -> (reference model, params), (port model, the same params)."""
    out = {}
    for name in ("switch-base", "llama4-scout-17b-16e"):
        jcfg = jsmoke(jget(name)).replace(num_layers=4, dtype="float32", param_dtype="float32")
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        cfg = smoke_config(get_config(name)).replace(num_layers=4, dtype="float32",
                                                      param_dtype="float32")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        out[name] = (jm, jp), (Model(cfg, device="cpu"), tp)
    return out


def _profiles(hw, kind):
    """(end, cloud): the a100 pair, or an end device of ``(peak GFLOP/s,
    link Gbps)`` beside the decode benchmark's simulated cloud
    (``benchmarks/decode_pipeline.py``), at which smoke models plan an
    interior split or move to one when the link changes."""
    if kind == "a100":
        return hw.PROFILES["a100"], hw.PROFILES["a100"]
    peak, net = kind
    return (hw.DeviceProfile("end-sim", peak_gflops=peak, mem_gb=8.0, mem_bw_gbs=50.0,
                             net_gbps=net),
            hw.DeviceProfile("cloud-sim", peak_gflops=6.0, mem_gb=80.0, mem_bw_gbs=500.0,
                             net_gbps=2.0))


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 500, size=int(rng.integers(4, 16))).astype(np.int32)
            for _ in range(n)]


def run_engine(side, pair, *, profiles="a100", rank=0, actions=None, n_req=5, new=8, **kw):
    """Serve ``n_req`` requests on the reference (``side="jax"``) or the
    port, calling ``actions[tick](engine)`` before that tick; returns
    (tokens, engine).  A codec is drawn once by the reference and carried
    across, so both sides compress with the same numbers."""
    (jm, jp), (tm, tp) = pair
    jx = side == "jax"
    hw = jhw if jx else thw
    end, cloud = _profiles(hw, profiles)
    codec = None
    if rank:
        codec = jcomp.init_lowrank_1d(jax.random.PRNGKey(7), jm.cfg.d_model, rank)
        if not jx:
            codec = params_from_numpy(jax.tree.map(np.asarray, codec), "cpu")
    eng = (JEngine if jx else EndCloudServingEngine)(
        jm if jx else tm, jp if jx else tp, end_profile=end, cloud_profile=cloud,
        codec_params=codec, max_batch=4, max_len=64, timing="modeled", **kw,
    )
    reqs = [(JRequest if jx else Request)(i, p, max_new_tokens=new)
            for i, p in enumerate(_prompts(n_req))]
    for r in reqs:
        eng.submit(r)
    tick = 0
    while eng.busy():
        if actions and tick in actions:
            actions[tick](eng, hw)
        eng.step()
        tick += 1
        assert tick < 500
    return [r.generated for r in reqs], eng


def assert_engines_equal(jtok, jeng, ttok, teng):
    assert ttok == jtok
    assert teng.replan_events == jeng.replan_events
    assert (teng.link.bytes_up, teng.link.bytes_down, teng.link.transfers) == (
        jeng.link.bytes_up, jeng.link.bytes_down, jeng.link.transfers)
    assert (teng.n_stage_steps, teng.n_prefill_chunks) == (jeng.n_stage_steps,
                                                           jeng.n_prefill_chunks)
    jm_, tm_ = jeng.metrics(), teng.metrics()
    assert set(tm_) == set(jm_)
    assert {k: tm_[k] for k in tm_ if k not in WALL_CLOCK} == {
        k: jm_[k] for k in jm_ if k not in WALL_CLOCK}
    assert teng.stage_trace_counts() == jeng.stage_trace_counts()
    assert teng.end_pool.pages_in_use == teng.cloud_pool.pages_in_use == 0


@pytest.mark.parametrize("name,split,rank", [
    ("llama4-scout-17b-16e", 0, 0),
    ("llama4-scout-17b-16e", 2, 16),
    ("llama4-scout-17b-16e", 4, 0),
    ("switch-base", 1, 16),
    ("switch-base", 2, 0),
])
def test_engine_matches_reference(models, name, split, rank):
    """Forced splits 0, mid and R (switch-base's smoke model has two
    blocks), the codec off and on: the end tier's experts are pooled."""
    pair = models[name]
    jtok, jeng = run_engine("jax", pair, force_split=split, rank=rank)
    ttok, teng = run_engine("torch", pair, force_split=split, rank=rank)
    R = pair[1][0].cfg.block_repeat
    assert teng.expert_pool is not None and teng.metrics()["expert_hit_rate"] == 1.0
    assert teng.split == split and teng.tiers.compress == (rank > 0 and 0 < split < R)
    assert_engines_equal(jtok, jeng, ttok, teng)


def test_pooled_matches_dense_mask(models):
    """The dense-mask end tier (``expert_pool=False``) equals the
    reference's, and the pooled end tier gives its tokens (every target
    expert is resident)."""
    pair = models["llama4-scout-17b-16e"]
    jtok, jeng = run_engine("jax", pair, force_split=2, expert_pool=False)
    ttok, teng = run_engine("torch", pair, force_split=2, expert_pool=False)
    assert teng.expert_pool is None
    assert_engines_equal(jtok, jeng, ttok, teng)
    pooled, _ = run_engine("torch", pair, force_split=2)
    assert pooled == ttok


@pytest.mark.parametrize("net,rate,moves,evictions", [
    (0.001, 1.0, [(1, 0)], 3),  # a faster link: the end layer leaves, its slabs go
    (0.01, 0.001, [(0, 1)], 0),  # a slower one: a block enters the end tier
])
def test_hard_bandwidth_replan(models, net, rate, moves, evictions):
    """A declared link rate (above the blackout rung) moves the split at the
    next safe point: the blocks' pages move between the tier pools, a layer
    leaving the end tier sheds its resident slabs, one entering it fills
    its residents at once; in-flight requests finish on the new split."""
    pair = models["llama4-scout-17b-16e"]
    act = {4: lambda e, hw: e.observe_bandwidth(rate, hard=True)}
    kw = dict(profiles=(1.0, net), rank=16, actions=act)
    jtok, jeng = run_engine("jax", pair, **kw)
    ttok, teng = run_engine("torch", pair, **kw)
    assert [(ev["old_split"], ev["new_split"]) for ev in teng.replan_events] == moves
    assert not teng.link_degraded and teng.n_expert_evictions == evictions
    assert_engines_equal(jtok, jeng, ttok, teng)


def test_link_blackout_rung(models):
    """A declared rate below ``blackout_gbps`` pins the plan to split 0 and
    counts degraded ticks; the recovery hands the plan back to the
    ordinary replan path."""
    pair = models["llama4-scout-17b-16e"]
    act = {3: lambda e, hw: e.observe_bandwidth(e.bw.gbps / 1000, hard=True),
           8: lambda e, hw: e.observe_bandwidth(e.tiers.end_cap.net_gbps, hard=True)}
    jtok, jeng = run_engine("jax", pair, force_split=2, actions=act, new=12)
    ttok, teng = run_engine("torch", pair, force_split=2, actions=act, new=12)
    assert teng.replan_events[0]["new_split"] == 0 and teng.degraded_ticks > 0
    assert not teng.link_degraded and teng.blackout_seconds() > 0
    assert_engines_equal(jtok, jeng, ttok, teng)


@pytest.fixture(scope="module")
def tiny():
    cfg = smoke_config(get_config("switch-base")).replace(num_layers=4)
    model = Model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _engine(tiny, **kw):
    model, params = tiny
    kw.setdefault("max_batch", 2)
    return EndCloudServingEngine(model, params, end_profile=thw.PROFILES["a100"],
                                 cloud_profile=thw.PROFILES["a100"], max_len=64,
                                 timing="modeled", force_split=1, **kw)


@pytest.mark.parametrize("option,value,match", [
    pytest.param("cloud_pool", lambda e: PagePool(64, 16, e.pages_per_slot), "5b",
                 id="cloud_pool-value0-fleet"),
    pytest.param("expert_registry",
                 lambda e: FleetExpertRegistry(e.expert_pool.n_layers, e.expert_pool.num_experts,
                                               e._slab_bytes),
                 "5b", id="expert_registry-value1-fleet"),
    pytest.param("timeline", lambda e: StageTimeline(["cloud"], capacity={"cloud": 2}), "5b",
                 id="timeline-value2-fleet"),
    pytest.param("resources", lambda e: ("e", "l", "c"), "5b", id="resources-value3-fleet"),
    pytest.param("health", lambda e: HealthMonitor(), "5b", id="health-value4-health"),
])
def test_unported_options_raise(tiny, option, value, match):
    """The fleet-sharing options are ported (the fleet engine passes them;
    ``test_torch_fleet.py`` holds it to the reference): each is accepted and
    wired in, and so is the fault half they belong to: a lane evacuated
    mid-decode hands back its request with a migrated spill state, and a
    lost cloud server re-scales the lane's share of the cloud.  The name and
    case ids are the ones the options had while they raised."""
    plain = _engine(tiny)
    v = value(plain)
    eng = _engine(tiny, **{option: v})
    if option == "cloud_pool":
        assert eng.cloud_pool is v and eng._cloud_shared and eng._cloud_base == 0
        assert eng._cloud_kv.num_pages == v.num_pages and eng._cloud_kv.base == eng.split
        assert v.table.shape[0] == eng.max_batch
    elif option == "expert_registry":
        assert eng.expert_registry is v and eng._registry_lane == 0 and v.n_lanes == 1
    elif option == "timeline":
        assert eng.timeline is v and v.n_servers("cloud") == 2
        assert {"end", "link", "cloud"} <= set(v.busy_s)
    elif option == "resources":
        assert (eng._res_end, eng._res_link, eng._res_cloud) == v
        assert set(eng.timeline.busy_s) == set(v)
    elif option == "health":
        assert eng.health is v
    for req in (Request(0, np.arange(5, dtype=np.int32), max_new_tokens=3),):
        eng.submit(req)
    eng.run()
    assert eng.finished and eng.cloud_pool.pages_in_use == 0
    # the fault half: evacuate a decoding slot, then lose cloud capacity
    req = Request(1, np.arange(6, dtype=np.int32), max_new_tokens=8)
    eng.submit(req)
    while not any(r is not None and len(r.generated) >= 2 for r in eng.slots):
        eng.step()
    reqs, spilled, nbytes = eng.evacuate()
    assert reqs == [req] and list(spilled) == [1] and spilled[1].migrated
    assert nbytes == spilled[1].nbytes > 0 and spilled[1].length >= len(req.prompt) + 1
    assert eng.cloud_pool.pages_in_use == eng.end_pool.pages_in_use == 0
    assert not eng.busy() and all(p == "ready" for p in eng._phase)
    budget = eng.tiers.cloud_cap.gflop_budget
    eng.set_cloud_share(0.5)
    assert eng._cloud_share == 0.5
    assert eng.tiers.cloud_cap.gflop_budget == pytest.approx(budget * 0.5)


def test_unported_methods_raise(tiny):
    """Transfer faults are ported: each armed fault fails one upload
    attempt, resent after a backoff and metered again
    (``transfer_retries``), with the same tokens; ``evacuate`` of an idle
    engine hands back nothing, and of a prefill in flight the request
    alone, to restart from scratch."""
    def serve(faults):
        eng = _engine(tiny)
        if faults:
            eng.inject_transfer_faults(faults)
        reqs = [Request(i, np.arange(4 + i, dtype=np.int32), max_new_tokens=4) for i in range(2)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return eng, {r.request_id: r.generated for r in reqs}

    clean, want = serve(0)
    eng, got = serve(3)
    assert got == want and eng.transfer_retries == 3 and eng._transfer_faults == 0
    assert eng.link.transfers == clean.link.transfers + 3
    assert eng.metrics()["transfer_retries"] == 3
    with pytest.raises(ValueError, match="count"):
        eng.inject_transfer_faults(0)
    idle = _engine(tiny)
    assert idle.evacuate() == ([], {}, 0)
    req = Request(0, np.arange(40, dtype=np.int32), max_new_tokens=4)
    idle.submit(req)
    idle.step()
    assert idle._jobs
    assert idle.evacuate() == ([req], {}, 0)
    assert not idle._jobs and idle.end_pool.pages_in_use == idle.cloud_pool.pages_in_use == 0
    assert req.generated == []


def test_preemption_that_would_spill_raises(tiny):
    """A blocked head that outranks a running lower-priority slot spills it
    (it raised before the spill was ported) and the spilled request resumes
    with the tokens of a run without preemption; without preemption (or
    under FIFO) the head simply waits.  (The spill against the reference:
    ``test_torch_preempt.py``.)"""
    def serve(**kw):
        eng = _engine(tiny, **kw)
        for i in range(2):
            eng.submit(Request(i, np.arange(4 + i, dtype=np.int32), max_new_tokens=12, priority=1))
        for _ in range(4):
            eng.step()
        eng.submit(Request(9, np.arange(5, dtype=np.int32), max_new_tokens=4, priority=0))
        return eng

    runs = {}
    for name, kw in (("preempt", {}), ("off", dict(preemption=False)),
                     ("fifo", dict(admission="fifo"))):
        eng = serve(**kw)
        done = eng.run()
        assert sorted(r.request_id for r in done) == [0, 1, 9]
        assert all(len(r.generated) == r.max_new_tokens for r in done)
        assert eng.end_pool.pages_in_use == eng.cloud_pool.pages_in_use == 0
        runs[name] = ({r.request_id: r.generated for r in done}, eng.metrics())
    tokens, m = runs["preempt"]
    assert m["preemptions"] == m["preempt_restores"] == 1 and m["preempt_spill_bytes"] > 0
    assert runs["off"][1]["preemptions"] == runs["fifo"][1]["preemptions"] == 0
    assert tokens == runs["off"][0] == runs["fifo"][0]


def test_stage_signatures_are_bounded_by_shapes(tiny):
    """Prompts of many lengths through several chunks: one signature per
    stage function (the group and chunk shapes), not one per length."""
    eng = _engine(tiny, max_batch=4, prefill_chunk=8)
    rng = np.random.default_rng(1)
    for i in range(6):
        eng.submit(Request(i, rng.integers(0, 500, size=int(rng.integers(3, 30))).astype(np.int32),
                           max_new_tokens=3))
    eng.run()
    assert eng.stage_trace_counts() == {"end_step": 1, "cloud_step": 1,
                                        "end_prefill_chunk": 1, "cloud_prefill_chunk": 1}
    assert eng.end_pool.pages_in_use == eng.cloud_pool.pages_in_use == 0
