"""The port's preemption (spill and restore of a running slot's KV pages)
against the reference engine's, on the CPU in f32 with ``timing="modeled"``.

Two low-priority requests decode in both slots; an interactive one arrives
and spills the youngest, whose pages are restored when a slot frees.  Held
equal to the reference: the victim, ``n_preemptions``,
``n_preempt_restores``, ``preempt_spill_bytes``, every metric but the
wall-clock one, and the tokens, which also equal an uninterrupted run's.
At splits 0, 1 and 2; over int8 pools (the spilled codes and f16 scales bit
for bit the reference's); across a replan to another split between the
spill and the restore; and with speculative decode on (the restored slot
rebuilds its draft cache).
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
from repro.serving.stream import EndCloudServingEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import hardware as thw
from repro_torch.models.model import Model
from repro_torch.serving import EndCloudServingEngine, Request

torch.set_num_threads(1)

WALL_CLOCK = {"link_blackout_s"}


def _pair(layers):
    jcfg = jsmoke(jget("tinyllama-1.1b")).replace(num_layers=layers, dtype="float32",
                                                   param_dtype="float32")
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = smoke_config(get_config("tinyllama-1.1b")).replace(num_layers=layers, dtype="float32",
                                                             param_dtype="float32")
    return (jm, jp), (Model(cfg, device="cpu"), params_from_numpy(jax.tree.map(np.asarray, jp),
                                                                  "cpu"))


@pytest.fixture(scope="module")
def pair2():
    return _pair(2)


@pytest.fixture(scope="module")
def pair4():
    return _pair(4)


def _scenario_prompts():
    rng = np.random.default_rng(42)
    return [rng.integers(0, 500, size=n).astype(np.int32) for n in (12, 14, 9)]


def _profiles(hw, end_sim):
    if not end_sim:
        return hw.PROFILES["a100"], hw.PROFILES["a100"]
    # a 1 Mbps end at whose rate the planner keeps every block on the
    # cloud, and moves two to the end once 100 Mbps is declared
    return (hw.DeviceProfile("end-sim", peak_gflops=5.0, mem_gb=8.0, mem_bw_gbs=50.0,
                             net_gbps=0.001),
            hw.DeviceProfile("cloud-sim", peak_gflops=6.0, mem_gb=80.0, mem_bw_gbs=500.0,
                             net_gbps=2.0))


def run_scenario(side, pair, *, new_b=4, end_sim=False, actions=None, check_spill=None, **kw):
    """A1 and A2 (priority 2) into mid-decode, then B (priority 0); returns
    (tokens of A1, A2, B; engine).  ``actions[tick](engine)`` runs before
    that tick after B's arrival; ``check_spill(engine)`` right after the
    preempting tick."""
    (jm, jp), (tm, tp) = pair
    jx = side == "jax"
    hw, R = (jhw, JRequest) if jx else (thw, Request)
    end, cloud = _profiles(hw, end_sim)
    eng = (JEngine if jx else EndCloudServingEngine)(
        jm if jx else tm, jp if jx else tp, end_profile=end, cloud_profile=cloud,
        max_batch=2, max_len=64, timing="modeled", admission="priority", **kw)
    pa1, pa2, pb = _scenario_prompts()
    a1 = R(0, pa1, max_new_tokens=12, priority=2)
    a2 = R(1, pa2, max_new_tokens=12, priority=2)
    b = R(2, pb, max_new_tokens=new_b, priority=0)
    eng.submit(a1)
    eng.submit(a2)
    for _ in range(200):
        eng.step()
        if len(a1.generated) >= 3 and len(a2.generated) >= 3:
            break
    assert not a1.done and not a2.done, "the victims must still be running"
    if eng.preemption:
        assert eng.preemptible_slots(0) == 2 and eng.preemptible_slots(2) == 0
    eng.submit(b)
    eng.step()
    if eng.preemption:
        # the youngest of the lowest class is the victim
        assert eng.n_preemptions == 1 and (a1.n_preemptions, a2.n_preemptions) == (0, 1)
        if check_spill is not None:
            check_spill(eng)
    tick = 0
    while eng.busy():
        if actions and tick in actions:
            actions[tick](eng)
        eng.step()
        tick += 1
        assert tick < 500
    assert len(eng.finished) == 3
    return [list(r.generated) for r in (a1, a2, b)], eng


def assert_engines_equal(jtok, jeng, ttok, teng):
    assert ttok == jtok
    assert teng.replan_events == jeng.replan_events
    jm_, tm_ = jeng.metrics(), teng.metrics()
    assert set(tm_) == set(jm_)
    assert {k: tm_[k] for k in tm_ if k not in WALL_CLOCK} == {
        k: jm_[k] for k in jm_ if k not in WALL_CLOCK}
    assert teng.stage_trace_counts() == jeng.stage_trace_counts()
    assert tm_["kv_pages_in_use"] == 0
    assert teng.end_pool.pages_reserved == teng.cloud_pool.pages_reserved == 0


def check(pair, **kw):
    """Port against reference, and the port's tokens against its own
    uninterrupted run (``preemption=False``); returns the port's metrics."""
    jtok, jeng = run_scenario("jax", pair, **kw)
    ttok, teng = run_scenario("torch", pair, **kw)
    assert_engines_equal(jtok, jeng, ttok, teng)
    plain, peng = run_scenario("torch", pair, preemption=False, **kw)
    assert peng.n_preemptions == 0 and ttok == plain
    m = teng.metrics()
    assert m["preemptions"] == m["preempt_restores"] == 1 and m["preempt_spill_bytes"] > 0
    return m


@pytest.mark.parametrize("split", [0, 1, 2])
def test_preemption_matches_reference_at_splits(pair2, split):
    check(pair2, force_split=split)


def test_int8_spill_and_restore_bit_identical(pair4):
    """Over int8 KV pools with an int8 boundary: the spilled pytree holds
    the int8 codes and their f16 scales, each leaf bit for bit the
    reference's spill, and the restored stream equals the reference's."""
    spills = {}

    def grab(side):
        def f(eng):
            (st,) = eng._spilled.values()
            spills[side] = (st.entries, st.blocks, st.nbytes)
        return f

    kw = dict(force_split=2, new_b=12, quantize_kv=True, quantize_boundary=True)
    jtok, jeng = run_scenario("jax", pair4, check_spill=grab("jax"), **kw)
    ttok, teng = run_scenario("torch", pair4, check_spill=grab("torch"), **kw)
    assert_engines_equal(jtok, jeng, ttok, teng)
    (je, jb, jn), (te, tb, tn) = spills["jax"], spills["torch"]
    assert np.array_equal(je, te) and jn == tn
    dtypes = set()
    for pos, entry in jb.items():
        assert set(tb[pos]) == set(entry) == {"k", "v", "k_scale", "v_scale"}
        for n, leaf in entry.items():
            assert tb[pos][n].device.type == "cpu"
            assert np.array_equal(tb[pos][n].numpy(), np.asarray(leaf))
            dtypes.add(tb[pos][n].dtype)
    assert dtypes == {torch.int8, torch.float16}


def test_spill_replan_then_restore(pair4):
    """The victim spills at split 0; a declared 100 Mbps moves the split to
    2 before its restore, which re-splits the saved rows at the new split."""
    act = {1: lambda e: e.observe_bandwidth(0.1, hard=True)}
    m = check(pair4, end_sim=True, actions=act, new_b=12)
    assert m["split"] == 2 and m["replan_events"] == 1


def test_preemption_with_speculative_decode(pair4):
    """Speculation on: the spill drops the slot's draft cache, the restore
    rebuilds it; tokens stay the reference's and the uninterrupted run's."""
    m = check(pair4, force_split=2, new_b=8, spec_k=4, link_rtt_s=0.05)
    assert m["spec_rounds"] > 0 and m["spec_rollbacks"] == 0
