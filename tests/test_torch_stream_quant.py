"""The port's streaming ``EndCloudServingEngine`` with its int8 byte
streams (``quantize_kv``, ``quantize_experts``, ``quantize_boundary``)
against the reference's quantized engine on the same weights, in f32 on the
CPU with ``timing="modeled"``: greedy tokens, the link's byte meters, stage
and chunk counts, the expert pool's counters and every metric but the wall
clock's (``kv_metrics`` and ``expert_metrics`` included), at forced splits
0, mid and R, each flag alone and all three together, on smoke tinyllama
(dense FFN) and smoke llama4-scout (gated experts and a shared expert,
pooled end tier); across a replan that moves int8 pages and their scales
between the tiers; and with the flags off, pools without scale leaves.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_stream import assert_engines_equal, run_engine

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models.model import build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.models.model import Model

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

FLAGS = {
    "kv": dict(quantize_kv=True),
    "experts": dict(quantize_experts=True),
    "boundary": dict(quantize_boundary=True),
    "all": dict(quantize_kv=True, quantize_experts=True, quantize_boundary=True),
}


@pytest.fixture(scope="module")
def models():
    """name -> (reference model, params), (port model, the same params)."""
    out = {}
    for name in ("tinyllama-1.1b", "llama4-scout-17b-16e"):
        jcfg = jsmoke(jget(name)).replace(num_layers=4, dtype="float32", param_dtype="float32")
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        cfg = smoke_config(get_config(name)).replace(num_layers=4, dtype="float32",
                                                      param_dtype="float32")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        out[name] = (jm, jp), (Model(cfg, device="cpu"), tp)
    return out


def _assert_quantized(teng, flags):
    m = teng.metrics()
    assert m["kv_quantized"] == float("quantize_kv" in flags)
    assert m["boundary_quantized"] == float("quantize_boundary" in flags)
    leaves = [k for e in teng._end_pages.values() for k in e] + [
        k for e in teng._cloud_pages.values() for k in e]
    assert ("k_scale" in leaves) == ("quantize_kv" in flags)
    if teng.expert_pool is not None:
        assert m["expert_quantized"] == float("quantize_experts" in flags)
        assert (teng._slab_store["wi"].dtype == torch.int8) == ("quantize_experts" in flags)


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("split", [0, 2, 4])
@pytest.mark.parametrize("name", ["tinyllama-1.1b", "llama4-scout-17b-16e"])
def test_quantized_engine_matches_reference(models, name, split, flag):
    """Forced splits 0, mid and R (smoke models have 4 blocks), the eq. 8
    codec on at the middle split (where it applies)."""
    pair = models[name]
    kw = dict(force_split=split, rank=16 if split == 2 else 0, **FLAGS[flag])
    jtok, jeng = run_engine("jax", pair, **kw)
    ttok, teng = run_engine("torch", pair, **kw)
    assert teng.split == split
    _assert_quantized(teng, FLAGS[flag])
    assert_engines_equal(jtok, jeng, ttok, teng)


def test_quantized_replan_moves_scales_between_tiers(models):
    """A declared slower link moves a block into the end tier at a safe
    point: its int8 pages and their f16 scales move from the cloud pool to
    the end pool, and the engines stay equal to the end."""
    pair = models["llama4-scout-17b-16e"]
    act = {4: lambda e, hw: e.observe_bandwidth(0.001, hard=True)}
    kw = dict(profiles=(1.0, 0.01), rank=16, actions=act, **FLAGS["all"])
    jtok, jeng = run_engine("jax", pair, **kw)
    ttok, teng = run_engine("torch", pair, **kw)
    assert [(ev["old_split"], ev["new_split"]) for ev in teng.replan_events] == [(0, 1)]
    assert teng._end_pages["pos0"]["k_scale"].shape[0] == 1
    assert_engines_equal(jtok, jeng, ttok, teng)


def test_flags_off_leave_no_scale_leaves(models):
    """The flags default off: two runs give the same tokens, the pools hold
    no scale leaves, and the stored sizes equal the dense ones."""
    pair = models["llama4-scout-17b-16e"]
    a, ea = run_engine("torch", pair, force_split=2)
    b, _ = run_engine("torch", pair, force_split=2)
    assert a == b
    _assert_quantized(ea, {})
    m = ea.metrics()
    assert m["kv_capacity_ratio"] == 1.0 and m["expert_capacity_ratio"] == 1.0
