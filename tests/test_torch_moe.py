"""The port's MoE layer against the reference's ``core/moe.py``: the
grouped expert FFN over expert-sorted rows (empty groups included), the
sorted and naive paths, the shared expert, and ``apply_moe``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import moe as jmoe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import gating as tg
from repro_torch.core import moe as tmoe

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

# f32 on both sides; ragged_dot and the per-group matmuls sum in other orders
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(name, **moe_kw):
    jcfg = jsmoke(jget(name)).replace(dtype="float32")
    cfg = smoke_config(get_config(name)).replace(dtype="float32")
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _params(jcfg, seed=0):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("name,sizes", [
    ("switch-base", [3, 0, 2, 0, 1, 1, 0, 1]),  # non-gated GELU, empty groups
    ("llama4-scout-17b-16e", [0, 5, 0, 0, 2, 0, 0, 1]),  # gated SiLU
    ("switch-base", [6, 0, 0, 0, 0, 0, 0, 0]),  # every row on one expert
])
def test_grouped_mlp_matches_reference(name, sizes):
    jcfg, cfg = _cfgs(name)
    p, tp = _params(jcfg)
    n = sum(sizes) + 2  # two rows past sum(group_sizes): both come back 0
    xs = np.random.default_rng(0).standard_normal((n, cfg.d_model)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = jmoe._grouped_mlp(jnp.asarray(xs), jnp.asarray(gs), p["wi"], p.get("wg"),
                             p["wo"], jcfg.act)
    got = tmoe._grouped_mlp(torch.from_numpy(xs), torch.from_numpy(gs), tp["wi"],
                            tp.get("wg"), tp["wo"], cfg.act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy()[-2:], 0.0)


@pytest.mark.parametrize("name,top_k", [("switch-base", 1), ("llama4-scout-17b-16e", 1),
                                        ("switch-base", 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_sorted_and_naive_match_reference(name, top_k, masked):
    jcfg, cfg = _cfgs(name, top_k=top_k)
    p, tp = _params(jcfg, seed=1)
    x = np.random.default_rng(1).standard_normal((20, cfg.d_model)).astype(np.float32)
    m = np.asarray([1, 0, 0, 0, 1, 1, 0, 1], bool) if masked else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    want_s, jaux = jmoe.moe_sorted(p, jnp.asarray(x), jcfg, jm)
    got_s, aux = tmoe.moe_sorted(tp, torch.from_numpy(x), cfg, tm)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_allclose(aux["aux_loss"].item(), float(jaux["aux_loss"]), rtol=1e-5)
    want_n, _ = jmoe.moe_naive(p, jnp.asarray(x), jcfg, jm)
    got_n, _ = tmoe.moe_naive(tp, torch.from_numpy(x), cfg, tm)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), **TOL)
    np.testing.assert_allclose(got_s.numpy(), got_n.numpy(), **TOL)


@pytest.mark.parametrize("impl", ["sorted", "naive"])
def test_apply_moe_with_shared_expert(impl):
    """llama4-scout's always-on shared expert is added on both paths."""
    jcfg, cfg = _cfgs("llama4-scout-17b-16e")
    jcfg, cfg = jcfg.replace(moe_impl=impl), cfg.replace(moe_impl=impl)
    p, tp = _params(jcfg, seed=2)
    assert "shared" in tp
    x = np.random.default_rng(2).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want, jaux = jmoe.apply_moe(p, jnp.asarray(x), jcfg, None, train=False)
    got, aux = tmoe.apply_moe(tp, torch.from_numpy(x), cfg, train=False)
    # serving drops the losses and returns the routed ids, which count the
    # reference's routing statistics
    assert got.shape == x.shape and set(aux) == {"topk_idx"}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stats = tg.routing_stats(aux["topk_idx"], cfg.moe.num_experts, cfg.moe.num_groups)
    for k in stats:
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jaux[k]), rtol=1e-6)


def test_codec_and_unported_paths_raise():
    _, cfg = _cfgs("switch-base")
    _, tp = _params(_cfgs("switch-base")[0])
    x = torch.zeros(4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="codec"):
        tmoe.moe_sorted({**tp, "codec": {}}, x, cfg)
    with pytest.raises(NotImplementedError, match="a2a"):
        tmoe.apply_moe(tp, x, cfg.replace(moe_impl="a2a"))


def test_init_moe_shapes_and_scales_match_reference():
    jcfg, cfg = _cfgs("llama4-scout-17b-16e")
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, want in flat_j:
        got = tp
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == want.shape and str(got.dtype).endswith(str(want.dtype))
        if want.std() > 0:  # same truncated-normal scale, another generator
            assert abs(got.float().std().item() / want.std() - 1) < 0.1
