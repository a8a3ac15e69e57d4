"""The port's HL-GGN gate (eq. 5-7) against the reference's
``core/gating.py`` and ``kernels/group_gate/ref.py``, including masks that
force ties among experts (top-k must break them at the lowest index, as
``jax.lax.top_k`` does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import gating as jg
from repro.kernels.group_gate.ref import group_gate_ref
from repro_torch.configs.base import MoEConfig
from repro_torch.core import gating as tg
from repro_torch.kernels.group_gate import group_gate

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

# f32 on both sides; the gate logits are summed in another order
TOL = dict(rtol=1e-5, atol=1e-6)


def _setup(E=8, K=4, top_k=1, d=32, T=24, seed=0):
    kw = dict(num_experts=E, top_k=top_k, d_ff_expert=16, num_groups=K)
    jcfg, cfg = JMoEConfig(**kw), MoEConfig(**kw)
    params = jg.init_group_gate(jax.random.PRNGKey(seed), d, jcfg)
    rng = np.random.default_rng(seed)
    # nonzero biases so the bias terms count
    params = dict(params, b_local=jnp.asarray(rng.standard_normal((K, E // K)), jnp.float32),
                  b_global=jnp.asarray(rng.standard_normal(K), jnp.float32))
    x = rng.standard_normal((T, d)).astype(np.float32)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return jcfg, cfg, params, tparams, x


MASKS = {
    "none": None,
    "group_dead": np.asarray([1, 1, 0, 0, 1, 0, 1, 1], bool),  # group 1 fully masked
    "single": np.asarray([0, 0, 0, 0, 0, 1, 0, 0], bool),
}


@pytest.mark.parametrize("mask", list(MASKS))
def test_group_gate_probs_match_reference(mask):
    jcfg, cfg, params, tparams, x = _setup()
    m = MASKS[mask]
    jprobs, jpg, jaux = jg.group_gate_probs(
        params, jnp.asarray(x), jcfg, None if m is None else jnp.asarray(m)
    )
    probs, pg, aux = tg.group_gate_probs(
        tparams, torch.from_numpy(x), cfg, None if m is None else torch.from_numpy(m)
    )
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jpg), **TOL)
    np.testing.assert_allclose(aux["router_z"].item(), float(jaux["router_z"]), rtol=1e-5)


@pytest.mark.parametrize("mask", list(MASKS))
def test_group_gate_matches_kernel_ref(mask):
    """The kernel's function, against the reference kernel's own oracle
    (column-grouped [d, E] weights and an additive mask)."""
    _, _, params, tparams, x = _setup(seed=1)
    m = MASKS[mask]
    K, d, Mk = params["w_local"].shape
    add = np.zeros(K * Mk, np.float32) if m is None else np.where(m, 0.0, -1e30).astype(np.float32)
    wprobs, wpg = group_gate_ref(
        jnp.asarray(x), jnp.transpose(params["w_local"], (1, 0, 2)).reshape(d, K * Mk),
        params["b_local"].reshape(-1), params["w_global"], params["b_global"],
        jnp.asarray(add), K,
    )
    probs, pg = group_gate(
        torch.from_numpy(x), tparams["w_local"], tparams["b_local"],
        tparams["w_global"], tparams["b_global"],
        None if m is None else torch.from_numpy(m),
    )
    np.testing.assert_allclose(probs.numpy(), np.asarray(wprobs), **TOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(wpg), **TOL)


def test_per_token_mask_matches_reference():
    jcfg, cfg, params, tparams, x = _setup(T=6, seed=2)
    m = np.random.default_rng(2).random((6, 8)) < 0.5
    m[:, 3] = True  # every token keeps one expert
    jprobs, _, _ = jg.group_gate_probs(params, jnp.asarray(x), jcfg, jnp.asarray(m))
    probs, _, _ = tg.group_gate_probs(tparams, torch.from_numpy(x), cfg, torch.from_numpy(m))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_topk_ties_break_at_lowest_index(top_k):
    """With one allowed expert every masked expert ties at probability 0;
    the order among them must be the reference's (lowest index first)."""
    probs = np.zeros((4, 8), np.float32)
    probs[:, 5] = 1.0
    probs[1, 2] = 0.5  # an untied second choice on one row
    probs[2] = 0.125  # a fully tied row
    jidx = np.asarray(jax.lax.top_k(jnp.asarray(probs), top_k)[1])
    idx, w = tg.select_topk(torch.from_numpy(probs), top_k)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    jidx2, jw = jg.select_topk(jnp.asarray(probs), top_k)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


@pytest.mark.parametrize("mask", list(MASKS))
def test_gate_matches_reference(mask):
    """Selection, weights and the auxiliary losses of the full gate, with
    top-2 over masks that force ties."""
    jcfg, cfg, params, tparams, x = _setup(top_k=2, seed=3)
    m = MASKS[mask]
    jout = jg.gate(params, jnp.asarray(x), jcfg, None if m is None else jnp.asarray(m))
    out = tg.gate(tparams, torch.from_numpy(x), cfg, None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(out.topk_idx.numpy(), np.asarray(jout.topk_idx))
    np.testing.assert_allclose(out.topk_weight.numpy(), np.asarray(jout.topk_weight), **TOL)
    for k in ("lb_expert", "lb_group", "aux_loss", "router_z"):
        np.testing.assert_allclose(out.aux[k].item(), float(jout.aux[k]), rtol=1e-5)
    for k in ("expert_frac", "group_frac"):
        np.testing.assert_allclose(out.aux[k].numpy(), np.asarray(jout.aux[k]), rtol=1e-6)
    # without the losses the gate returns the routed ids, from which a
    # consumer counts the same routing statistics (summed over layers)
    saux = tg.gate(tparams, torch.from_numpy(x), cfg,
                   None if m is None else torch.from_numpy(m), aux=False).aux
    assert set(saux) == {"topk_idx"}
    np.testing.assert_array_equal(saux["topk_idx"].numpy(), np.asarray(jout.topk_idx))
    stats = tg.routing_stats(saux["topk_idx"], cfg.num_experts, cfg.num_groups)
    for k in ("expert_frac", "group_frac"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jout.aux[k]), rtol=1e-6)
    want = np.concatenate([np.asarray(jout.aux["expert_frac"]),
                           np.asarray(jout.aux["group_frac"])])
    for n_layers in (1, 3):
        got = tg.summed_routing_stats([saux["topk_idx"]] * n_layers, cfg.num_experts,
                                      cfg.num_groups, torch.device("cpu"))
        np.testing.assert_allclose(got.numpy(), n_layers * want, rtol=1e-6)
    none = tg.summed_routing_stats([], cfg.num_experts, cfg.num_groups, torch.device("cpu"))
    assert none.shape == want.shape and not none.any()


def test_group_top_k_is_not_ported():
    _, cfg, _, tparams, x = _setup()
    import dataclasses

    with pytest.raises(NotImplementedError, match="group_top_k"):
        tg.group_gate_probs(tparams, torch.from_numpy(x), dataclasses.replace(cfg, group_top_k=2))
