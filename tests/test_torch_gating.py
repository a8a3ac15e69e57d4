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


def _wide_form_emulated(x, w_local, b_local, w_global, b_global, mask, splits=16):
    """``csrc/group_gate.cu``'s wide form on the CPU, lane by lane: a task is
    one group's Mk columns (or the K global ones, which every group's block
    computes alike) over one of ``splits`` slices of d; lane l reads element ``s·chunk + l / W + j·(32 / W)`` of
    column ``l % W`` at flat offset ``i·W + col`` of the group's weights;
    the lanes of a column meet in the butterfly (xor W, 2W, ... 16), the
    slices are summed in order; masked experts and dead groups at -1e30."""
    T, d = x.shape
    K, _, Mk = w_local.shape
    E = K * Mk
    chunk = -(-d // splits)
    part = np.zeros((T, splits, E + K))
    wl, wg = w_local.reshape(-1), w_global.reshape(-1)
    for g in range(K + 1):
        glob = g == K
        W = K if glob else Mk
        flat, base = (wg, 0) if glob else (wl, g * d * Mk)
        for s in range(splits):
            lanes = np.zeros((T, 32))
            for lane in range(32):
                i = s * chunk + lane // W
                while i < min(d, (s + 1) * chunk):
                    lanes[:, lane] += x[:, i] * flat[base + i * W + lane % W]
                    i += 32 // W
            o = W
            while o < 32:
                lanes = lanes + lanes[:, [lane ^ o for lane in range(32)]]
                o <<= 1
            part[:, s, (E if glob else g * Mk):][:, :W] = lanes[:, :W]
    logit = part.sum(1) + np.concatenate([b_local.reshape(-1), b_global])
    allowed = np.ones(E, bool) if mask is None else mask
    alive = allowed.reshape(K, Mk).any(-1)
    local = np.where(allowed, logit[:, :E], -1e30).reshape(T, K, Mk)
    glob = np.where(alive, logit[:, E:], -1e30)
    p_group = np.exp(glob - glob.max(-1, keepdims=True))
    p_group /= p_group.sum(-1, keepdims=True)
    p_local = np.exp(local - local.max(-1, keepdims=True))
    p_local /= p_local.sum(-1, keepdims=True)
    return (p_group[:, :, None] * p_local).reshape(T, E), p_group


@pytest.mark.parametrize("K,Mk,d,masked", [
    (16, 8, 200, False),  # qwen3-moe's 128 experts in 16 groups, a short d
    (16, 8, 200, True),
    (4, 8, 97, True),  # d not a multiple of the slices or the lane steps
    (32, 8, 40, False),  # the bounds: 256 experts, 32 groups
    (2, 32, 70, True),
])
def test_wide_gate_form_decomposition(K, Mk, d, masked):
    """The wide form's lanes and tasks cover every weight once and sum to the
    plain version (the form runs only on the card; this holds its index
    arithmetic, and ``launch_plan`` picks it for these shapes)."""
    from repro_torch.kernels.group_gate import group_gate_plain
    from repro_torch.kernels.group_gate.ops import launch_plan

    assert launch_plan(3, d, K, Mk)[0] == 3
    rng = np.random.default_rng(K * Mk + d)
    E = K * Mk
    x = rng.standard_normal((3, d))
    w_local, b_local = rng.standard_normal((K, d, Mk)) / d ** 0.5, rng.standard_normal((K, Mk))
    w_global, b_global = rng.standard_normal((d, K)) / d ** 0.5, rng.standard_normal(K)
    mask = None
    if masked:  # one group dead, a third of the rest masked
        mask = (np.arange(E) % 3 != 1) & (np.arange(E) // Mk != 1)
    got = _wide_form_emulated(x, w_local, b_local, w_global, b_global, mask)
    want = group_gate_plain(*(torch.from_numpy(a) for a in (x, w_local, b_local, w_global,
                                                            b_global)),
                            None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):  # f64 here, f32 in the plain version
        np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-7)
