"""The port's layers against the reference's: RMS norm, the FFN (GELU in
its tanh form, gated SiLU), RoPE, and the attention projections.  Inputs
are made with numpy from a seed and handed to both packages in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

# f32 on both sides; XLA and PyTorch differ in summation order and in the
# last ulp of exp / tanh / pow
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    want = jlayers.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-6)
    got = tlayers.rms_norm(_t(x).to(getattr(torch, dtype)), _t(w), 1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:  # one bf16 rounding of the same f32 value, up to an ulp
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("act,gated", [("gelu", False), ("silu", True), ("relu", False)])
def test_apply_mlp(act, gated):
    rng = np.random.default_rng(1)
    p = {"wi": rng.standard_normal((32, 48)), "wo": rng.standard_normal((48, 32))}
    if gated:
        p["wg"] = rng.standard_normal((32, 48))
    p = {k: (v / 6).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((7, 32)).astype(np.float32)
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    got = tlayers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; the exact erf form
    differs from it by up to ~5e-4, far above f32 noise."""
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tlayers.ACTIVATIONS["gelu"](_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def _floats_between(a, b):
    """Every f32 from ``a`` to ``b`` (both signs of a range, in bits)."""
    lo, hi = sorted(np.array([a, b], np.float32).view(np.int32))
    return np.arange(lo, hi + 1, dtype=np.int32).view(np.float32)


def test_tanh_saturation_is_the_reference_f32_tanh():
    """XLA's f32 tanh is exactly -1 / +1 from |u| = TANH_SATURATION on and
    not one f32 step before it (probed here, the constant in the port)."""
    t = tlayers.TANH_SATURATION
    edge = np.float32(t)
    inner = np.nextafter(edge, np.float32(0))
    got = np.asarray(jax.jit(jnp.tanh)(jnp.asarray([-edge, -inner, inner, edge, -9.0, 9.0],
                                                   jnp.float32)))
    assert got[0] == -1.0 and got[1] > -1.0 and got[2] < 1.0 and got[3] == 1.0
    assert got[4] == -1.0 and got[5] == 1.0
    u = _floats_between(-7.9, -8.1)
    sat = np.asarray(jax.jit(jnp.tanh)(jnp.asarray(u))) == -1.0
    np.testing.assert_array_equal(sat, np.abs(u) >= edge)


def test_gelu_and_its_derivative_are_exact_on_the_saturated_tail():
    """The port's GELU is exactly 0 wherever ``jax.nn.gelu`` is (from
    GELU_ZERO_AT down, and nowhere else), and within an ulp of x where the
    reference's is x; its derivative (the expert FFN's backward and the
    dense FFN's autograd alike) is exactly 0 (1) wherever
    ``jax.grad(jax.nn.gelu)`` is, over every f32 through both edges of the
    saturated tail and a grid out to |x| = 100; elsewhere both agree to f32
    noise (the two tanh forms' ulps)."""
    x = np.concatenate([_floats_between(-4.85, -4.89), _floats_between(4.85, 4.89),
                        np.linspace(-100, 100, 20001).astype(np.float32)])
    fwd = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x)))
    got_fwd = tlayers.ACTIVATIONS["gelu"](_t(x)).numpy()
    np.testing.assert_array_equal(fwd == 0, (x <= np.float32(tlayers.GELU_ZERO_AT)) | (x == 0))
    np.testing.assert_array_equal(got_fwd == 0, fwd == 0)
    tail = x > 4.868  # the positive saturated tail: x in the reference
    np.testing.assert_array_equal(fwd[tail], x[tail])
    np.testing.assert_allclose(got_fwd[tail], x[tail], rtol=2 ** -23, atol=0)
    np.testing.assert_allclose(got_fwd, fwd, rtol=1e-6, atol=1e-6)
    want = np.asarray(jax.jit(jax.vmap(jax.grad(jax.nn.gelu)))(jnp.asarray(x)))
    got = tlayers.ACTIVATION_GRADS["gelu"](_t(x)).numpy()
    tx = _t(x).requires_grad_(True)
    tlayers.ACTIVATIONS["gelu"](tx).sum().backward()
    for g in (got, tx.grad.numpy()):
        np.testing.assert_array_equal(g[want == 0], 0.0)
        np.testing.assert_array_equal(g[want == 1], 1.0)
        # just inside the edge t is a few f32 steps from -1, where 1 - t^2
        # differs by an ulp of t between the two tanh forms (~3e-6 here)
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=4e-6)
    assert (want == 0).sum() > 1000 and (want == 1).sum() > 1000
    # the dense FFN's bf16 rows: the f32 derivative rounded once
    xb = _t(x).to(torch.bfloat16).requires_grad_(True)
    tlayers.ACTIVATIONS["gelu"](xb).sum().backward()
    wb = np.asarray(jax.vmap(jax.grad(jax.nn.gelu))(jnp.asarray(xb.detach().float().numpy())))
    np.testing.assert_array_equal(xb.grad.float().numpy()[wb == 0], 0.0)


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope(theta):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 4000, size=(2, 9)).astype(np.int32)
    x = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    ja = jattn.rope_angles(jnp.asarray(pos), 64, theta)
    ta = tattn.rope_angles(_t(pos), 64, theta)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    # the angles reach ~4000 rad, where one f32 ulp of the angle moves the
    # rotation by ~2e-4
    np.testing.assert_allclose(
        tattn.apply_rope(_t(x), ta).numpy(),
        np.asarray(jattn.apply_rope(jnp.asarray(x), ja)),
        rtol=1e-3, atol=1e-3,
    )
    np.testing.assert_allclose(
        tattn.apply_rope(_t(x), _t(np.asarray(ja))).numpy(),
        np.asarray(jattn.apply_rope(jnp.asarray(x), ja)),
        **TOL,
    )


@pytest.mark.parametrize("name,qk_norm", [("switch-base", False), ("tinyllama-1.1b", False),
                                          ("tinyllama-1.1b", True)])
def test_project_qkv_and_output_proj(name, qk_norm):
    jcfg = jsmoke(jget(name)).replace(dtype="float32", qk_norm=qk_norm)
    cfg = smoke_config(get_config(name)).replace(dtype="float32", qk_norm=qk_norm)
    p = jattn.init_attention(jax.random.PRNGKey(3), jcfg, jnp.float32)
    if qk_norm:  # nonzero norm scales, so the norms count
        p = dict(p, q_norm=p["q_norm"] + 0.3, k_norm=p["k_norm"] - 0.2)
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    ja = jattn.rope_angles(jnp.asarray(pos), cfg.head_dim, cfg.rope_theta)
    jq, jk, jv = jattn.project_qkv(p, jnp.asarray(x), jcfg, ja)
    tq, tk, tv = tattn.project_qkv(tp, _t(x), cfg, _t(np.asarray(ja)))
    for got, want in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tattn.output_proj(tp, tq).numpy(), np.asarray(jattn.output_proj(p, jq)),
        rtol=1e-4, atol=1e-4,
    )


@pytest.mark.parametrize("tie,softcap", [(False, 0.0), (True, 0.0), (False, 30.0)])
def test_lm_logits(tie, softcap):
    """Final norm, head (tied or not), soft cap and the padded-vocab mask."""
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr

    jcfg = jsmoke(jget("switch-base")).replace(
        dtype="float32", tie_embeddings=tie, logit_softcap=softcap, vocab_size=500)
    cfg = smoke_config(get_config("switch-base")).replace(
        dtype="float32", tie_embeddings=tie, logit_softcap=softcap, vocab_size=500)
    rng = np.random.default_rng(4)
    p = {"final_norm": rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1,
         "embed": rng.standard_normal((cfg.padded_vocab_size, cfg.d_model)).astype(np.float32)}
    if not tie:
        p["lm_head"] = rng.standard_normal((cfg.d_model, cfg.padded_vocab_size)).astype(np.float32)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    want = np.asarray(jtr.lm_logits({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                                    jnp.asarray(x)))
    got = ttr.lm_logits({k: _t(v) for k, v in p.items()}, cfg, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert (got[..., 500:] == -1e30).all()
    tokens = rng.integers(0, 500, size=(2, 3))
    np.testing.assert_array_equal(
        ttr.embed_inputs({k: _t(v) for k, v in p.items()}, cfg, _t(tokens)).numpy(),
        np.asarray(jtr.embed_inputs({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                                    jnp.asarray(tokens))),
    )
