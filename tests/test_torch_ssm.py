"""The port's Mamba-2 layer (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on the same numpy inputs and bridged
weights, in f32 on the CPU: the chunked SSD against the reference's at
chunks 8, 16 and 64 and head blocks 1, 2 and 4 and against the recurrent
oracle, the initial-state continuation, two B/C groups, the causal conv
against its decode step, and the full layer's prefill and decode chain.
Tolerances are the reference's own tests' (``tests/test_ssm.py``): 1e-4
for the SSD and the conv, 3e-4 for the layer's decode chain.  In bf16 the
port rounds where the reference rounds, so the two differ by summation
order only: held at two bf16 steps (2**-7) of the output's scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models import ssm as jssm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import ssm

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

# the reference's functions jitted: one compile a shape instead of one per op
J_CHUNKED = jax.jit(jssm.ssd_chunked, static_argnames=("chunk_size", "head_block"))
J_APPLY = jax.jit(jssm.apply_ssm, static_argnames=("cfg", "return_state"))
J_DECODE = jax.jit(jssm.apply_ssm_decode, static_argnames=("cfg",))
J_CONV_STEP = jax.jit(jssm.conv1d_decode_step)


def _inputs(B, S, H, P, G, N, seed=0):
    """x, dt (post-softplus), A (negative), B, C as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hb", [1, 2, 4])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_reference(chunk, hb):
    ins = _inputs(2, 64, 4, 8, 1, 8, seed=chunk + hb)
    y, h = ssm.ssd_chunked(*_t(ins), chunk_size=chunk, head_block=hb)
    jy, jh = J_CHUNKED(*ins, chunk_size=chunk, head_block=hb)
    _close(y, jy, 1e-4)
    _close(h, jh, 1e-4)
    # and against the port's own recurrent oracle, as the reference's test
    ry, rh = ssm.ssd_reference(*_t(ins))
    _close(y, ry.numpy(), 1e-4)
    _close(h, rh.numpy(), 1e-4)


def test_ssd_reference_and_decode_step_match_reference():
    ins = _inputs(2, 12, 4, 8, 2, 8, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, 4, 8, 8)).astype(np.float32)
    y, h = ssm.ssd_reference(*_t(ins), initial_state=torch.from_numpy(h0))
    jy, jh = jax.jit(jssm.ssd_reference)(*ins, initial_state=h0)
    _close(y, jy, 1e-5)
    _close(h, jh, 1e-5)


def test_initial_state_continuation():
    """Two halves with the state carried == one full pass (the port), and
    the second half equals the reference's from the same carried state."""
    x, dt, A, Bm, Cm = _inputs(1, 64, 2, 8, 1, 8, seed=7)
    t = _t((x, dt, A, Bm, Cm))
    kw = dict(chunk_size=16, head_block=2)
    y_full, h_full = ssm.ssd_chunked(*t, **kw)
    first = [a[:, :32] if a.ndim > 1 else a for a in t]
    second = [a[:, 32:] if a.ndim > 1 else a for a in t]
    y1, h1 = ssm.ssd_chunked(*first, **kw)
    y2, h2 = ssm.ssd_chunked(*second, initial_state=h1, **kw)
    _close(torch.cat([y1, y2], 1), y_full.numpy(), 1e-4)
    _close(h2, h_full.numpy(), 1e-4)
    jy2, jh2 = J_CHUNKED(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:],
                                initial_state=h1.numpy(), **kw)
    _close(y2, jy2, 1e-4)
    _close(h2, jh2, 1e-4)


def test_multi_group_heads():
    ins = _inputs(1, 32, 4, 8, 2, 8, seed=5)
    y, h = ssm.ssd_chunked(*_t(ins), chunk_size=8, head_block=2)
    jy, jh = J_CHUNKED(*ins, chunk_size=8, head_block=2)
    _close(y, jy, 1e-4)
    _close(h, jh, 1e-4)
    ry, _ = ssm.ssd_reference(*_t(ins))
    _close(y, ry.numpy(), 1e-4)


def test_ssd_chunked_bf16_rounds_where_the_reference_does():
    """bf16 x / B / C (dt and A f32, as the layer feeds them): the port's
    roundings (u, the masked scores, the output) are the reference's, so
    only the f32 summation order differs."""
    x, dt, A, Bm, Cm = _inputs(2, 64, 4, 8, 1, 8, seed=11)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, Bm, Cm)]
    y, h = ssm.ssd_chunked(bf[0], torch.from_numpy(dt), torch.from_numpy(A), bf[1], bf[2],
                           chunk_size=16, head_block=2)
    jbf = [jnp.asarray(a, jnp.bfloat16) for a in (x, Bm, Cm)]
    jy, jh = J_CHUNKED(jbf[0], dt, A, jbf[1], jbf[2], chunk_size=16, head_block=2)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jy = np.asarray(jy.astype(jnp.float32))
    tol = 2.0 ** -7 * np.abs(jy).max()
    np.testing.assert_allclose(y.float().numpy(), jy, rtol=0, atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(jh)).max())


def test_conv_matches_reference_and_its_decode_step():
    rng = np.random.default_rng(0)
    B, S, C, W = 2, 10, 6, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    full = ssm.causal_conv1d(*_t((x, w, b)))
    _close(full, jax.jit(jssm.causal_conv1d)(x, w, b), 1e-5)
    state = torch.zeros(B, W - 1, C)
    jstate = jnp.zeros((B, W - 1, C))
    outs = []
    for t in range(S):
        o, state = ssm.conv1d_decode_step(torch.from_numpy(x[:, t]), state, *_t((w, b)))
        jo, jstate = J_CONV_STEP(x[:, t], jstate, w, b)
        _close(o, jo, 1e-5)
        outs.append(o)
    _close(torch.stack(outs, 1), full.numpy(), 1e-4)
    _close(state, jstate, 0)


@pytest.fixture(scope="module")
def layer():
    """mamba2 smoke's layer config and the reference's f32 layer params,
    as numpy and bridged."""
    cfg = smoke_config(get_config("mamba2-130m"))
    init = jax.jit(jssm.init_ssm, static_argnums=(1, 2))
    jparams = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jsmoke(jget("mamba2-130m")),
                                            jnp.float32))
    x = np.random.default_rng(1).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    return cfg, jparams, params_from_numpy(jparams, "cpu"), x


def test_full_layer_prefill_and_decode_chain_match_reference(layer):
    cfg, jp, tp, x = layer
    jcfg = jsmoke(jget("mamba2-130m"))
    y_full = ssm.apply_ssm(tp, torch.from_numpy(x), cfg)
    _close(y_full, J_APPLY(jp, x, cfg=jcfg), 1e-4)
    S_pre = 16
    y_pre, (state, conv) = ssm.apply_ssm(tp, torch.from_numpy(x[:, :S_pre]), cfg,
                                         return_state=True)
    jy_pre, (jstate, jconv) = J_APPLY(jp, x[:, :S_pre], cfg=jcfg, return_state=True)
    _close(y_pre, jy_pre, 1e-4)
    _close(state, jstate, 1e-4)
    for a, b in zip(conv, jconv):
        assert tuple(a.shape) == b.shape == (2, cfg.ssm.d_conv - 1, a.shape[-1])
        _close(a, b, 0)
    ys = [y_pre]
    for t in range(S_pre, 24):
        y_t, (state, conv) = ssm.apply_ssm_decode(tp, torch.from_numpy(x[:, t:t + 1]), cfg,
                                                  state, conv)
        jy_t, (jstate, jconv) = J_DECODE(jp, x[:, t:t + 1], jcfg, jstate, jconv)
        _close(y_t, jy_t, 3e-4)
        ys.append(y_t)
    _close(state, jstate, 3e-4)
    _close(torch.cat(ys, 1), y_full.numpy(), 3e-4)


def test_short_prompt_tail_and_initial_conv_match_reference(layer):
    """A 2-token prompt keeps a 2-row conv tail, as the reference's; a
    continuation from a carried state and 3-row conv tail equals the
    reference's."""
    cfg, jp, tp, x = layer
    jcfg = jsmoke(jget("mamba2-130m"))
    y, (_, conv) = ssm.apply_ssm(tp, torch.from_numpy(x[:, :2]), cfg, return_state=True)
    jy, (_, jconv) = J_APPLY(jp, x[:, :2], cfg=jcfg, return_state=True)
    _close(y, jy, 1e-4)
    assert [tuple(c.shape[:2]) for c in conv] == [(2, 2), (2, 2)]
    for a, b in zip(conv, jconv):
        _close(a, b, 0)
    _, (state, conv) = ssm.apply_ssm(tp, torch.from_numpy(x[:, :8]), cfg, return_state=True)
    _, (jstate, jconv) = J_APPLY(jp, x[:, :8], cfg=jcfg, return_state=True)
    y2 = ssm.apply_ssm(tp, torch.from_numpy(x[:, 8:16]), cfg, initial_state=state,
                       initial_conv=conv)
    jy2 = J_APPLY(jp, x[:, 8:16], cfg=jcfg, initial_state=jstate, initial_conv=jconv)
    _close(y2, jy2, 1e-4)


def test_chunk_rule_refuses_like_the_reference(layer):
    """Past one chunk a sequence must be a whole number of chunks: 48
    tokens at chunk 32 fail in both; 32 and 64 run."""
    cfg, jp, tp, x = layer
    long = np.concatenate([x, x], 1)  # 48 tokens
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssm.apply_ssm(tp, torch.from_numpy(long), cfg)
    with pytest.raises(AssertionError):
        J_APPLY(jp, long, cfg=jsmoke(jget("mamba2-130m")))
    for S in (32, 64):
        xs = np.resize(long, (2, S, cfg.d_model)).astype(np.float32)
        assert tuple(ssm.apply_ssm(tp, torch.from_numpy(xs), cfg).shape) == xs.shape


def test_init_matches_the_reference_layout(layer):
    cfg, jp, _, _ = layer
    own = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, torch.float32, lead=(3,))
    assert set(own) == set(jp)
    for k, v in jp.items():
        assert tuple(own[k].shape) == (3,) + v.shape, k
    for k in ("A_log", "D", "dt_bias", "norm_w", "conv_x_b", "conv_bc_b"):
        _close(own[k][1], jp[k], 1e-6)
