"""The port's eq. 8 low-rank codec against the reference's: the plain
versions of the kernel's three entries against ``kernels/lowrank/ref.py``
and the Pallas kernels (interpret mode), and ``core.compression``'s
consumers against the reference's, in f32 and bf16, on numpy inputs made
from a seed.  On the CPU the port's wrappers run their plain versions; the
CUDA kernel is held against them on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances:
- f32: both sides accumulate in f32 in another order, rtol = atol = 1e-5
  (the error sum, a sum of T·d squares, rtol 1e-5).
- bf16 with both operands in bf16 (the consumer's casting): the f32 sums
  of the same products are rounded once to bf16, so the outputs differ by
  at most one bf16 ulp: rtol 2^-7 plus an atol of 2^-7 times the output's
  largest value for elements near zero.
- bf16 against ``ref.encode_ref`` with the codec left in f32 (the ref's
  own casting, which the consumer does not use): the codec's bf16 rounding
  (2^-9 relative per element) moves each output by up to 2^-8 of the
  sum of |x·e| over d, held at atol 2^-6 times the output's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro.kernels.lowrank import lowrank_decode as jdecode_pallas
from repro.kernels.lowrank import lowrank_encode as jencode_pallas
from repro.kernels.lowrank import lowrank_roundtrip as jroundtrip_pallas
from repro.kernels.lowrank.ref import decode_ref, encode_ref, roundtrip_ref
from repro_torch.bridge import params_from_numpy
from repro_torch.core import compression as tcomp
from repro_torch.kernels.lowrank import (
    lowrank_decode,
    lowrank_encode,
    lowrank_roundtrip,
)

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _codec(d, r, seed=0):
    """The reference's own orthonormal codec, as numpy f32."""
    p = jcomp.init_lowrank_1d(jax.random.PRNGKey(seed), d, r)
    return np.asarray(p["enc"]), np.asarray(p["dec"])


def _x(T, d, seed=1):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())


def _t(a, dt):
    return torch.from_numpy(np.array(a, np.float32)).to(dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,d,r", [(64, 32, 8), (128, 64, 64), (32, 128, 16)])
def test_plain_against_ref_and_pallas(T, d, r, dtype):
    jdt, tdt = DTYPES[dtype]
    enc, dec = _codec(d, r)
    x = _x(T, d)
    xj, ej, dj = (jnp.asarray(a).astype(jdt) for a in (x, enc, dec))
    xt, et, dt_ = (_t(a, tdt) for a in (x, enc, dec))

    z = lowrank_encode(xt, et)
    assert z.dtype == tdt and tuple(z.shape) == (T, r)
    _close(z.float(), encode_ref(xj, ej), dtype)
    _close(z.float(), jencode_pallas(xj, ej, interpret=True), dtype)

    zj = jnp.asarray(z.float().numpy()).astype(jdt)
    xh = lowrank_decode(z, dt_)
    _close(xh.float(), decode_ref(zj, dj), dtype)
    _close(xh.float(), jdecode_pallas(zj, dj, interpret=True), dtype)

    xh_t, err_t = lowrank_roundtrip(xt, et, dt_)
    assert err_t.dtype == torch.float32 and err_t.dim() == 0
    for xh_j, err_j in (roundtrip_ref(xj, ej, dj), jroundtrip_pallas(xj, ej, dj, interpret=True)):
        _close(xh_t.float(), xh_j, dtype)
        np.testing.assert_allclose(float(err_t), float(err_j), rtol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,d,r", [
    *(pytest.param(T, 96, 24, id=str(T)) for T in (1, 4, 32, 37, 1000)),
    # full-width switch-base's boundary (rank 384) at the rows the engines
    # give it: the streaming engine's decode group step and prefill chunk,
    # and the one-shot pipeline's [4, 256] batch
    (4, 768, 384), (32, 768, 384), (1024, 768, 384),
])
def test_ragged_token_counts(T, d, r, dtype):
    """Any T: the Pallas kernels assert T % block == 0, the port does not;
    held against ``ref.py``, which takes any T."""
    jdt, tdt = DTYPES[dtype]
    enc, dec = _codec(d, r, seed=2)
    x = _x(T, d, seed=3)
    xj, ej, dj = (jnp.asarray(a).astype(jdt) for a in (x, enc, dec))
    xt, et, dt_ = (_t(a, tdt) for a in (x, enc, dec))
    z = lowrank_encode(xt, et)
    _close(z.float(), encode_ref(xj, ej), dtype)
    zj = jnp.asarray(z.float().numpy()).astype(jdt)
    _close(lowrank_decode(z, dt_).float(), decode_ref(zj, dj), dtype)
    xh_t, err_t = lowrank_roundtrip(xt, et, dt_)
    xh_j, err_j = roundtrip_ref(xj, ej, dj)
    _close(xh_t.float(), xh_j, dtype)
    np.testing.assert_allclose(float(err_t), float(err_j), rtol=1e-5)


def test_bf16_activations_against_the_f32_codec_ref():
    """``ref.encode_ref`` keeps E in f32; the consumer (and so the port)
    rounds E to bf16 first.  The two agree within the codec's rounding."""
    d, r = 128, 32
    enc, _ = _codec(d, r)
    x = _x(64, d)
    want = np.asarray(encode_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(enc)), np.float32)
    got = tcomp.encode_1d({"enc": _t(enc, torch.float32)}, _t(x, torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_compression_consumers_match_reference(dtype):
    """encode_1d / decode_1d / roundtrip_1d / recon_loss on [B, S, d] with
    the reference's codec carried across through the bridge."""
    jdt, tdt = DTYPES[dtype]
    B, S, d, r = 2, 24, 64, 16
    jp = jcomp.init_lowrank_1d(jax.random.PRNGKey(7), d, r)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(4).standard_normal((B, S, d)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jdt), _t(x, tdt)

    z_t = tcomp.encode_1d(tp, xt)
    z_j = jcomp.encode_1d(jp, xj)
    assert z_t.dtype == tdt and tuple(z_t.shape) == (B, S, r)
    _close(z_t.float(), z_j, dtype)

    zj = jnp.asarray(z_t.float().numpy()).astype(jdt)
    xh_t = tcomp.decode_1d(tp, z_t)
    _close(xh_t.float(), jcomp.decode_1d(jp, zj), dtype)

    # recon_loss of the same pair of tensors
    xh_j = jnp.asarray(xh_t.float().numpy()).astype(jdt)
    np.testing.assert_allclose(float(tcomp.recon_loss(xt, xh_t)),
                               float(jcomp.recon_loss(xj, xh_j)), rtol=1e-5)

    # the roundtrip composes the two products as the reference does (Z
    # rounded to x's type between them)
    rt_t = tcomp.roundtrip_1d(tp, xt)
    assert rt_t.dtype == tdt
    _close(rt_t.float(), jcomp.roundtrip_1d(jp, xj), dtype)


def test_roundtrip_error_sum_is_the_recon_loss():
    """The fused kernel's error sum is T·d times ``recon_loss`` of its
    f32 output (f32, any T)."""
    d, r = 64, 16
    tp = tcomp.init_lowrank_1d(torch.Generator().manual_seed(0), d, r)
    x = _t(_x(33, d, seed=5), torch.float32)
    x_hat, err = lowrank_roundtrip(x, tp["enc"], tp["dec"])
    np.testing.assert_allclose(float(err) / x.numel(), float(tcomp.recon_loss(x, x_hat)),
                               rtol=1e-5)


@pytest.mark.parametrize("d,r", [(64, 16), (32, 32)])
def test_init_lowrank_1d(d, r):
    p = tcomp.init_lowrank_1d(torch.Generator().manual_seed(3), d, r)
    enc, dec = p["enc"], p["dec"]
    assert enc.shape == (d, r) and dec.shape == (r, d) and enc.dtype == torch.float32
    assert enc.is_contiguous() and dec.is_contiguous()  # the kernels take row-major
    torch.testing.assert_close(enc.T @ enc, torch.eye(r), rtol=0, atol=1e-5)
    assert torch.equal(dec, enc.T)
    again = tcomp.init_lowrank_1d(torch.Generator().manual_seed(3), d, r)
    assert torch.equal(again["enc"], enc)
    if r == d:  # full rank: the identity is recovered
        x = _t(_x(8, d), torch.float32)
        torch.testing.assert_close(tcomp.roundtrip_1d(p, x), x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("r", [16, 64])
def test_compression_ratio(r):
    for codec in ("lowrank", "int8", "none"):
        assert tcomp.compression_ratio(64, r, codec=codec) == jcomp.compression_ratio(
            64, r, codec=codec)
    with pytest.raises(ValueError):
        tcomp.compression_ratio(64, r, codec="zip")


def _graph_names(fn, seen=None):
    """The node type names of an autograd graph from ``fn`` down."""
    seen = set() if seen is None else seen
    if fn is not None and fn not in seen:
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            _graph_names(nxt, seen)
    return {type(f).__name__ for f in seen}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_decode_gradients_equal_the_reference(dtype):
    """``encode_1d`` then ``decode_1d`` trained through ``ProjectFn`` (the
    Function that gives the card's encode and decode launches their
    backward; on the CPU its forward is the plain version): dX, dE and dD
    of a functional of Z and X̂ against ``jax.grad`` of the reference's
    ``encode_1d`` / ``decode_1d`` with the same f32 codec; and the Function
    against autograd of the plain products.  The gradient of E and D
    crosses the cast to the activation type back to f32, as the
    reference's."""
    jdt, tdt = DTYPES[dtype]
    B, S, d, r = 2, 12, 64, 16
    jp = jcomp.init_lowrank_1d(jax.random.PRNGKey(5), d, r)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    cz = rng.standard_normal((B, S, r)).astype(np.float32)
    cx = rng.standard_normal((B, S, d)).astype(np.float32)

    def jloss(p, xx):
        z = jcomp.encode_1d(p, xx)
        return ((z.astype(jnp.float32) * cz).sum()
                + (jcomp.decode_1d(p, z).astype(jnp.float32) * cx).sum())

    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x).astype(jdt))
    grads = {}
    for how in ("function", "plain"):
        tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in jax.tree.map(np.asarray, jp).items()}
        xt = _t(x, tdt).requires_grad_(True)
        if how == "function":
            z = tcomp.encode_1d(tp, xt)
            xh = tcomp.decode_1d(tp, z)
            assert "ProjectFnBackward" in _graph_names(z.grad_fn)
        else:
            z = (xt.float() @ tp["enc"].to(tdt).float()).to(tdt)
            xh = (z.float() @ tp["dec"].to(tdt).float()).to(tdt)
        ((z.float() * torch.from_numpy(cz)).sum() + (xh.float() * torch.from_numpy(cx)).sum()
         ).backward()
        grads[how] = (xt.grad, tp["enc"].grad, tp["dec"].grad)
    for name, got, want in zip(("dx", "denc", "ddec"), grads["function"],
                               (jg[1], jg[0]["enc"], jg[0]["dec"])):
        _close(got.float(), np.asarray(jnp.asarray(want).astype(jnp.float32)), dtype)
    for got, want in zip(grads["function"], grads["plain"]):
        _close(got.float(), want.float().numpy(), dtype)
