"""The port's full-sequence flash attention against the reference's: the
consumer ``models/attention.py::flash_attention`` (the jnp scan the
one-shot pipeline runs), the O(S²) oracle ``reference_attention``, and the
Pallas kernel ``flash_attention_fwd`` in interpret mode where the shapes
divide its blocks.  Causal and not, GQA (G > 1), sliding windows, ragged S,
a query offset, bf16 and f32; numpy inputs made from a seed.  On the CPU
the port runs its plain version (an online softmax over the kernel's
64-key tiles); the CUDA kernel is held against it on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances:
- f32: sums in another order and another kv blocking, rtol = atol = 2e-5.
- bf16: p is rounded to bf16 before p·V relative to each side's running
  maximum, which differs with the kv blocking, and the output is rounded
  to bf16: held at rtol 2^-6 and atol 2^-6 (outputs are means of standard
  normal values, |o| < 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jflash_pallas
from repro.models import attention as jattn
from repro_torch.models import attention as tattn

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2 ** -6, atol=2 ** -6)}


def _qkv(B, Sq, Skv, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


def _port(arrs, tdt, **kw):
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrs)
    out = tattn.flash_attention(q, k, v, **kw)
    assert out.dtype == tdt and out.shape == q.shape
    return out.float().numpy()


def _np(a):
    return np.asarray(a, np.float32)


CASES = [
    # (H, KV, S, causal, window)
    (4, 4, 64, True, None),
    (4, 2, 128, True, None),  # GQA, G = 2, two 64-key tiles
    (8, 2, 128, True, 48),  # sliding window < S
    (4, 1, 100, True, None),  # ragged S, G = 4
    (4, 2, 200, True, 64),  # ragged S with a window (the chip check's case)
    (4, 2, 96, False, None),  # not causal
    (4, 4, 77, False, 16),  # not causal, window, ragged
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H,KV,S,causal,window", CASES)
def test_against_consumer_and_oracle(H, KV, S, causal, window, dtype):
    jdt, tdt = DTYPES[dtype]
    arrs = _qkv(2, S, S, H, KV, 32)
    got = _port(arrs, tdt, causal=causal, window=window)
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in arrs)
    want = jattn.flash_attention(qj, kj, vj, causal=causal, window=window,
                                 q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(got, _np(want), **TOL[dtype])
    oracle = jattn.reference_attention(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(got, _np(oracle), **TOL[dtype])
    # the port's own oracle equals the reference's
    mine = tattn.reference_attention(*(torch.from_numpy(a).to(tdt) for a in arrs),
                                     causal=causal, window=window)
    np.testing.assert_allclose(mine.float().numpy(), _np(oracle), **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("H,KV,S,causal,window", [c for c in CASES if c[2] % 64 == 0])
def test_against_pallas_kernel(H, KV, S, causal, window, dtype):
    """Where S divides the Pallas kernel's 64-row blocks (it asserts so)."""
    jdt, tdt = DTYPES[dtype]
    arrs = _qkv(2, S, S, H, KV, 32, seed=1)
    got = _port(arrs, tdt, causal=causal, window=window)
    want = jflash_pallas(*(jnp.asarray(a).astype(jdt) for a in arrs), causal=causal,
                         window=window, block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(got, _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_query_offset(dtype):
    """Sq < Skv with the queries at the end (q_offset = Skv - Sq): every row
    sees a key, so port and consumer agree row for row."""
    jdt, tdt = DTYPES[dtype]
    arrs = _qkv(2, 40, 150, 4, 2, 32, seed=2)
    for window in (None, 50):
        got = _port(arrs, tdt, causal=True, window=window, q_offset=110)
        qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in arrs)
        want = jattn.flash_attention(qj, kj, vj, causal=True, window=window,
                                     q_chunk=40, kv_chunk=50, q_offset=110)
        np.testing.assert_allclose(got, _np(want), **TOL[dtype])
        oracle = jattn.reference_attention(qj, kj, vj, causal=True, window=window,
                                           q_offset=110)
        np.testing.assert_allclose(got, _np(oracle), **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rows_without_a_visible_key(dtype):
    """Query rows that see no key at all (a window past every key, or a
    negative offset under causality) get the mean of V over every key, as
    the reference consumer gives them (every key scored -1e30 leaves a
    uniform softmax); rows that see a key agree as everywhere else."""
    jdt, tdt = DTYPES[dtype]
    arrs = _qkv(1, 8, 16, 4, 2, 32, seed=4)
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in arrs)
    for window, q_offset, blind in ((4, 16, np.arange(8) + 16 - 4 >= 15),
                                    (None, -3, np.arange(8) - 3 < 0)):
        assert blind.any() and not blind.all()
        got = _port(arrs, tdt, causal=True, window=window, q_offset=q_offset)
        want = _np(jattn.flash_attention(qj, kj, vj, causal=True, window=window,
                                         q_offset=q_offset))
        np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("Sq,Skv,causal,window,q_offset", [
    (100, 100, True, 32, 0),  # causal, ragged, a window
    (40, 150, True, 50, 110),  # Sq < Skv at the end of the keys
    (24, 150, False, None, 0),  # cross-attention's shape: every key visible
])
def test_head_dim_120(Sq, Skv, causal, window, q_offset, dtype):
    """h2o-danube-3-4b's head dim (d_model 3840 over 32 heads), which the
    CUDA kernel computes at a width of 128 over rows of stride 120: the
    plain version against the reference's consumer and oracle (32 heads on
    8 of them, G = 4, cut to 8 on 2)."""
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS

    assert 120 in HEAD_DIMS
    jdt, tdt = DTYPES[dtype]
    arrs = _qkv(2, Sq, Skv, 8, 2, 120, seed=5)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _port(arrs, tdt, **kw)
    qj, kj, vj = (jnp.asarray(a).astype(jdt) for a in arrs)
    want = jattn.flash_attention(qj, kj, vj, q_chunk=Sq, kv_chunk=50, **kw)
    np.testing.assert_allclose(got, _np(want), **TOL[dtype])
    oracle = jattn.reference_attention(qj, kj, vj, **kw)
    np.testing.assert_allclose(got, _np(oracle), **TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_120_against_pallas_kernel(causal):
    """The reference's Pallas kernel takes the whole head axis as one block
    (interpret mode, S a multiple of its 64-row blocks): at head dim 120
    the port's plain version agrees with it too (f32)."""
    jdt, tdt = DTYPES["float32"]
    arrs = _qkv(1, 128, 128, 8, 2, 120, seed=6)
    got = _port(arrs, tdt, causal=causal)
    want = jflash_pallas(*(jnp.asarray(a).astype(jdt) for a in arrs), causal=causal,
                         block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(got, _np(want), **TOL["float32"])
