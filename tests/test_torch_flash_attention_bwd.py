"""The port's flash-attention backward against the reference's: the plain
backward (``flash_attention_bwd_plain``, what the CPU runs and what the
CUDA kernel is held to on the card) against ``jax.vjp`` of the reference's
``models/attention.py::flash_attention`` (its custom VJP's ``_bwd``), the
forward's log-sum-exp against the masked scores' ``logsumexp``, the
autograd Function against ``torch.autograd`` of the plain forward, and the
CUDA wrapper's terms for rows that see no key.  numpy inputs from a seed,
f32.

Tolerances, of each gradient's largest |value|: 1e-5 against the
reference (the same products and roundings, sums in another order and
another blocking: the reference scans 64-row q blocks, the plain version
takes every row of a 64-key tile at once); 1e-5 against autograd (which
differentiates the online softmax's recurrences instead).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention import ops

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

CASES = {
    # (B, Sq, Skv, H, KV, hd, causal, window, q_offset)
    "causal GQA G=2": (2, 128, 128, 4, 2, 32, True, None, 0),
    "window": (2, 128, 128, 4, 2, 32, True, 48, 0),
    "not causal Sq != Skv": (2, 64, 192, 4, 4, 32, False, None, 0),
    "q_offset > 0": (1, 64, 128, 4, 2, 32, True, None, 64),
    "rows that see no key": (1, 64, 128, 4, 2, 32, True, 32, 100),
}


def _inputs(B, Sq, Skv, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sq, H, hd)).astype(np.float32))


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), f"{what}: max |diff| {err} of {np.abs(want).max()}"


def _forward(q, k, v, kw):
    """The Function's forward on the CPU: (out with rows without a key
    filled, lse)."""
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    return ops.fill_rows_without_a_key(out, v, **kw), lse


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_equals_the_reference_vjp(case):
    B, Sq, Skv, H, KV, hd, causal, window, q_offset = CASES[case]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do = _inputs(B, Sq, Skv, H, KV, hd)

    @jax.jit
    def ref(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: jattn.flash_attention(
            a, b, c, q_chunk=64, kv_chunk=64, **kw), q, k, v)
        return (out,) + vjp(do)

    want = ref(q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = _forward(tq, tk, tv, kw)
    _close(out.numpy(), want[0], 1e-5, "out")
    got = flash_attention_bwd_plain(tdo, tq, tk, tv, out, lse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want[1:]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g.numpy(), w, 1e-5, f"{case} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_lse_is_the_masked_logsumexp(case):
    """The plain forward's log-sum-exp [B, H, Sq] is logsumexp of the
    visible scaled scores; a row that sees no key gets -1e30 (the
    reference's lse there, -1e30 + log Skv in f32)."""
    B, Sq, Skv, H, KV, hd, causal, window, q_offset = CASES[case]
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(B, Sq, Skv, H, KV, hd))
    _, lse = flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   return_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(H // KV, dim=2)) / hd ** 0.5
    vis = ops.block_mask(q_offset + torch.arange(Sq), torch.arange(Skv), causal, window)
    want = torch.logsumexp(torch.where(vis, s, -torch.inf), dim=-1)
    seen = vis.any(dim=1)
    torch.testing.assert_close(lse[:, :, seen], want[:, :, seen], rtol=1e-5, atol=1e-5)
    assert bool((lse[:, :, ~seen] == -1e30).all())


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "rows that see no key"))
def test_function_equals_autograd_of_the_plain_forward(case):
    """Where every row sees a key, the Function's gradients equal autograd
    of ``flash_attention_plain`` (the same function, differentiated through
    its online-softmax recurrences)."""
    B, Sq, Skv, H, KV, hd, causal, window, q_offset = CASES[case]
    arrs = _inputs(B, Sq, Skv, H, KV, hd, seed=1)
    do = torch.from_numpy(arrs[3])
    grads = {}
    for how in ("function", "autograd"):
        q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
        if how == "function":
            out = FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
        else:
            out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset)
        out.backward(do)
        grads[how] = (q.grad, k.grad, v.grad)
    for name, g, w in zip(("dq", "dk", "dv"), grads["function"], grads["autograd"]):
        _close(g.numpy(), w.numpy(), 1e-5, f"{case} {name}")


def test_kernel_wrapper_terms_for_rows_without_a_key():
    """The CUDA kernel gives a row that sees no key P = 0 on every key; the
    wrapper adds ``_bwd``'s terms for it (P = 1 on every key).  Emulated
    here: the plain backward with those rows' lse at +inf (P = 0), plus
    the wrapper's terms, equals the plain backward, for a window past the
    keys and a negative offset."""
    for B, Sq, Skv, H, KV, hd, causal, window, q_offset in (
            (1, 64, 128, 4, 2, 32, True, 32, 100), (2, 48, 48, 4, 1, 32, True, None, -5)):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, Sq, Skv, H, KV, hd, seed=2))
        out, lse = _forward(q, k, v, kw)
        want = flash_attention_bwd_plain(do, q, k, v, out, lse, **kw)
        masked = torch.where(lse < -1e29, torch.inf, lse)
        dq, dk, dv = flash_attention_bwd_plain(do, q, k, v, out, masked, **kw)
        ranges = ops.rows_without_a_key(Sq, Skv, causal, window, q_offset)
        rows = torch.cat([torch.arange(lo, hi) for lo, hi in ranges])
        assert rows.numel() and bool((dq[:, rows] == 0).all())
        bq, bk, bv = ops._blind_rows_grads(do, q, k, v, out, rows, 1.0 / hd ** 0.5)
        dq[:, rows] = bq
        for name, g, w in (("dq", dq, want[0]), ("dk", dk + bk, want[1]), ("dv", dv + bv, want[2])):
            _close(g.numpy(), w.numpy(), 1e-6, name)
