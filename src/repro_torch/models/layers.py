"""Basic layers: norms, dense FFNs, embeddings, initialisers, the
activations' derivatives and the token-level cross-entropy (port of the
reference's ``models/layers.py``; dict params, plain functions)."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def truncated_normal_init(generator: torch.Generator, shape: Tuple[int, ...],
                          dtype: torch.dtype, scale: float,
                          lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """``scale / sqrt(shape[0])`` times a standard normal truncated to
    [-2, 2], the reference's initialiser.  ``lead`` prepends stacked-block
    axes, which (as under the reference's ``vmap``) do not enter the scale.
    The tensor is made on the generator's device."""
    stddev = scale / float(max(shape[0], 1)) ** 0.5
    t = torch.empty(lead + tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * stddev).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm with the zero-centred scale ``1 + weight``, in f32 inside."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + weight.float())).to(dtype)


def init_norm(d: int, dtype: torch.dtype, device, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    return torch.zeros(lead + (d,), dtype=dtype, device=device)


_GELU_C = (2.0 / math.pi) ** 0.5
# XLA's f32 tanh is exactly -1 (+1) from |u| = 7.9988117 on (its rational
# approximation clamps there), torch.tanh only from 9.0108.  The GELU's
# derivative below saturates at XLA's point, so it is exactly 0 (1 on the
# positive side) where the reference's is, and the GELU is exactly 0 on the
# negative tail, from x = GELU_ZERO_AT (where u = -7.9988117 in f32) down: a
# hidden unit in the tail then gives exact zeros to its weight gradients,
# which Adafactor's factored second moment would otherwise turn into a step
# of ~lr.  On the positive tail F.gelu is within an ulp of the reference's
# x.  (f32 literals; against a bf16 tensor GELU_ZERO_AT rounds to -4.875,
# which splits the bf16 values as the f32 threshold does.)
TANH_SATURATION = 7.9988117
GELU_ZERO_AT = -4.8676996


def _gelu_u(x: torch.Tensor) -> torch.Tensor:
    return _GELU_C * (x + 0.044715 * x ** 3)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh form, exactly 0 where XLA's tanh is saturated at -1."""
    return F.gelu(x, approximate="tanh").masked_fill_(x <= GELU_ZERO_AT, 0.0)


def _gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    u = _gelu_u(x)
    t = torch.where(u.abs() >= TANH_SATURATION, torch.sign(u), torch.tanh(u))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * _GELU_C * (1.0 + 3 * 0.044715 * x * x)


class _GeluTanhFn(torch.autograd.Function):
    """The saturated tanh-form GELU with :func:`_gelu_tanh_grad` as its
    derivative (in f32, rounded to the input's type), in place of
    autograd's, which reaches 0 only below x = -5.061."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_tanh(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * _gelu_tanh_grad(x.float())).to(g.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form; F.gelu's default is the erf form),
    saturated where the reference's f32 tanh is; under autograd through
    :class:`_GeluTanhFn`."""
    if x.requires_grad and torch.is_grad_enabled():
        return _GeluTanhFn.apply(x)
    return _gelu_tanh(x)


ACTIVATIONS = {
    "silu": F.silu,
    "gelu": gelu_tanh,
    "relu": F.relu,
}


def _silu_grad(x: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


# the derivative of each activation, for explicit backward passes
ACTIVATION_GRADS = {
    "silu": _silu_grad,
    "gelu": _gelu_tanh_grad,
    "relu": lambda x: (x > 0).to(x.dtype),
}


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype,
             gated: bool = True, lead: Tuple[int, ...] = ()) -> Dict:
    p = {
        "wi": truncated_normal_init(generator, (d_model, d_ff), dtype, 1.0, lead),
        "wo": truncated_normal_init(generator, (d_ff, d_model), dtype, 1.0, lead),
    }
    if gated:
        p["wg"] = truncated_normal_init(generator, (d_model, d_ff), dtype, 1.0, lead)
    return p


def apply_mlp(params: Dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """(Optionally gated) FFN.  x: [..., d_model]."""
    a = ACTIVATIONS[act]
    h = x @ params["wi"].to(x.dtype)
    if "wg" in params:
        h = a(h) * (x @ params["wg"].to(x.dtype))
    else:
        h = a(h)
    return h @ params["wo"].to(x.dtype)


def init_embedding(generator: torch.Generator, vocab: int, d_model: int,
                   dtype: torch.dtype) -> torch.Tensor:
    return truncated_normal_init(generator, (vocab, d_model), dtype, 1.0)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, z_weight: float = 1e-4):
    """Token-level cross-entropy with the log-sum-exp z-term, in f32.

    logits [..., V] (any float type); labels [...] integer, positions with
    a label < 0 masked out.  Returns (mean loss + z-term, {"ce_loss",
    "z_loss", "tokens"})."""
    logits = logits.float()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    denom = mask.sum().clamp_min(1.0)
    loss = ((lse - ll) * mask).sum() / denom
    z_loss = z_weight * (lse.square() * mask).sum() / denom
    return loss + z_loss, {"ce_loss": loss, "z_loss": z_loss, "tokens": denom}
