"""Basic layers: norms, dense FFNs, embeddings, initialisers, the
activations' derivatives and the token-level cross-entropy (port of the
reference's ``models/layers.py``; dict params, plain functions)."""

from __future__ import annotations

import functools
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


# jax.nn.gelu defaults to the tanh approximation; F.gelu does not.
ACTIVATIONS = {
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}


_GELU_C = (2.0 / math.pi) ** 0.5


def _gelu_tanh_grad(x: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(_GELU_C * (x + 0.044715 * x ** 3))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * _GELU_C * (1.0 + 3 * 0.044715 * x * x)


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
