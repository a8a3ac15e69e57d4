"""Optimizers: AdamW and Adafactor (factored second moment), port of the
reference's ``training/optimizer.py``.

State keeps the reference's layout, so the numpy bridge and the
checkpointer carry it between the packages one to one: AdamW
``{"m": tree, "v": tree, "step"}``, Adafactor ``{"stats": tree of
{"vr", "vc"} or {"v"}, "step"}``, every moment f32 and ``step`` a 0-d
int32 tensor.  ``step`` stays on the host: the schedule reads it every
step, and a device copy would cost a synchronization.

The updates are computed in f32 and written back in the leaf's type.  The
reference is functional; here :func:`apply_optimizer` updates the params
and the state in place under ``torch.no_grad()``, and returns them with
the step's learning rate.  Scalars the reference computes in f32 (the
schedule, the bias corrections, Adafactor's decay) are computed in numpy
f32 on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95  # adamw; adafactor uses decay = 1 - step^-0.8
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, depth first in key order."""
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def lr_schedule(cfg: OptimizerConfig, step: int) -> np.float32:
    """Linear warmup, then cosine decay to ``min_lr_ratio``, in f32."""
    f = np.float32
    step = f(step)
    warm = step / f(max(cfg.warmup_steps, 1))
    prog = np.clip((step - f(cfg.warmup_steps)) / f(max(cfg.decay_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(cfg.min_lr_ratio) + f(1 - cfg.min_lr_ratio) * f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    return f(cfg.lr) * min(warm, cos)


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, on the leaves'
    device (no host sync)."""
    return torch.stack([g.float().square().sum() for g in leaves]).sum().sqrt()


def clip_by_global_norm(leaves: List[torch.Tensor], max_norm: float):
    """(the leaves scaled by ``min(1, max_norm / norm)``, the norm)."""
    norm = global_norm(leaves)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [g * scale.to(g.dtype) for g in leaves], norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def adamw_init(params: Dict) -> Dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": _step0()}


def adamw_update(cfg: OptimizerConfig, grads: Dict, state: Dict, params: Dict):
    """Adam with decoupled weight decay on matrices (leaves of >= 2 dims)."""
    step = int(state["step"]) + 1
    lr = lr_schedule(cfg, step)
    f = np.float32
    bc1 = float(f(1) - f(cfg.b1) ** f(step))
    bc2 = float(f(1) - f(cfg.b2) ** f(step))
    with torch.no_grad():
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g = g.float()
            m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            v.mul_(cfg.b2).add_(g.square(), alpha=1 - cfg.b2)
            delta = (m / bc1) / ((v / bc2).sqrt_() + cfg.eps)
            pf = p.float()  # p itself for an f32 leaf: read before the write below
            if p.dim() >= 2:
                delta.add_(pf, alpha=cfg.weight_decay)
            p.copy_(pf - float(lr) * delta)
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state, lr


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), simplified as in the reference: factored
# second moment for leaves of >= 2 dims at least 8 x 8, full for the rest;
# no first moment.
# ---------------------------------------------------------------------------


def _factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= 8 and p.shape[-2] >= 8


def adafactor_init(params: Dict) -> Dict:
    def stat(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
        if _factored(p):
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return {"stats": tree_map(stat, params), "step": _step0()}


def _stats_leaves(stats: Dict, params: Dict) -> List[Dict]:
    """The per-leaf stat dicts of ``stats``, in the order of the params'
    leaves (one dict level below each param leaf)."""
    out = []
    for k, v in params.items():
        out.extend(_stats_leaves(stats[k], v) if isinstance(v, dict) else [stats[k]])
    return out


def adafactor_update(cfg: OptimizerConfig, grads: Dict, state: Dict, params: Dict):
    """Adafactor with update clipping (RMS <= 1) and decoupled weight decay
    on matrices."""
    step = int(state["step"]) + 1
    lr = float(lr_schedule(cfg, step))
    f = np.float32
    decay = float(f(1) - f(step) ** f(-0.8))
    eps = 1e-30
    with torch.no_grad():
        for g, s, p in zip(tree_leaves(grads), _stats_leaves(state["stats"], params),
                           tree_leaves(params)):
            g = g.float()
            g2 = g.square() + eps
            if "vr" in s:
                s["vr"].mul_(decay).add_(g2.mean(-1), alpha=1 - decay)
                s["vc"].mul_(decay).add_(g2.mean(-2), alpha=1 - decay)
                vr, vc = s["vr"], s["vc"]
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
            else:
                s["v"].mul_(decay).add_(g2, alpha=1 - decay)
                denom = s["v"]
            delta = g * torch.rsqrt(denom + eps)
            rms = torch.sqrt(delta.square().mean() + eps)
            delta = delta / torch.clamp(rms, min=1.0)
            pf = p.float()
            if p.dim() >= 2:
                delta = delta + cfg.weight_decay * pf
            p.copy_(pf - lr * delta)
    state["step"] = torch.tensor(step, dtype=torch.int32)
    return params, state, f(lr)


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------


def init_optimizer(name: str, params: Dict) -> Dict:
    if name == "adamw":
        return adamw_init(params)
    if name == "adafactor":
        return adafactor_init(params)
    raise ValueError(name)


def apply_optimizer(name: str, cfg: OptimizerConfig, grads: Dict, state: Dict,
                    params: Dict) -> Tuple[Dict, Dict, np.float32]:
    if name == "adamw":
        return adamw_update(cfg, grads, state, params)
    if name == "adafactor":
        return adafactor_update(cfg, grads, state, params)
    raise ValueError(name)
