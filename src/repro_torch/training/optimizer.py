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

On a mesh each rank steps on its blocks of the params and state
(``distributed.sharding``'s specs), described leaf by leaf by a
:class:`Shards`: the element-wise updates are the same, and every reduction
over a leaf's dims that a mesh axis splits (the global norm, Adafactor's
row and column means, its ``vr`` normaliser and its update-clip RMS) is the
block's sum, summed over that axis's ranks, over the whole leaf's size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


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


@dataclass(frozen=True)
class Shards:
    """How one leaf's block lies on a mesh: ``full`` the whole leaf's
    shape, ``groups[i]`` the process group that splits dim i (None: the
    dim is whole here), ``owner`` whether this rank counts the block once
    in a sum over every rank (the first of the ranks that hold the same
    block)."""

    full: Tuple[int, ...]
    groups: Tuple[Any, ...]
    owner: bool


def _whole(leaf: torch.Tensor) -> Shards:
    return Shards(tuple(leaf.shape), (None,) * leaf.dim(), True)


def _mean_dims(t: torch.Tensor, dims: Sequence[int], groups: Sequence[Any],
               full: Sequence[int]) -> torch.Tensor:
    """The mean of ``t`` over ``dims`` of the whole leaf, whose extents are
    ``full``: ``t.mean`` where no group splits them, else the block's sum,
    summed over the ranks of each group that splits one, over their size."""
    dims = list(dims)
    split = list(dict.fromkeys(groups[d] for d in dims if groups[d] is not None))
    if not split:
        return t.mean() if len(dims) == t.dim() else t.mean(dim=dims)
    out = t.sum(dim=dims)
    for g in split:
        dist.all_reduce(out, group=g)
    return out / math.prod(full[d] for d in dims)


def lr_schedule(cfg: OptimizerConfig, step: int) -> np.float32:
    """Linear warmup, then cosine decay to ``min_lr_ratio``, in f32."""
    f = np.float32
    step = f(step)
    warm = step / f(max(cfg.warmup_steps, 1))
    prog = np.clip((step - f(cfg.warmup_steps)) / f(max(cfg.decay_steps - cfg.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(cfg.min_lr_ratio) + f(1 - cfg.min_lr_ratio) * f(0.5) * (f(1) + np.cos(f(np.pi) * prog))
    return f(cfg.lr) * min(warm, cos)


def global_norm(leaves: List[torch.Tensor], shards: Optional[List[Shards]] = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, on the leaves'
    device (no host sync).  On a mesh (``shards``, one a leaf, and the
    ``group`` of every rank) each element counts once: a rank adds the
    blocks it owns, then one all-reduce sums the ranks."""
    if shards is None:
        return torch.stack([g.float().square().sum() for g in leaves]).sum().sqrt()
    total = torch.stack([g.float().square().sum() * float(sh.owner)
                         for g, sh in zip(leaves, shards)]).sum()
    dist.all_reduce(total, group=group)
    return total.sqrt()


def clip_by_global_norm(leaves: List[torch.Tensor], max_norm: float,
                        shards: Optional[List[Shards]] = None, group=None):
    """(the leaves scaled by ``min(1, max_norm / norm)``, the norm)."""
    norm = global_norm(leaves, shards, group)
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


def _factored(shape: Sequence[int]) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def adafactor_init(params: Dict, shards: Optional[List[Shards]] = None) -> Dict:
    """Zero stats for ``params`` (on a mesh its blocks: the factored rule
    reads the whole leaf's shape from ``shards``)."""
    full = iter([sh.full for sh in shards] if shards is not None else [])

    def stat(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)  # noqa: E731
        if _factored(next(full) if shards is not None else p.shape):
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


def adafactor_update(cfg: OptimizerConfig, grads: Dict, state: Dict, params: Dict,
                     shards: Optional[List[Shards]] = None):
    """Adafactor with update clipping (RMS <= 1) and decoupled weight decay
    on matrices; on a mesh over this rank's blocks (``shards``)."""
    step = int(state["step"]) + 1
    lr = float(lr_schedule(cfg, step))
    f = np.float32
    decay = float(f(1) - f(step) ** f(-0.8))
    eps = 1e-30
    leaves = tree_leaves(params)
    shards = shards if shards is not None else [_whole(p) for p in leaves]
    with torch.no_grad():
        for g, s, p, sh in zip(tree_leaves(grads), _stats_leaves(state["stats"], params),
                               leaves, shards):
            g = g.float()
            g2 = g.square() + eps
            nd, gr = g.dim(), sh.groups
            if "vr" in s:
                s["vr"].mul_(decay).add_(_mean_dims(g2, [nd - 1], gr, sh.full), alpha=1 - decay)
                s["vc"].mul_(decay).add_(_mean_dims(g2, [nd - 2], gr, sh.full), alpha=1 - decay)
                vr, vc = s["vr"], s["vc"]
                vr_mean = _mean_dims(vr, [nd - 2], gr[:-1], sh.full[:-1])
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr_mean[..., None, None], min=eps))
            else:
                s["v"].mul_(decay).add_(g2, alpha=1 - decay)
                denom = s["v"]
            delta = g * torch.rsqrt(denom + eps)
            rms = torch.sqrt(_mean_dims(delta.square(), range(nd), gr, sh.full) + eps)
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


def init_optimizer(name: str, params: Dict, shards: Optional[List[Shards]] = None) -> Dict:
    """The state of ``params`` (on a mesh, of its blocks: ``shards``)."""
    if name == "adamw":
        return adamw_init(params)
    if name == "adafactor":
        return adafactor_init(params, shards)
    raise ValueError(name)


def apply_optimizer(name: str, cfg: OptimizerConfig, grads: Dict, state: Dict,
                    params: Dict, shards: Optional[List[Shards]] = None
                    ) -> Tuple[Dict, Dict, np.float32]:
    if name == "adamw":
        return adamw_update(cfg, grads, state, params)
    if name == "adafactor":
        return adafactor_update(cfg, grads, state, params, shards)
    raise ValueError(name)
