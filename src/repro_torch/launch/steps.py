"""The train step on one device (port of the reference's
``launch/steps.py``: ``make_loss_fn`` and ``make_train_step``).

The reference's prefill and decode step builders and its ``jit_*``
builders are not ported: the engines own those paths, and PyTorch runs
eagerly.  ``pin_like_params`` (the reference's sharding constraint on
accumulated grads) is the identity on one device and is left out.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed.loss import sharded_cross_entropy
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt_mod


def _rebuild(tree: Dict, leaves) -> Dict:
    """``tree``'s structure over the leaves in ``opt_mod.tree_leaves`` order."""
    it = iter(leaves)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else next(it) for k, v in t.items()}

    return walk(tree)


def cast_for_compute(params: Dict, dtype: torch.dtype) -> Dict:
    """Every f32 leaf of >= 2 dims cast to the compute type, except those
    whose path holds ``gate`` or ``codec`` (the router and the codec stay
    f32): the reference casts at step entry, once, and gradients flow back
    to the f32 leaves through the cast."""

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = walk(v, path)
            elif "gate" in path or "codec" in path:
                out[k] = v
            elif v.dim() >= 2 and v.dtype == torch.float32:
                out[k] = v.to(dtype)
            else:
                out[k] = v
        return out

    return walk(params, "")


def make_loss_fn(model: Model) -> Callable:
    """loss_fn(params, batch, expert_mask=None) -> (total loss, metrics):
    the cross-entropy with its z-term plus the router's ``aux_loss``;
    metrics hold ``ce_loss``, ``z_loss``, ``tokens``, every aux entry and
    ``loss`` (the total)."""
    cfg = model.cfg

    def loss_fn(params, batch, expert_mask=None):
        params = cast_for_compute(params, cfg.torch_dtype)
        logits, aux = model.train_logits(params, batch, expert_mask=expert_mask)
        loss, metrics = sharded_cross_entropy(logits, batch["labels"])
        total = loss + aux["aux_loss"] if "aux_loss" in aux else loss
        metrics = {**metrics, **aux, "loss": total}
        return total, metrics

    return loss_fn


def loss_and_grads(loss_fn: Callable, params: Dict, batch: Dict,
                   expert_mask=None) -> Tuple[torch.Tensor, Dict, Dict]:
    """(total loss, metrics, grads) of ``loss_fn`` at ``params``: the
    leaves are detached copies (sharing storage) that require a gradient,
    so the caller's params carry no autograd state; grads are a tree of
    the params' structure (zeros for a leaf the loss does not reach)."""
    leaves = [t.detach().requires_grad_(True) for t in opt_mod.tree_leaves(params)]
    with torch.enable_grad():
        total, metrics = loss_fn(_rebuild(params, leaves), batch, expert_mask)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, grads)]
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
    return total.detach(), metrics, _rebuild(params, grads)


def make_train_step(model: Model, opt_cfg: Optional[opt_mod.OptimizerConfig] = None):
    """train_step(params, opt_state, batch, *, accept=None) -> (params,
    opt_state, metrics): grads of :func:`make_loss_fn`'s loss (averaged
    over ``cfg.grad_accum`` microbatches, split along the batch, with the
    metrics averaged over them as well), clipped to ``grad_clip``, then
    the optimizer's step, which updates ``params`` and ``opt_state`` in
    place.  The metrics gain ``grad_norm`` (before the clip) and ``lr``.
    ``accept(metrics)``, when given, is asked before the update; a False
    leaves params and state as they were (the trainer's guard: the
    reference drops the bad step's new state)."""
    cfg = model.cfg
    opt_cfg = opt_cfg or opt_mod.OptimizerConfig(name=cfg.optimizer)
    loss_fn = make_loss_fn(model)
    accum = max(1, cfg.grad_accum)

    def train_step(params, opt_state, batch, *, accept=None):
        if accum > 1:
            B = next(iter(batch.values())).shape[0]
            mb = B // accum
            acc, stack = None, []
            for i in range(accum):
                micro = {k: v[i * mb : (i + 1) * mb] for k, v in batch.items()}
                _, metrics, g = loss_and_grads(loss_fn, params, micro)
                g = opt_mod.tree_leaves(g)
                acc = ([x.float() / accum for x in g] if acc is None
                       else [a + x.float() / accum for a, x in zip(acc, g)])
                stack.append(metrics)
            grads = acc
            metrics = {k: torch.stack([m[k] for m in stack]).mean(dim=0) for k in stack[0]}
        else:
            _, metrics, g = loss_and_grads(loss_fn, params, batch)
            grads = opt_mod.tree_leaves(g)
        grads, gnorm = opt_mod.clip_by_global_norm(grads, opt_cfg.grad_clip)
        metrics["grad_norm"] = gnorm
        if accept is not None and not accept(metrics):
            metrics["lr"] = opt_mod.lr_schedule(opt_cfg, int(opt_state["step"]) + 1)
            return params, opt_state, metrics
        params, opt_state, lr = opt_mod.apply_optimizer(
            cfg.optimizer, opt_cfg, _rebuild(params, grads), opt_state, params)
        metrics["lr"] = lr
        return params, opt_state, metrics

    return train_step
