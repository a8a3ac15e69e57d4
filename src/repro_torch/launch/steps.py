"""The train step (port of the reference's ``launch/steps.py``:
``make_loss_fn`` and ``make_train_step``), on one device or on a mesh.

On a mesh the ranks run SPMD, each holding its blocks of the params and the
optimizer state by ``distributed.sharding``'s specs (ZeRO-3 over the data
axes, experts over the model axis).  A step casts the blocks for compute,
gathers them (non-expert leaves whole, this rank's experts, this rank's
vocabulary slice of the head), runs forward and backward on this rank's
rows of each microbatch, reduce-scatters the gradients into the blocks
(once, after the microbatches: the reference's ``pin_like_params``
reduces each microbatch's into the shard, and the sum is the same), then
clips and steps on the blocks.

The reference's prefill and decode step builders and its ``jit_*``
builders are not ported: the engines own those paths, and PyTorch runs
eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding
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
        loss, metrics = sharded_cross_entropy(logits, batch["labels"], model.topo)
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


def _microbatch_grads(loss_fn: Callable, params: Dict, batch: Dict, accum: int,
                      rows: Callable = lambda b: b):
    """(metrics, grad leaves) of ``loss_fn`` over ``accum`` microbatches,
    rows ``[i·B/accum, (i+1)·B/accum)`` each (``rows`` picks what of a
    microbatch this caller runs): the grads averaged in f32 and the
    metrics averaged, each keeping its shape; one microbatch's as they
    come."""
    if accum == 1:
        _, metrics, g = loss_and_grads(loss_fn, params, rows(batch))
        return metrics, opt_mod.tree_leaves(g)
    mb = next(iter(batch.values())).shape[0] // accum
    acc, stack = None, []
    for i in range(accum):
        micro = rows({k: v[i * mb : (i + 1) * mb] for k, v in batch.items()})
        _, metrics, g = loss_and_grads(loss_fn, params, micro)
        g = opt_mod.tree_leaves(g)
        acc = ([x.float() / accum for x in g] if acc is None
               else [a + x.float() / accum for a, x in zip(acc, g)])
        stack.append(metrics)
    return {k: torch.stack([m[k] for m in stack]).mean(dim=0) for k in stack[0]}, acc


def rank_rows(batch: Dict, topo) -> Dict:
    """This rank's rows of a (micro)batch that every rank holds whole, by
    ``sharding.batch_specs``: its block along the data axes.  Training on
    a mesh needs the rows split (a batch the data axes do not divide would
    have every data rank compute the whole of it and count it dp times)."""
    B = next(iter(batch.values())).shape[0]
    if sharding.fit_batch_axes(B, topo) != tuple(topo.data_axes):
        raise ValueError(f"a (micro)batch of {B} rows does not split over the data axes "
                         f"{tuple(topo.data_axes)} of mesh {topo.mesh_shape}")
    specs = sharding.batch_specs(batch, topo)
    return {k: sharding.local_block(v, specs[k], topo) for k, v in batch.items()}


def make_train_step(model: Model, opt_cfg: Optional[opt_mod.OptimizerConfig] = None,
                    specs: Optional[Dict] = None):
    """train_step(params, opt_state, batch, *, accept=None) -> (params,
    opt_state, metrics): grads of :func:`make_loss_fn`'s loss (averaged
    over ``cfg.grad_accum`` microbatches, split along the batch, with the
    metrics averaged over them as well), clipped to ``grad_clip``, then
    the optimizer's step, which updates ``params`` and ``opt_state`` in
    place.  The metrics gain ``grad_norm`` (before the clip) and ``lr``.
    ``accept(metrics)``, when given, is asked before the update; a False
    leaves params and state as they were (the trainer's guard: the
    reference drops the bad step's new state).

    On a mesh (``model.topo``) ``params`` and ``opt_state`` are this rank's
    blocks by ``specs`` (the params' specs, ``sharding.train_specs``), and
    ``batch`` is the whole global batch, the same on every rank:
    microbatch i is rows ``[i·B/accum, (i+1)·B/accum)`` (the reference's
    reshape), of which this rank runs its data block (:func:`rank_rows`);
    the metrics and the grad norm are the global values on every rank.
    The step's ``grads(params, batch)`` gives (metrics, this rank's blocks
    of the gradient) without stepping."""
    cfg = model.cfg
    opt_cfg = opt_cfg or opt_mod.OptimizerConfig(name=cfg.optimizer)
    loss_fn = make_loss_fn(model)
    accum = max(1, cfg.grad_accum)
    if model.topo.mesh_shape is not None:
        if specs is None:
            raise ValueError("make_train_step on a mesh needs the params' specs "
                             "(sharding.train_specs)")
        return _mesh_train_step(model, opt_cfg, specs, loss_fn, accum)

    def train_step(params, opt_state, batch, *, accept=None):
        metrics, grads = _microbatch_grads(loss_fn, params, batch, accum)
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


def _mesh_train_step(model: Model, opt_cfg, specs: Dict, loss_fn: Callable, accum: int):
    """:func:`make_train_step`'s step on a mesh."""
    cfg, topo = model.cfg, model.topo
    cspecs = sharding.compute_specs(specs, topo)
    shards = None

    def grads_of(params, batch):
        """(metrics, this rank's blocks of the gradient tree): cast for
        compute (bf16 on the wire, the gate and codec f32) and gather every
        leaf into its compute layout, then each microbatch's rows forward
        and backward, then the sum over the data axes into the blocks."""
        spec_leaves = sharding.spec_leaves(specs, params)  # in the params' order
        cspec_leaves = sharding.spec_leaves(cspecs, params)
        with torch.no_grad():
            cast = opt_mod.tree_leaves(cast_for_compute(params, cfg.torch_dtype))
            full = _rebuild(params, [sharding.gather_block(t, s, topo, keep=c)
                                     for t, s, c in zip(cast, spec_leaves, cspec_leaves)])
        metrics, acc = _microbatch_grads(loss_fn, full, batch, accum,
                                         lambda b: rank_rows(b, topo))
        del full
        with torch.no_grad():
            grads = [sharding.reduce_grad(g, s, c, topo)
                     for g, s, c in zip(acc, spec_leaves, cspec_leaves)]
        return metrics, _rebuild(params, grads)

    def train_step(params, opt_state, batch, *, accept=None):
        nonlocal shards
        if shards is None:
            shards = sharding.leaf_shards(params, specs, topo)
        metrics, grads = grads_of(params, batch)
        grads = opt_mod.tree_leaves(grads)
        grads, gnorm = opt_mod.clip_by_global_norm(grads, opt_cfg.grad_clip, shards,
                                                   topo.world_group)
        metrics["grad_norm"] = gnorm
        if accept is not None and not accept(metrics):
            metrics["lr"] = opt_mod.lr_schedule(opt_cfg, int(opt_state["step"]) + 1)
            return params, opt_state, metrics
        params, opt_state, lr = opt_mod.apply_optimizer(
            cfg.optimizer, opt_cfg, _rebuild(params, grads), opt_state, params, shards)
        metrics["lr"] = lr
        return params, opt_state, metrics

    train_step.grads = grads_of
    return train_step
