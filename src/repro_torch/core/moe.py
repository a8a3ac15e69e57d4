"""Group-gated Mixture-of-Experts layer, single shard (port of the
reference's ``core/moe.py``: the ``sorted``, ``naive`` and pooled
``resident`` paths of ``apply_moe``).

``sorted`` sorts the token-to-expert assignments by expert, runs the expert
FFN as one grouped product over the sorted rows (``kernels.expert_mlp``,
the CUDA kernel on the card), and scatters the rows back; ``naive`` runs
every expert on every token and is the oracle; ``resident`` is the end
tier's pooled path, the same product over rows sorted by resident slot,
each slot reading its slab of the expert pool's store.  All three share
the HL-GGN gate.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import compression as comp
from repro_torch.core import gating
from repro_torch.kernels.expert_mlp import (
    grouped_mlp,
    grouped_mlp_resident,
    grouped_mlp_resident_quant,
)
from repro_torch.models.layers import ACTIVATIONS, apply_mlp, init_mlp, truncated_normal_init


def init_moe(generator: torch.Generator, cfg, lead: Tuple[int, ...] = ()) -> Dict:
    m = cfg.moe
    dtype = cfg.torch_param_dtype
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    p = {
        "gate": gating.init_group_gate(generator, d, m, lead),
        "wi": truncated_normal_init(generator, (E, d, f), dtype, 1.0, lead),
        "wo": truncated_normal_init(generator, (E, f, d), dtype, 1.0, lead),
    }
    if cfg.ffn_gated:
        p["wg"] = truncated_normal_init(generator, (E, d, f), dtype, 1.0, lead)
    if m.shared_experts:
        p["shared"] = init_mlp(generator, d, m.shared_experts * f, dtype,
                               gated=cfg.ffn_gated, lead=lead)
    if _dispatch_compressed(cfg):
        p["codec"] = comp.init_lowrank_1d(generator, d, cfg.compression.rank,
                                          device=generator.device, lead=lead)
    return p


def _dispatch_compressed(cfg) -> bool:
    c = cfg.compression
    return c is not None and c.rank > 0 and "dispatch" in c.boundaries


def _codec_aux(aux: Dict, recon: torch.Tensor, cfg) -> None:
    """``aux["recon_loss"]``: the two hops' reconstruction losses summed;
    ``recon_weight`` times it joins ``aux["aux_loss"]`` (the reference's
    joint eq. 8 term)."""
    aux["recon_loss"] = recon
    aux["aux_loss"] = aux["aux_loss"] + cfg.compression.recon_weight * recon


def _grouped_mlp(xs: torch.Tensor, group_sizes: torch.Tensor, wi: torch.Tensor,
                 wg: Optional[torch.Tensor], wo: torch.Tensor, act: str) -> torch.Tensor:
    """Expert FFN over rows sorted by expert (the reference's
    ``ragged_dot`` trio), weights cast to the rows' type."""
    dt = xs.dtype
    return grouped_mlp(
        xs, group_sizes, wi.to(dt), None if wg is None else wg.to(dt), wo.to(dt), act
    )


def _sorted_expert_ffn(x_rows: torch.Tensor, eid: torch.Tensor, num_experts: int,
                       params: Dict, act: str) -> torch.Tensor:
    """Sort rows by expert, grouped FFN, unsort.  Returns [n, d].  Group
    sizes are counted on the device, so no host sync is needed."""
    order = torch.argsort(eid, stable=True)
    y_sorted = _grouped_mlp(
        x_rows[order], _group_sizes(eid, num_experts), params["wi"], params.get("wg"),
        params["wo"], act,
    )
    return torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)


def moe_naive(params: Dict, x: torch.Tensor, cfg, expert_mask=None, *, aux: bool = True):
    """Oracle: every expert evaluates every token; combine by gate weight."""
    m = cfg.moe
    T = x.shape[0]
    out = gating.gate(params["gate"], x, m, expert_mask, aux=aux)
    cw = torch.zeros((T, m.num_experts), dtype=torch.float32, device=x.device)
    cw.scatter_(1, out.topk_idx, out.topk_weight.float())
    a = ACTIVATIONS[cfg.act]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(m.num_experts):
        h = x @ params["wi"][e].to(x.dtype)
        if "wg" in params:
            h = a(h) * (x @ params["wg"][e].to(x.dtype))
        else:
            h = a(h)
        y = y + cw[:, e : e + 1] * (h @ params["wo"][e].to(x.dtype)).float()
    return y.to(x.dtype), out.aux


def moe_sorted(params: Dict, x: torch.Tensor, cfg, expert_mask=None, *, aux: bool = True):
    """Single-shard dropless path: gate, sort by expert, grouped FFN, and
    combine by gate weight.

    With a dispatch codec (``params["codec"]``) the dispatched rows and the
    expert outputs each go through the encode -> (wire) -> decode roundtrip
    the expert-parallel path would apply, so the compression's quality
    effect shows on one device; with ``aux`` the eq. 8 reconstruction term
    lands in ``aux["recon_loss"]`` and, weighted, in ``aux["aux_loss"]``.
    Serving (``aux=False``) runs the same two roundtrips and leaves their
    losses unread."""
    m = cfg.moe
    k = m.top_k
    out = gating.gate(params["gate"], x, m, expert_mask, aux=aux)
    rows = x if k == 1 else x.repeat_interleave(k, dim=0)
    codec = params.get("codec")
    if codec is not None:  # encode, the wire, decode: one launch each way
        rows, sent_loss = comp.roundtrip_loss_1d(codec, rows)
    y_rows = _sorted_expert_ffn(rows, out.topk_idx.reshape(-1), m.num_experts, params, cfg.act)
    if codec is not None:
        y_rows, back_loss = comp.roundtrip_loss_1d(codec, y_rows)
        if aux:
            _codec_aux(out.aux, sent_loss + back_loss, cfg)
    w = out.topk_weight.reshape(-1, 1).to(y_rows.dtype)
    return _combine(y_rows, w, k).to(x.dtype), out.aux


def _combine(y_rows: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Sum each token's ``k`` weighted assignment rows ([T*k, d] -> [T, d])."""
    if k == 1:
        return y_rows * w
    tok = torch.arange(y_rows.shape[0], device=y_rows.device) // k
    return torch.zeros((y_rows.shape[0] // k, y_rows.shape[1]), dtype=y_rows.dtype,
                       device=y_rows.device).index_add_(0, tok, y_rows * w)


def _group_sizes(ids: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Rows per group, counted on the device (no host sync)."""
    return torch.zeros(n_groups, dtype=torch.int32, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids, dtype=torch.int32)
    )


def moe_resident(params: Dict, x: torch.Tensor, cfg, expert_mask=None, *, aux: bool = False):
    """Pooled end-tier path: sorted dispatch over the *resident* sub-table.

    ``params["resident"]`` is the expert pool's device view
    (``core.expertpool``): ``store`` (slab storage ``[N + 1, ...]`` per
    weight matrix, last row the zero garbage slab), ``ids [S + 1]`` (the
    layer's resident slot -> slab row) and ``slot [E]`` (expert id ->
    resident slot, non-residents on the garbage slot ``S``).  The effective
    routing mask is ``expert_mask AND slot < S``, so non-resident experts
    are routed away as eq. 4-masked experts are on the dense path, and only
    resident slabs are read (``kernels.expert_mlp.grouped_mlp_resident``;
    ``grouped_mlp_resident_quant`` for an int8 store with ``*_scale``
    leaves).
    For a resident superset of the routed experts this equals
    ``moe_sorted`` under the same mask.  A dispatch codec runs as in
    :func:`moe_sorted`, on every dispatched row (those routed to the
    garbage slot too, as the reference does) and on the expert outputs
    after the unsort.  The end tier serves with ``aux=False`` (the
    default): the router losses are skipped; ``aux=True`` computes them
    and the codec's terms as ``moe_sorted`` does."""
    m = cfg.moe
    k = m.top_k
    res = params["resident"]
    ids, slot_of = res["ids"], res["slot"]
    S = ids.shape[0] - 1
    resident_ok = slot_of < S
    eff_mask = resident_ok if expert_mask is None else expert_mask & resident_ok
    out = gating.gate(params["gate"], x, m, eff_mask, aux=aux)
    slots = slot_of.long()[out.topk_idx.reshape(-1)]  # [T*k], S for non-residents
    rows = x if k == 1 else x.repeat_interleave(k, dim=0)
    codec = params.get("codec")
    if codec is not None:
        rows, sent_loss = comp.roundtrip_loss_1d(codec, rows)
    order = torch.argsort(slots, stable=True)
    store = res["store"]
    args = (rows[order], _group_sizes(slots, S + 1), store["wi"], store.get("wg"),
            store["wo"], ids, cfg.act)
    if "wi_scale" in store:  # int8 slabs, dequantized as they are read
        y_sorted = grouped_mlp_resident_quant(
            *args, wi_scale=store["wi_scale"], wg_scale=store.get("wg_scale"),
            wo_scale=store["wo_scale"])
    else:
        y_sorted = grouped_mlp_resident(*args)
    y_rows = torch.empty_like(y_sorted).index_copy_(0, order, y_sorted)
    if codec is not None:
        y_rows, back_loss = comp.roundtrip_loss_1d(codec, y_rows)
        if aux:
            _codec_aux(out.aux, sent_loss + back_loss, cfg)
    w = out.topk_weight.reshape(-1, 1).to(y_rows.dtype)
    # rows on the garbage slot come back 0; their combine weight is zeroed
    # too, so a renormalized tie can never leak garbage-slot output
    w = torch.where((slots < S)[:, None], w, 0.0)
    return _combine(y_rows, w, k).to(x.dtype), out.aux


def apply_moe(params: Dict, x: torch.Tensor, cfg, *, expert_mask=None,
              train: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoE FFN over ``x [B, S, d]`` (or ``[T, d]``), single shard.  With
    ``params["resident"]`` (the pooled end tier) the dispatch runs over the
    resident slabs (:func:`moe_resident`).

    ``train=False`` (serving) skips the router losses and routing
    statistics and returns the gate's ``topk_idx`` in their place: the
    reference computes them and lets XLA drop them when the serving step
    discards them, but eager PyTorch would run every one of those ops."""
    impl = "sorted" if cfg.moe_impl == "auto" else cfg.moe_impl
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if "resident" in params:
        y, aux = moe_resident(params, x2, cfg, expert_mask, aux=train)
    elif impl == "sorted":
        y, aux = moe_sorted(params, x2, cfg, expert_mask, aux=train)
    elif impl == "naive":
        y, aux = moe_naive(params, x2, cfg, expert_mask, aux=train)
    else:
        raise NotImplementedError(
            f"moe impl {impl!r} needs a device mesh, which comes with ROADMAP item 8 "
            "(the port runs 'sorted' and 'naive' on one device)")
    if cfg.moe.shared_experts and "shared" in params:
        y = y + apply_mlp(params["shared"], x2, cfg.act)
    return y.reshape(shape), aux
