"""HL-GGN: Hardware-aware Lightweight Group Gate Network (paper eq. 5-7),
port of the reference's ``core/gating.py``.

The M experts are split into K groups; stage 1 is a K-way global gate
(eq. 6), stage 2 a per-group M_k-way gate (eq. 5), and the selection
probability is their product (eq. 7).  The probabilities come from
``kernels.group_gate`` (``csrc/group_gate.cu`` on the card); the ``group_top_k``
restriction, top-k selection and the auxiliary losses run in PyTorch after
it, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.group_gate import gate_logits, group_gate
from repro_torch.models.layers import truncated_normal_init


class GateOutput(NamedTuple):
    probs: torch.Tensor  # [T, E] combined probabilities (eq. 7)
    topk_idx: torch.Tensor  # [T, k] selected experts (int64)
    topk_weight: torch.Tensor  # [T, k] renormalized combine weights
    p_group: torch.Tensor  # [T, K] stage-1 probabilities
    aux: Dict[str, torch.Tensor]  # load-balance metrics / losses


def init_group_gate(generator: torch.Generator, d_model: int, moe_cfg,
                    lead: Tuple[int, ...] = ()) -> Dict:
    K, Mk = moe_cfg.num_groups, moe_cfg.experts_per_group
    dev = generator.device
    return {
        "w_local": truncated_normal_init(generator, (K, d_model, Mk), torch.float32, 1.0, lead),
        "b_local": torch.zeros(lead + (K, Mk), dtype=torch.float32, device=dev),
        "w_global": truncated_normal_init(generator, (d_model, K), torch.float32, 1.0, lead),
        "b_global": torch.zeros(lead + (K,), dtype=torch.float32, device=dev),
    }


def group_gate_probs(
    params: Dict,
    x: torch.Tensor,  # [T, d]
    moe_cfg,
    expert_mask: Optional[torch.Tensor] = None,  # bool [E] or [T, E]
    *,
    aux: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Two-stage gate (eq. 5-7) -> (probs [T, E], p_group [T, K], aux).
    ``aux=False`` skips the router z-loss, which needs the pre-mask logits
    the kernel does not return."""
    if moe_cfg.group_top_k and moe_cfg.group_top_k < moe_cfg.num_groups:
        raise NotImplementedError(
            f"group_top_k={moe_cfg.group_top_k}: the hard group restriction "
            "is not ported yet (no config of the port sets it)"
        )
    probs, p_group = group_gate(
        x, params["w_local"], params["b_local"], params["w_global"],
        params["b_global"], expert_mask,
    )
    out_aux: Dict[str, torch.Tensor] = {}
    if aux:
        # z-losses regularize the router logit scale on the pre-mask logits
        local, glob = gate_logits(
            x, params["w_local"], params["b_local"], params["w_global"], params["b_global"]
        )
        out_aux["router_z"] = (
            torch.logsumexp(glob, dim=-1).square().mean()
            + torch.logsumexp(local, dim=-1).square().mean()
        )
    return probs, p_group, out_aux


def select_topk(probs: torch.Tensor, top_k: int,
                renormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k by a stable descending sort: equal probabilities (all masked
    experts tie at 0) keep the lowest index first, as ``jax.lax.top_k``
    does; ``torch.topk`` promises no order among ties."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    if renormalize:
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    return idx, w


def routing_stats(topk_idx: torch.Tensor, num_experts: int,
                  num_groups: int) -> Dict[str, torch.Tensor]:
    """Measured routing statistics over every row the gate saw:
    ``expert_frac [E]``, the fraction of assignments routed to each expert,
    and ``group_frac [K]``, its sum per group.  Counted on the device (no
    host sync)."""
    idx = topk_idx.reshape(-1)
    counts = torch.zeros(num_experts, dtype=torch.float32, device=idx.device)
    counts.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
    f = counts / idx.numel()
    return {"expert_frac": f, "group_frac": f.reshape(num_groups, -1).sum(-1)}


def summed_routing_stats(layer_idx: List[torch.Tensor], num_experts: int,
                         num_groups: int, device: torch.device) -> torch.Tensor:
    """:func:`routing_stats` of each layer's ``topk_idx``, summed over the
    layers in order (as the reference sums its per-layer aux), packed as
    one ``[E + K]`` vector (``expert_frac`` then ``group_frac``) so a
    consumer moves it to the host in one copy.  Zeros for no layers."""
    E, K = num_experts, num_groups
    acc = None
    if layer_idx:
        idx = torch.stack([i.reshape(-1) for i in layer_idx])  # [L, n]
        L, n = idx.shape
        flat = (idx + E * torch.arange(L, device=device)[:, None]).reshape(-1)
        counts = torch.zeros(L * E, dtype=torch.float32, device=device)
        counts.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32, device=device))
        f = (counts / n).reshape(L, E)
        per_layer = torch.cat([f, f.reshape(L, K, E // K).sum(-1)], dim=1)
        for row in per_layer:
            acc = row if acc is None else acc + row
    return acc if acc is not None else torch.zeros(E + K, device=device)


def load_balance_loss(probs: torch.Tensor, topk_idx: torch.Tensor,
                      num_experts: int, num_groups: int) -> Dict[str, torch.Tensor]:
    """Switch/GShard auxiliary loss at expert and group granularity:
    ``L = E * sum_e f_e P_e`` (1 at perfect balance)."""
    E, K = num_experts, num_groups
    st = routing_stats(topk_idx, E, K)
    P = probs.float().mean(0)
    Pg = P.reshape(K, E // K).sum(-1)
    return {
        "lb_expert": E * torch.sum(st["expert_frac"] * P),
        "lb_group": K * torch.sum(st["group_frac"] * Pg),
        **st,
    }


def gate(params: Dict, x: torch.Tensor, moe_cfg,
         expert_mask: Optional[torch.Tensor] = None, *, aux: bool = True) -> GateOutput:
    """Full HL-GGN gate: probabilities, top-k selection and, with ``aux``,
    the auxiliary losses and routing statistics.  Without it (serving) the
    aux holds only ``topk_idx``, at no cost: the one consumer of the
    routing statistics (the streaming engine's end stage) counts them from
    it with :func:`summed_routing_stats`."""
    probs, p_group, aux_d = group_gate_probs(params, x, moe_cfg, expert_mask, aux=aux)
    topk_idx, topk_w = select_topk(probs, moe_cfg.top_k)
    E, K = moe_cfg.num_experts, moe_cfg.num_groups
    if aux:
        lb = load_balance_loss(probs, topk_idx, E, K)
        aux_d.update(lb)
        aux_d["aux_loss"] = (
            moe_cfg.router_aux_weight * (lb["lb_expert"] + lb["lb_group"])
            + moe_cfg.router_z_weight * aux_d["router_z"]
        )
    else:
        aux_d["topk_idx"] = topk_idx
    return GateOutput(probs, topk_idx, topk_w, p_group, aux_d)
