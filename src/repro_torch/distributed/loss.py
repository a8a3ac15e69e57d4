"""The language-model loss at the model's output (port of the reference's
``distributed/loss.py``).

On one device it is ``layers.cross_entropy_loss``.  On a mesh the head's
output dim is sharded over the model axis, so each rank holds its batch
shard's logits ``[b, S, V/tp]``; the rank computes its local max (no
gradient), sum-exp and label hit and combines them over the model axis:
bytes on the wire are O(b·S), never O(b·S·V).  The numerator, the z-term
and the token count are summed over the data axes, so every rank returns
the one global scalar; on a mesh without a model axis (``dp``, ``fsdp``)
the logits are whole and only that last sum runs.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.topology import Topology
from repro_torch.models.layers import cross_entropy_loss


def _sharded_ce_body(logits: torch.Tensor, labels: torch.Tensor, topo: Topology,
                     z_weight: float):
    """The reference's ``_sharded_ce_body`` on this rank: ``logits [b, S,
    V_loc]`` (this rank's slice of the vocabulary when the mesh has a model
    axis), ``labels [b, S]`` global ids, -1 masked."""
    logits = logits.float()
    V_loc = logits.shape[-1]
    sharded = topo.model_axis is not None
    lo = topo.model_index * V_loc if sharded else 0
    # the shift is numerical only: no gradient, as the reference's stop_gradient
    gmax = logits.detach().amax(-1)
    if sharded:
        gmax = coll.pmax(gmax, topo.model_group)
    sumexp = torch.exp(logits - gmax[..., None]).sum(-1)
    mask = labels >= 0
    lab = (labels.long() - lo).clamp(0, V_loc - 1)
    hit = (labels >= lo) & (labels < lo + V_loc) & mask
    ll = torch.where(hit, logits.gather(-1, lab[..., None])[..., 0], 0.0)
    if sharded:  # one all-reduce for both: their sums are replicated
        sumexp, ll = coll.psum(torch.stack([sumexp, ll]), topo.model_group)
    lse = gmax + torch.log(sumexp)
    maskf = mask.float()
    local = torch.stack([((lse - ll) * maskf).sum(), (lse.square() * maskf).sum(),
                         maskf.sum()])
    nll, z, den = coll.psum(local, topo.data_group) if topo.dp_size > 1 else local
    den = den.detach()
    denom = den.clamp_min(1.0)
    loss = nll / denom + z_weight * z / denom
    return loss, nll / denom, den


def sharded_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          topo: Optional[Topology] = None,
                          z_weight: float = 1e-4) -> Tuple[torch.Tensor, Dict]:
    """Cross-entropy with the z-term: on one device (no ``topo``, or no
    mesh) exactly ``layers.cross_entropy_loss`` over ``logits [B, S, V]``;
    on a mesh over this rank's batch shard, the logits this rank's
    vocabulary slice when a model axis exists, and the loss, ``ce_loss``,
    ``z_loss`` and ``tokens`` the global values on every rank."""
    if topo is None or topo.mesh_shape is None:
        return cross_entropy_loss(logits, labels, z_weight)
    loss, ce, tokens = _sharded_ce_body(logits, labels, topo, z_weight)
    return loss, {"ce_loss": ce, "z_loss": loss - ce, "tokens": tokens}
