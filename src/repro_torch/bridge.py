"""Carry parameters between the packages through numpy.

The reference package's parameters, handed over as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side), become the
port's tensors one to one: same keys, same stacked ``[n_blocks, ...]``
layouts, same values.  Taking numpy keeps JAX out of this package.

On an expert-parallel topology each rank holds its own experts: a MoE
layer's ``wi``/``wg``/``wo`` (``[..., E, d, f]`` / ``[..., E, f, d]``, the
expert axis third from the end, stacked or not) come across as this rank's
slice ``[r·E/ep, (r+1)·E/ep)`` along the model axis, and where weights
are resident (``serve_*``, no FSDP) an SSM layer's head-indexed leaves
come across as this rank's head slices (``models.ssm.resident_slices``),
everything else whole (serving's layout); for training on a mesh :func:`blocks_from_numpy` hands
each rank its blocks of every leaf by the ``distributed.sharding`` specs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.distributed import sharding
from repro_torch.distributed.topology import Topology
from repro_torch.models import ssm

EXPERT_LEAVES = ("wi", "wg", "wo")


def params_from_numpy(tree: Dict, device=DEFAULT_DEVICE, topo: Optional[Topology] = None) -> Dict:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device``; with an expert-parallel ``topo`` a MoE layer's (a dict with
    a ``gate``) expert leaves are cut to this rank's slice, and with a
    resident-weight one an SSM layer's (a dict with ``A_log``) head-indexed
    leaves to this rank's heads."""
    moe_layer = "gate" in tree and topo is not None and topo.use_shard_map_moe

    def leaf(k, v):
        a = np.asarray(v)
        if moe_layer and k in EXPERT_LEAVES:
            a = a[..., topo.expert_slice(a.shape[-3]), :, :]
        return torch.from_numpy(np.array(a)).to(device)  # a writable copy

    out = {
        k: params_from_numpy(v, device, topo) if isinstance(v, dict) else leaf(k, v)
        for k, v in tree.items()
    }
    if "A_log" in out and topo is not None:
        out = {k: v.contiguous() for k, v in ssm.resident_slices(out, topo).items()}
    return out


def blocks_from_numpy(tree: Dict, specs: Dict, topo: Topology, device=DEFAULT_DEVICE) -> Dict:
    """Whole params or optimizer state (nested dicts of numpy arrays) ->
    this rank's block of every leaf by ``specs`` (``sharding.train_specs``),
    as tensors on ``device``."""
    return {
        k: blocks_from_numpy(v, specs[k], topo, device) if isinstance(v, dict)
        else sharding.local_block(torch.from_numpy(np.array(v)), specs[k], topo)
        .to(device, copy=True).contiguous()
        for k, v in tree.items()
    }
