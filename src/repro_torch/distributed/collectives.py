"""The collectives the expert-parallel MoE bodies use, on
``torch.distributed`` (the counterparts of the reference's ``jax.lax``
collectives inside ``shard_map``).

Each function counts its calls and the bytes this rank hands in, as a
kernel wrapper counts its launches (``all_to_all.calls``,
``all_to_all.bytes``; :func:`reset_counts` zeroes them all).  Every rank of
the group must make the same calls in the same order.  On gloo the tensors
may live on a card (gloo takes CUDA tensors in each of these collectives and
copies through the host itself); nccl needs them there.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist


def _count(fn, x: torch.Tensor) -> None:
    fn.calls += 1
    fn.bytes += x.numel() * x.element_size()


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled ``all_to_all`` along dim 0: ``x [n·c, ...]`` in n blocks, block
    j to rank j of the group; out block j is what rank j sent this rank
    (``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``)."""
    _count(all_to_all, x)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled ``all_gather`` along dim 0: ``[c, ...] -> [n·c, ...]`` in rank
    order."""
    _count(all_gather, x)
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in f32, returned in ``x``'s type."""
    _count(psum, x)
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the group, in f32."""
    _count(pmean, x)
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)


def gather_objects(obj, group) -> list:
    """Every rank's ``obj`` (picklable), in rank order; not counted (a
    check, not the model's traffic)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


COLLECTIVES = (all_to_all, all_gather, psum, pmean)


def reset_counts() -> None:
    for fn in COLLECTIVES:
        fn.calls = 0
        fn.bytes = 0


def counts() -> Dict[str, Dict[str, int]]:
    """{name: {"calls", "bytes"}} since the last :func:`reset_counts`."""
    return {fn.__name__: {"calls": fn.calls, "bytes": fn.bytes} for fn in COLLECTIVES}


reset_counts()
