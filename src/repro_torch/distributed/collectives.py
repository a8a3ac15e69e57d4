"""The collectives of the expert-parallel MoE bodies, the vocabulary-sharded
loss and the sharded train step, on ``torch.distributed`` (the
counterparts of the reference's ``jax.lax`` collectives inside
``shard_map``).

Each is differentiable where a gradient is wanted.  The ranks run SPMD and
every rank seeds the backward of the one global loss, which it holds alike,
with 1; so the gradient a rank holds of a value that every rank of a group
holds alike (a *replicated* value) is the whole gradient, not a share of
it.  The backwards follow from that:

- :func:`all_to_all`: the same exchange of the gradient;
- :func:`all_gather` (shards in, a replicated value out): this rank's
  chunk of the gradient, no collective;
- :func:`all_gather_rs` (shards in, a gathered value that the ranks
  consume each in its own way, as sequence-parallel queries read the
  gathered K/V): the gradients summed over the group, this rank's chunk
  of the sum (a reduce-scatter);
- :func:`psum` (partial sums in, a replicated value out): the identity;
- :func:`pmean`: the gradient over the group's size (:func:`pmax` has
  none: the loss's shift);
- :func:`split` (a replicated value in, this rank's chunk out): the
  gradient chunks gathered;
- :func:`fanout` (a replicated value that the ranks consume each in its
  own way): the identity forward, the ranks' gradients summed backward.

``torch.distributed.nn.functional`` is not used: its ``all_reduce``
backward sums the gradient over the group, which counts a consumer that
every rank runs alike once a rank.

Each wire collective counts its calls and the bytes this rank hands in,
forward (``calls``, ``bytes``) and backward (``bwd_calls``, ``bwd_bytes``)
apart, as a kernel wrapper counts its launches (:func:`counts`;
:func:`reset_counts` zeroes them).  Every rank of the group must make the
same calls in the same order.  On gloo the tensors may live on a card
(gloo takes CUDA tensors in ``all_to_all_single``,
``all_gather_into_tensor`` and ``all_reduce`` and copies through the host
itself); nccl needs them there.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

_NAMES = ("all_to_all", "all_gather", "all_gather_rs", "psum", "pmean", "pmax",
          "reduce_scatter")
_COUNTS: Dict[str, Dict[str, int]] = {}


def _tally(name: str, x: torch.Tensor, backward: bool = False) -> None:
    c = _COUNTS[name]
    c["bwd_calls" if backward else "calls"] += 1
    c["bwd_bytes" if backward else "bytes"] += x.numel() * x.element_size()


def _size(group) -> int:
    return dist.get_world_size(group)


def _wants_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


# -- the wire -----------------------------------------------------------------


def _a2a(x: torch.Tensor, group, backward=False) -> torch.Tensor:
    _tally("all_to_all", x, backward)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _gather(x: torch.Tensor, group, backward=False, name="all_gather") -> torch.Tensor:
    _tally(name, x, backward)
    x = x.contiguous()
    out = x.new_empty((_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _sum(x: torch.Tensor, group, backward=False) -> torch.Tensor:
    """Sum over the group in f32, returned in f32."""
    _tally("psum", x, backward)
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y


def _chunk(x: torch.Tensor, group) -> torch.Tensor:
    n = _size(group)
    c = x.shape[0] // n
    r = dist.get_rank(group)
    return x[r * c : (r + 1) * c]


# -- differentiable collectives ------------------------------------------------


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _a2a(dy, ctx.group, backward=True), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _chunk(dy, ctx.group).contiguous(), None


class _AllGatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group, name="all_gather_rs")

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.group, "all_gather_rs", True).to(dy.dtype), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _sum(x, group).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        return dy.to(ctx.dtype), None


class _Pmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        _tally("pmean", x)
        ctx.n, ctx.dtype = _size(group), x.dtype
        y = x.to(torch.float32, copy=True)
        dist.all_reduce(y, group=group)
        return y / ctx.n

    @staticmethod
    def backward(ctx, dy):
        return (dy / ctx.n).to(ctx.dtype), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _chunk(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, ctx.group, backward=True), None


class _Fanout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.meta = [(x.shape, x.dtype) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *dys):
        flat = [torch.zeros(s, dtype=torch.float32, device=_device(dys)) if d is None
                else d.float() for d, (s, _) in zip(dys, ctx.meta)]
        total = _sum(torch.cat([f.reshape(-1) for f in flat]), ctx.group, backward=True)
        out, i = [], 0
        for shape, dtype in ctx.meta:
            n = shape.numel()
            out.append(total[i : i + n].reshape(shape).to(dtype))
            i += n
        return (None, *out)


def _device(ts) -> torch.device:
    return next(t.device for t in ts if t is not None)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled ``all_to_all`` along dim 0: ``x [n·c, ...]`` in n blocks, block
    j to rank j of the group; out block j is what rank j sent this rank
    (``jax.lax.all_to_all(x, axis, 0, 0, tiled=True)``).  Backward: the
    same exchange of the gradient."""
    if _wants_grad(x):
        return _AllToAll.apply(x, group)
    return _a2a(x, group)


def _along(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn`` (a dim-0 collective) along ``dim`` of ``x``."""
    if dim == 0:
        return fn(x)
    return fn(x.movedim(dim, 0)).movedim(0, dim).contiguous()


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Tiled ``all_gather`` along ``dim``: ``[c, ...] -> [n·c, ...]`` in
    rank order; the output is replicated, so the backward hands this rank
    its own chunk of the gradient."""
    if _wants_grad(x):
        return _along(lambda t: _AllGather.apply(t, group), x, dim)
    return _along(lambda t: _gather(t, group), x, dim)


def all_gather_rs(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Tiled ``all_gather`` along ``dim``, ``[c, ...] -> [n·c, ...]`` in rank
    order, of a value that each rank goes on to consume in its own way (the
    gathered K/V of sequence-parallel attention, read by each rank's own
    queries), so that each rank's gradient of it is a share: the backward
    sums the shares over the group and hands this rank its chunk of the sum
    (a reduce-scatter; with :func:`all_gather`'s chunk-only backward the
    other ranks' shares would be lost).  Counted as ``all_gather_rs``: the
    forward's gathers and the backward's reduce-scatters."""
    if _wants_grad(x):
        return _along(lambda t: _AllGatherRS.apply(t, group), x, dim)
    return _along(lambda t: _gather(t, group, name="all_gather_rs"), x, dim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, in f32, returned in ``x``'s type; the output is
    replicated, so its gradient reaches each rank's partial unchanged."""
    if _wants_grad(x):
        return _Psum.apply(x, group)
    return _sum(x, group).to(x.dtype)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the group, in f32: each rank's term has weight 1/n."""
    if _wants_grad(x):
        return _Pmean.apply(x, group)
    _tally("pmean", x)
    y = x.to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y / _size(group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group, with no gradient (the loss's
    numerical-stability shift, which the reference keeps out of its
    backward with ``stop_gradient``)."""
    _tally("pmax", x)
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def split(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along ``dim`` of a value replicated over the group
    (``[n·c, ...] -> [c, ...]``, a view); the backward gathers the chunks'
    gradients, so every rank holds the whole gradient of ``x``."""
    if _wants_grad(x):
        return _Split.apply(x.movedim(dim, 0), group).movedim(0, dim)
    return _chunk(x.movedim(dim, 0), group).movedim(0, dim)


def fanout(xs: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """``xs`` unchanged: values replicated over the group that each rank
    goes on to consume in its own way (its own tokens, its own experts), so
    that each rank's gradient is a share; the backward sums the shares over
    the group in one all-reduce (Megatron's *f*)."""
    xs = list(xs)
    if not _wants_grad(*xs):
        return xs
    return list(_Fanout.apply(group, *xs))


# -- gradient reduction and checks (no autograd) ------------------------------


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group of ``x [n·c, ...]``, this rank's chunk ``[c,
    ...]`` of it, in f32 (nccl's ``reduce_scatter_tensor``; on gloo an
    all-reduce then the chunk, gloo having no reduce-scatter for CUDA
    tensors in every release)."""
    return _reduce_scatter(x, group, "reduce_scatter")


def _reduce_scatter(x: torch.Tensor, group, name: str, backward: bool = False) -> torch.Tensor:
    _tally(name, x, backward)
    y = x.to(torch.float32).contiguous()
    if dist.get_backend(group) == "nccl":
        out = y.new_empty((y.shape[0] // _size(group),) + tuple(y.shape[1:]))
        dist.reduce_scatter_tensor(out, y, group=group)
        return out
    y = y.clone() if y.data_ptr() == x.data_ptr() else y
    dist.all_reduce(y, group=group)
    return _chunk(y, group).clone()


def gather_objects(obj, group) -> list:
    """Every rank's ``obj`` (picklable), in rank order; not counted (a
    check, not the model's traffic)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(group) -> None:
    """Wait for every rank of the group (not counted)."""
    dist.barrier(group=group)


def reset_counts() -> None:
    for name in _NAMES:
        _COUNTS[name] = {"calls": 0, "bytes": 0, "bwd_calls": 0, "bwd_bytes": 0}


def counts() -> Dict[str, Dict[str, int]]:
    """{name: {"calls", "bytes", "bwd_calls", "bwd_bytes"}} since the last
    :func:`reset_counts`: the forward's calls and bytes handed in, and the
    backward's apart."""
    return {k: dict(v) for k, v in _COUNTS.items()}


reset_counts()
