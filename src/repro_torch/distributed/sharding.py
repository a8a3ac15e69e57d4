"""Partition rules and blocks (port of the reference's
``distributed/sharding.py``): the parameter, optimizer-state and batch
specs of a mesh, this rank's block of a tensor by its spec and the blocks
gathered back; and the fleet's cloud expert sharding.

A spec is a tuple with one entry a dim (``()`` replicates): ``None``, a
mesh axis name, or a tuple of two or more axis names (the dim sharded over
their product, row-major): ``tuple(PartitionSpec(...))`` of the
reference's spec, a one-axis tuple written as the axis's name as
``PartitionSpec`` writes it.
The rules:

  * TP / EP on the ``model`` axis: attention heads, FFN hidden, the expert
    dim, the vocabulary of the embedding and the head;
  * FSDP on the data axes: every large matrix also shards one non-model
    dim over the data axes (ZeRO-3: params and optimizer state scale down
    with the device count);
  * an axis that does not divide its dim is dropped (the largest prefix of
    the data axes that divides it is kept).

Rules match the parameter's path (``"blocks/pos0/attn/wq"``).  The port
runs SPMD, one process a rank: a rank stores the block of each leaf that
its coordinates pick (:func:`local_block`), and :func:`gather_block` puts a
leaf back together from the ranks' blocks.

The fleet expert registry measures, per expert, the share of fleet traffic
whose misses drain to the cloud (``FleetExpertRegistry.cloud_expert_load``);
:func:`fleet_expert_shards` balances the experts across the cloud's
servers by that load, and :func:`shard_expert_stacks` slices the dense
stacked expert weights accordingly.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.topology import Topology

Spec = Tuple[Any, ...]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _canon(spec) -> Spec:
    """A one-axis tuple entry as the axis's name (``PartitionSpec``'s form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _axis_size(topo: Topology, axes) -> int:
    if axes is None or topo.mesh_shape is None:
        return 1
    return math.prod(topo.mesh_shape[topo.axis_names.index(a)] for a in _axes(axes))


def _fit(dim: int, axes, topo: Topology):
    """The largest prefix of ``axes`` whose size divides ``dim`` (a single
    axis name: itself or None), else None."""
    if axes is None:
        return None
    if isinstance(axes, str):
        return axes if dim % _axis_size(topo, axes) == 0 else None
    t = tuple(axes)
    while t:
        if dim % _axis_size(topo, t) == 0:
            return t
        t = t[:-1]
    return None


def param_partition_spec(path: str, shape: Tuple[int, ...], topo: Topology) -> Spec:
    """The rule table; ``path`` is '/'-joined (``blocks/posN/...``)."""
    if topo.mesh_shape is None:
        return ()
    dp = tuple(topo.data_axes) if topo.fsdp else None
    tp = topo.model_axis
    name = path.split("/")[-1]
    in_moe = "/moe/" in path or path.endswith("moe")
    in_attn = "/attn/" in path or "/cross/" in path

    def spec(*entries):
        return _canon(_fit(shape[i], ax, topo) if ax is not None else None
                      for i, ax in enumerate(entries))

    nd = len(shape)
    if name == "embed":  # [V, d]
        return spec(tp, dp)
    if name == "lm_head":  # [d, V]
        return spec(dp, tp)
    # under sequence-parallel attention activations carry the model axis
    # (S-sharded); non-expert weights do not
    wtp = None if topo.seq_parallel_attn else tp
    if name in ("wq", "wk", "wv") and in_attn:  # [R, d, H|KV, hd]
        return spec(None, dp, wtp, None) if nd == 4 else spec(dp, wtp, None)
    if name == "wo" and in_attn:  # [R, H, hd, d]
        return spec(None, wtp, None, dp) if nd == 4 else spec(wtp, None, dp)
    if name in ("wi", "wg") and in_moe and nd == 4:  # [R, E, d, f]
        return spec(None, tp, dp, None)
    if name == "wo" and in_moe and nd == 4:  # [R, E, f, d]
        return spec(None, tp, None, dp)
    if name in ("wi", "wg"):  # dense / shared FFN [R, d, f] or [d, f]
        return spec(None, dp, wtp) if nd == 3 else spec(dp, wtp)
    if name == "wo":  # [R, f, d] or [f, d]
        return spec(None, wtp, dp) if nd == 3 else spec(wtp, dp)
    if name == "in_proj":  # [R, d, proj]
        return spec(None, dp, wtp)
    if name == "out_proj":  # [R, d_in, d]
        return spec(None, wtp, dp)
    if name in ("w_z", "w_x", "w_dt"):  # SSM split projections [R, d, d_in|H]
        return spec(None, dp, wtp)
    if name == "w_bc":  # [R, d, 2gn], shared across heads
        return spec(None, dp, None)
    if name == "conv_x":  # [R, W, d_in]
        return spec(None, None, wtp)
    if name == "conv_x_b":  # [R, d_in]
        return spec(None, wtp)
    if name in ("A_log", "D", "dt_bias") and nd == 2:  # [R, H]
        return spec(None, wtp)
    if name == "norm_w" and nd == 2:  # [R, d_in]
        return spec(None, wtp)
    if name == "w_local" and nd == 4:  # gate [R, K, d, Mk]
        return spec(None, None, dp, None)
    # everything else (norms, biases, conv, the gate's globals, codecs) is
    # small: replicated
    return ()


def _map_with_path(fn, tree: Dict, prefix: str = "") -> Dict:
    return {k: _map_with_path(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}


def param_specs(params: Dict, topo: Topology) -> Dict:
    """The spec of every leaf of a params tree (leaves need only ``.shape``)."""
    return _map_with_path(lambda path, leaf: param_partition_spec(path, tuple(leaf.shape), topo),
                          params)


def opt_state_specs(opt_state: Dict, params: Dict, topo: Topology) -> Dict:
    """Optimizer-state specs: AdamW's ``m`` / ``v`` mirror the param's;
    Adafactor's factored ``vr`` / ``vc`` drop the reduced dim (``vr`` the
    last, ``vc`` the one before); scalars replicate."""
    pspecs = param_specs(params, topo)

    def resolve(path, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return ()
        m = re.match(r"^(m|v|stats)/(.*?)(/vr|/vc|/v)?$", path)
        if not m:
            return ()
        node = pspecs
        for part in m.group(2).split("/"):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                return ()
        base = node if isinstance(node, tuple) else ()
        suffix = m.group(3)
        if suffix in ("/vr", "/vc"):
            # pad to the param's rank (nd + 1), then drop the reduced dim
            ent = base + (None,) * (nd + 1 - len(base))
            return ent[:-1] if suffix == "/vr" else ent[:-2] + ent[-1:]
        return base

    return _map_with_path(resolve, opt_state)


def fit_batch_axes(B: int, topo: Topology):
    """The largest prefix of the data axes whose size divides ``B``, else
    None (the batch replicates)."""
    if topo.mesh_shape is None:
        return None
    axes = tuple(topo.data_axes)
    while axes:
        if B % _axis_size(topo, axes) == 0:
            return axes
        axes = axes[:-1]
    return None


def batch_specs(batch: Dict, topo: Topology) -> Dict:
    """Input-batch specs: the batch dim over (a prefix of) the data axes;
    decode caches shard the sequence over the model axis (and over the data
    axes too when the batch cannot)."""
    if topo.mesh_shape is None:
        return _map_with_path(lambda path, leaf: (), batch)
    dp = tuple(topo.data_axes)
    tp = topo.model_axis
    dp_n = _axis_size(topo, dp)

    def resolve(path, leaf):
        name = path.split("/")[-1]
        shape = tuple(leaf.shape)
        if "cache" in path or name in ("k", "v", "xk", "xv", "ssm", "conv_x", "conv_bc"):
            b_ok = shape[1] % dp_n == 0 if len(shape) > 1 else False
            all_axes = dp + ((tp,) if tp else ())
            if name in ("k", "v", "xk", "xv"):  # [R, B, W, KV, hd]
                seq_ax = (_fit(shape[2], tp, topo) if b_ok
                          else _fit(shape[2], all_axes, topo) or _fit(shape[2], tp, topo))
                return (None, dp if b_ok else None, seq_ax, None, None)
            if name == "ssm":  # [R, B, H, P, N]
                return (None, dp if b_ok else None, _fit(shape[2], tp, topo), None, None)
            if name in ("conv_x", "conv_bc"):  # [R, B, W-1, ch]
                ch_ax = _fit(shape[3], tp, topo) if name == "conv_x" else None
                return (None, dp if b_ok else None, None, ch_ax)
            if name == "lengths":
                return (_fit(shape[0], dp, topo),) if shape else ()
        if name == "lengths":
            return (_fit(shape[0], dp, topo),) if len(shape) == 1 else ()
        if len(shape) >= 1:
            bx = fit_batch_axes(shape[0], topo)
            if bx:
                return (bx,) + (None,) * (len(shape) - 1)
        return ()

    return _map_with_path(lambda path, leaf: _canon(resolve(path, leaf)), batch)


# -- blocks ---------------------------------------------------------------------


def _coord(topo: Topology, axes: Tuple[str, ...]) -> int:
    """This rank's row-major index over ``axes``."""
    idx = 0
    for a in axes:
        i = topo.axis_names.index(a)
        idx = idx * topo.mesh_shape[i] + topo.coords[i]
    return idx


def local_block(full: torch.Tensor, spec: Spec, topo: Topology) -> torch.Tensor:
    """This rank's block of ``full`` by ``spec`` (a view; no collective)."""
    out = full
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = _axis_size(topo, axes)
        c = full.shape[dim] // n
        out = out.narrow(dim, _coord(topo, axes) * c, c)
    return out


def _group(topo: Topology, entry):
    """The process group of the ranks that share every coordinate but
    those of ``entry``'s axes: the model axis, all the data axes, or the
    data axes and then the model axis (a cache's sequence when its batch
    does not split; the group's ranks in that row-major order)."""
    axes = _axes(entry)
    if topo.model_axis is not None and axes == (topo.model_axis,):
        return topo.model_group
    if axes == tuple(topo.data_axes):
        return topo.data_group
    if topo.model_axis is not None and axes == tuple(topo.data_axes) + (topo.model_axis,):
        return topo.data_model_group
    raise NotImplementedError(
        f"a dim sharded over {axes}: the port has groups for the model axis, for all the "
        f"data axes {tuple(topo.data_axes)} and for both together only")


def gather_block(block: torch.Tensor, spec: Spec, topo: Topology,
                 keep: Spec = ()) -> torch.Tensor:
    """The ranks' blocks of one leaf put back together along every sharded
    dim but those whose entry ``keep`` repeats (collective: every rank of
    those groups calls it)."""
    out = block
    for dim, entry in enumerate(spec):
        if not _axes(entry) or (dim < len(keep) and keep[dim] == entry):
            continue
        moved = out.movedim(dim, 0)
        g = coll.all_gather(moved, _group(topo, entry))
        out = g.movedim(0, dim)
    return out.contiguous()


def shard_tree(full: Dict, specs: Dict, topo: Topology) -> Dict:
    """Every leaf's block (contiguous copies), by the matching spec."""
    return {k: shard_tree(v, specs[k], topo) if isinstance(v, dict)
            else local_block(v, specs[k], topo).contiguous().clone() for k, v in full.items()}


def gather_tree(blocks: Dict, specs: Dict, topo: Topology) -> Dict:
    """Every leaf whole again (collective, in the tree's order)."""
    return {k: gather_tree(v, specs[k], topo) if isinstance(v, dict)
            else gather_block(v, specs[k], topo) for k, v in blocks.items()}


# -- the fleet's cloud expert sharding ------------------------------------------


def fleet_expert_shards(expert_load: Sequence[float], num_servers: int) -> List[List[int]]:
    """Greedy LPT partition of the experts over ``num_servers``: heaviest
    expert to the least-loaded server, expert id and server index breaking
    ties.  Returns one sorted expert-id list a server, covering every
    expert once."""
    if num_servers < 1:
        raise ValueError(f"num_servers={num_servers}")
    load = [float(x) for x in expert_load]
    shards: List[List[int]] = [[] for _ in range(num_servers)]
    totals = [0.0] * num_servers
    for e in sorted(range(len(load)), key=lambda e: (-load[e], e)):
        s = min(range(num_servers), key=lambda s: (totals[s], s))
        shards[s].append(e)
        totals[s] += load[e]
    return [sorted(s) for s in shards]


def shard_expert_stacks(moe_params: Dict[str, torch.Tensor],
                        shards: Sequence[Sequence[int]]) -> List[Dict[str, torch.Tensor]]:
    """Slice stacked expert weights ``{"wi": [R, E, d, f], ...}`` along the
    expert axis into one dict a server (each holds only its experts' rows)."""
    out = []
    for shard in shards:
        out.append({k: leaf.index_select(1, torch.as_tensor(list(shard), dtype=torch.long,
                                                            device=leaf.device))
                    for k, leaf in moe_params.items()})
    return out





# -- training on a mesh ---------------------------------------------------------


def train_specs(full_params: Dict, optimizer: str, topo: Topology) -> Tuple[Dict, Dict]:
    """(param specs, optimizer-state specs) of a model whose whole params
    are ``full_params`` (leaves need only ``.shape``), with ``optimizer``'s
    state (its shapes made on the meta device)."""
    from repro_torch.training.optimizer import init_optimizer, tree_map

    meta = tree_map(lambda t: torch.empty(tuple(t.shape), device="meta"), full_params)
    state = init_optimizer(optimizer, meta)
    return param_specs(full_params, topo), opt_state_specs(state, full_params, topo)


# an SSM layer's leaves indexed by head (their last dim, ``out_proj``'s the
# one before): head-sharded when the model axis divides the heads
SSM_HEAD_LEAVES = ("w_z", "w_x", "w_dt", "conv_x", "conv_x_b", "A_log", "D", "dt_bias",
                   "norm_w", "out_proj")


def compute_spec(path: str, spec: Spec, topo: Topology, ssm_heads: bool = False) -> Spec:
    """The layout a rank computes a leaf in: whole, but for the model axis's
    entry of a MoE layer's experts (this rank's ``E / ep``), of the head
    (this rank's vocabulary slice) and, with ``ssm_heads`` (the layer's
    heads split over the model axis: ``models.ssm.apply_ssm``'s
    head-sharded branch), of an SSM layer's head-indexed leaves, when the
    mesh has a model axis."""
    if topo.model_axis is None or topo.tp_size == 1:
        return ()
    name, nd = path.split("/")[-1], len(spec)
    expert = "/moe/" in path and name in ("wi", "wg", "wo") and nd == 4
    heads = ssm_heads and "/ssm/" in path and name in SSM_HEAD_LEAVES
    if expert or heads or name == "lm_head":
        return tuple(e if e == topo.model_axis else None for e in spec)
    return ()


def compute_specs(specs: Dict, topo: Topology, prefix: str = "") -> Dict:
    """:func:`compute_spec` of every leaf; an SSM layer (a dict with
    ``A_log``) computes on its head slices where its ``A_log`` [R, H] is
    sharded over the model axis (the model axis divides the heads)."""
    heads = "A_log" in specs and topo.model_axis is not None and topo.model_axis in {
        a for e in specs["A_log"] for a in _axes(e)}
    return {k: compute_specs(v, topo, f"{prefix}{k}/") if isinstance(v, dict)
            else compute_spec(f"{prefix}{k}", v, topo, heads) for k, v in specs.items()}


def resident_specs(params: Dict, topo: Topology) -> Dict:
    """The specs of the layout a rank holds a model's params in where
    weights are resident (``serve_*``; ``bridge.params_from_numpy`` and
    ``Model.init`` hand it out; leaves need only ``.shape``, whole): a MoE
    layer's experts over the model axis, an SSM layer's head-indexed leaves
    over it where the model axis divides the heads, every other leaf
    whole.  A mesh ``Checkpointer`` given them writes the one-device
    format and restores the slices."""
    from repro_torch.models.ssm import HEAD_LEAVES, heads_divide

    tp = topo.model_axis

    def walk(tree, path):
        heads = "A_log" in tree and heads_divide(tree["A_log"].shape[-1], topo)
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            nd = len(v.shape)
            spec = [None] * nd
            if topo.use_shard_map_moe and path and path[-1] == "moe" and k in ("wi", "wg", "wo"):
                spec[nd - 3] = tp
            elif heads and k in HEAD_LEAVES:
                spec[HEAD_LEAVES[k] % nd] = tp
            out[k] = tuple(spec) if any(spec) else ()
        return out

    return walk(params, ())


def reduce_grad(grad: torch.Tensor, spec: Spec, cspec: Spec, topo: Topology) -> torch.Tensor:
    """A leaf's gradient in its compute layout (``cspec``; whole on every
    rank of the model group, a share of the data axes' sum: where a rank
    consumes a leaf that its model group holds alike in its own way, on its
    own tokens, heads or sequence slice, the forward passed it through
    ``collectives.fanout`` or ``split``, which sum the shares over the
    model group in the backward) -> this rank's
    block of the summed gradient by ``spec``, in f32: reduce-scattered over
    the data axes along the dim they split (all-reduced when none does),
    then cut to this rank's block along the model axis where the compute
    layout holds that dim whole."""
    g = grad.float()
    data = [i for i, e in enumerate(spec) if _axes(e) and e != topo.model_axis]
    if topo.dp_size > 1:
        if data:
            i = data[0]
            g = coll.reduce_scatter(g.movedim(i, 0), _group(topo, spec[i])).movedim(0, i)
        else:
            g = coll.psum(g, topo.data_group)
    keep = tuple(e if i < len(cspec) and cspec[i] == e else None for i, e in enumerate(spec))
    model = tuple(e if e == topo.model_axis and e not in keep else None for e in spec)
    return local_block(g, model, topo).contiguous()


def leaf_shards(blocks: Dict, specs: Dict, topo: Topology) -> list:
    """``training.optimizer.Shards`` of every leaf of ``blocks`` (the
    optimizer's view of the mesh), in ``tree_leaves`` order."""
    from repro_torch.training.optimizer import Shards, tree_leaves

    out = []
    for block, spec in zip(tree_leaves(blocks), spec_leaves(specs, blocks)):
        full = tuple(n * _axis_size(topo, spec[i]) if i < len(spec) else n
                     for i, n in enumerate(block.shape))
        groups = tuple(_group(topo, spec[i]) if i < len(spec) and _axes(spec[i]) else None
                       for i in range(block.dim()))
        used = {a for e in spec for a in _axes(e)}
        owner = all(c == 0 for a, c in zip(topo.axis_names, topo.coords) if a not in used)
        out.append(Shards(full, groups, owner))
    return out


def spec_leaves(specs: Dict, like: Dict) -> list:
    """The specs of ``like``'s leaves, in ``tree_leaves`` order (``like``
    may be ``specs`` itself)."""
    out = []
    for k, v in like.items():
        out.extend(spec_leaves(specs[k], v) if isinstance(v, dict) else [specs[k]])
    return out


__all__ = ["param_partition_spec", "param_specs", "opt_state_specs", "fit_batch_axes",
           "batch_specs", "local_block", "gather_block", "shard_tree",
           "gather_tree", "fleet_expert_shards", "shard_expert_stacks", "train_specs",
           "compute_spec", "compute_specs", "resident_specs", "reduce_grad", "leaf_shards",
           "spec_leaves"]
