"""Group-gated Mixture-of-Experts layer (port of the reference's
``core/moe.py``: the ``sorted``, ``naive``, pooled ``resident`` and the
expert-parallel ``a2a`` and ``tp`` paths of ``apply_moe``).

``sorted`` sorts the token-to-expert assignments by expert, runs the expert
FFN as one grouped product over the sorted rows (``kernels.expert_mlp``,
the CUDA kernel on the card), and scatters the rows back; ``naive`` runs
every expert on every token and is the oracle; ``resident`` is the end
tier's pooled path, the same product over rows sorted by resident slot,
each slot reading its slab of the expert pool's store.

The expert-parallel bodies run on a :class:`Topology` whose model axis
holds ``E / ep`` experts a rank (each rank's params hold its slices of
``wi``/``wg``/``wo``, everything else whole; ``bridge.params_from_numpy``
hands them out).  ``a2a`` is the paper-faithful one: each rank gates its
share of the tokens, packs the assignments into per-destination capacity
buffers, exchanges them with ``all_to_all`` (through the eq. 8 low-rank
codec when the config has a dispatch codec), runs its experts on what it
received and sends the rows back.  ``tp`` gates every token on every rank,
runs the assignments that hit its own experts and sums the partial outputs
over the model axis (through the codec: the codec is linear, so the sum
commutes with decoding).  The ranks run SPMD, the collectives are
``distributed.collectives``.  Serving hands every rank the whole batch and
gathers the bodies' data-local outputs back to every rank; training hands
each rank its own batch shard, which the bodies take as it is.  Under
sequence parallelism (``topo.seq_parallel_attn``) the a2a body takes
pre-sharded tokens, each rank its own ``[B/dp, S/ep]`` tile, as the
reference's does: the sequence-parallel stack hands it its slice of the
sequence, any other caller the usual layout, cut here and gathered back.
All paths share the HL-GGN gate.

The bodies train: every collective has its backward, and where a rank
consumes a value that its model group holds alike in a way of its own (the
a2a body's own share of the tokens, gate and codec; the tp body's own
assignments of the tokens and gate weights, its own partial output into
the encode), the value passes ``collectives.fanout`` or ``split``, so the
gradient of every replicated input (``x``, the gate, the codec) is whole on
every rank of the model group: the caller sums it over the data axes only.
The experts' gradients are this rank's slices', every token routed to them
counted.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import compression as comp
from repro_torch.core import gating
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.topology import Topology
from repro_torch.kernels.expert_mlp import (
    grouped_mlp,
    grouped_mlp_resident,
    grouped_mlp_resident_quant,
)
from repro_torch.models.layers import ACTIVATIONS, apply_mlp, init_mlp, truncated_normal_init


def init_moe(generator: torch.Generator, cfg, lead: Tuple[int, ...] = (),
             draw_experts: bool = True) -> Dict:
    """A MoE layer's params; ``draw_experts=False`` leaves out ``wi`` /
    ``wg`` / ``wo`` (drawn apart by :func:`init_expert_slices`)."""
    m = cfg.moe
    dtype = cfg.torch_param_dtype
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    p = {"gate": gating.init_group_gate(generator, d, m, lead)}
    if draw_experts:
        p["wi"] = truncated_normal_init(generator, (E, d, f), dtype, 1.0, lead)
        p["wo"] = truncated_normal_init(generator, (E, f, d), dtype, 1.0, lead)
    if cfg.ffn_gated and draw_experts:
        p["wg"] = truncated_normal_init(generator, (E, d, f), dtype, 1.0, lead)
    if m.shared_experts:
        p["shared"] = init_mlp(generator, d, m.shared_experts * f, dtype,
                               gated=cfg.ffn_gated, lead=lead)
    if _dispatch_compressed(cfg):
        p["codec"] = comp.init_lowrank_1d(generator, d, cfg.compression.rank,
                                          device=generator.device, lead=lead)
    return p


def init_expert_slices(cfg, seed: int, layers, topo: Optional[Topology], device) -> Dict:
    """The expert weights of MoE layers ``layers`` (their indices in the
    whole stack), only this rank's experts (``topo.expert_slice``; all of
    them without a topology), stacked ``[len(layers), E_loc, ...]``.
    Expert e of layer l is drawn from a generator on ``device`` seeded by
    (``seed``, l, e), so the draw does not depend on the mesh, with
    :func:`init_moe`'s distribution (the truncated normal at 1/sqrt(E))."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    experts = range(E)[(topo.expert_slice(E) if topo is not None else slice(0, E))]
    shapes = {"wi": (d, f), "wo": (f, d)}
    if cfg.ffn_gated:
        shapes["wg"] = (d, f)
    out = {k: torch.empty((len(layers), len(experts)) + s, dtype=cfg.torch_param_dtype,
                          device=device) for k, s in shapes.items()}
    g = torch.Generator(device=device)
    for li, layer in enumerate(layers):
        for j, e in enumerate(experts):
            g.manual_seed(((seed * 1_000_003 + layer) * 1_000_003 + e) % (1 << 63))
            for k, s in shapes.items():
                w = torch.empty(s, dtype=torch.float32, device=device)
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
                out[k][li, j] = w * (1.0 / E ** 0.5)
    return out


def _dispatch_compressed(cfg) -> bool:
    c = cfg.compression
    return c is not None and c.rank > 0 and "dispatch" in c.boundaries


def _capacity(n_assign: int, buckets: int, factor: float) -> int:
    c = int(-(-n_assign * factor // buckets))  # ceil
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


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


# ---------------------------------------------------------------------------
# Expert-parallel paths (one rank of an SPMD group)
# ---------------------------------------------------------------------------


def _scatter_to_buckets(payload: torch.Tensor, dst: torch.Tensor, slot: torch.Tensor,
                        capacity: int, n_buckets: int) -> torch.Tensor:
    """payload [n, d]; dst/slot [n] -> [n_buckets, capacity, d] with
    out-of-capacity rows dropped (parked in a pad row, then cut)."""
    buf = payload.new_zeros((n_buckets, capacity + 1, payload.shape[-1]))
    buf[dst, slot.clamp_max(capacity)] = payload
    return buf[:, :capacity]


def _scatter_meta(meta: torch.Tensor, dst: torch.Tensor, slot: torch.Tensor,
                  capacity: int, n_buckets: int, fill: int = 0) -> torch.Tensor:
    buf = meta.new_full((n_buckets, capacity + 1), fill)
    buf[dst, slot.clamp_max(capacity)] = meta
    return buf[:, :capacity]


def _rank_in_bucket(dst: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """dst: [n] -> rank of each element among those with the same dst, in
    row order (which rows a full bucket drops follows from it)."""
    oh = torch.nn.functional.one_hot(dst, n_buckets).int()
    return (oh.cumsum(0) - 1).gather(1, dst[:, None])[:, 0]


def _segment_sum(rows: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return rows.new_zeros((n, rows.shape[1])).index_add_(0, seg, rows)


def _fanout_params(params: Optional[Dict], group) -> Optional[Dict]:
    """A flat dict of replicated params through ``collectives.fanout`` (the
    entries that are tensors), for a rank that consumes them in its own
    way."""
    if params is None:
        return None
    keys = [k for k, v in params.items() if isinstance(v, torch.Tensor)]
    return {**params, **dict(zip(keys, coll.fanout([params[k] for k in keys], group)))}


def _moe_a2a_body(
    x: torch.Tensor,  # [t, d] data-local, model-replicated
    experts: Dict,  # {"wi": [E_loc, d, f], ("wg"), "wo"}: this rank's slices
    gate_params: Dict,
    codec: Optional[Dict],
    cfg,
    topo: Topology,
    expert_mask,
    capacity_factor: float,
    pre_sharded: bool = False,
    *,
    aux: bool = True,
):
    """The reference's ``_moe_a2a_body``: this rank takes tokens
    ``[me·ts, (me+1)·ts)``, gates them, packs each assignment into the
    capacity buffer of the rank owning its expert (``C`` rows a
    destination; an assignment past ``C`` in its bucket, in row order, is
    dropped), exchanges payload and local expert ids with ``all_to_all``,
    runs the grouped FFN over its ``E / ep`` experts (padding rows on
    expert 0, zero rows), sends the rows back, combines by gate weight and
    gathers the tokens over the model axis.  A dispatch codec encodes the
    payload before each exchange and decodes it after.  With ``aux`` the
    gate's losses and statistics and ``dropped_frac`` come back averaged
    over every rank of the data and model axes; without it (serving) the
    aux is empty.  This rank's tokens (``split``), gate and codec
    (``fanout``) are its own consumption, so their gradients come back
    whole on every rank of the model group.

    ``pre_sharded``: ``x`` holds this rank's own tokens already (the
    sequence-parallel residual stream): every row is this rank's, with no
    ``split`` and no gather at the end."""
    _moe_a2a_body.calls += 1
    m = cfg.moe
    ep, group = topo.ep_size, topo.model_group
    E_loc = m.num_experts // ep
    t, d = x.shape
    k = m.top_k
    if pre_sharded:
        ts, xs = t, x
    else:
        ts = t // ep
        xs = coll.split(x, group)  # tokens [me·ts, (me+1)·ts)
    gate_params = _fanout_params(gate_params, group)
    codec = _fanout_params(codec, group)
    out = gating.gate(gate_params, xs, m, expert_mask, aux=aux)
    eid = out.topk_idx.reshape(-1)  # [ts*k]
    w = out.topk_weight.reshape(-1)
    dst = torch.div(eid, E_loc, rounding_mode="floor")
    tok = torch.arange(ts * k, device=x.device) // k
    slot = _rank_in_bucket(dst, ep)
    C = _capacity(ts * k, ep, capacity_factor)
    keep = slot < C

    payload = xs[tok]  # [ts*k, d]
    if codec is not None:
        payload = comp.encode_1d(codec, payload).to(x.dtype)
    send = _scatter_to_buckets(payload, dst, slot, C, ep)
    send_eid = _scatter_meta((eid % E_loc).int(), dst, slot, C, ep)

    recv = coll.all_to_all(send, group)  # [ep, C, dpay]
    recv_eid = coll.all_to_all(send_eid, group)

    rows = recv.reshape(ep * C, -1)
    if codec is not None:
        rows = comp.decode_1d(codec, rows).to(x.dtype)
    y_rows = _sorted_expert_ffn(rows, recv_eid.reshape(-1).long(), E_loc, experts, cfg.act)
    if codec is not None:
        y_rows = comp.encode_1d(codec, y_rows).to(x.dtype)
    back = coll.all_to_all(y_rows.reshape(ep, C, -1), group)

    got = back[dst, slot.clamp_max(C - 1)]  # [ts*k, dpay]
    if codec is not None:
        got = comp.decode_1d(codec, got).to(x.dtype)
    got = torch.where(keep[:, None], got * w[:, None].to(got.dtype), 0.0)
    y = _segment_sum(got, tok, ts).to(x.dtype)
    if not pre_sharded:
        y = coll.all_gather(y, group)  # [t, d]
    if not aux:
        return y, {}
    stats = _pmean_all({**out.aux, "dropped_frac": 1.0 - keep.float().mean()},
                       topo.data_model_group)
    return y, stats


def _moe_tp_body(
    x: torch.Tensor,  # [t, d] data-local, model-replicated
    experts: Dict,  # this rank's expert slices
    gate_params: Dict,
    codec: Optional[Dict],
    cfg,
    topo: Topology,
    expert_mask,
    capacity_factor: float,
    *,
    aux: bool = True,
):
    """The reference's ``_moe_tp_body``: every rank gates all ``t`` tokens,
    keeps the first ``C`` assignments (in row order) that hit its own
    experts, runs them, combines by gate weight and sums the partial
    outputs over the model axis: in f32, or with a dispatch codec as
    ``decode(psum(encode(y)))``.  ``aux`` as in :func:`_moe_a2a_body`.
    The gate runs alike on every rank of the model group; the tokens and
    gate weights its own assignments read, and the encoder its own partial
    output goes through, pass ``fanout``, so every replicated input's
    gradient comes back whole on every rank of the model group, the
    gate's included.  The gate's statistics being alike over the model
    axis, their mean over every rank is their mean over the data axes."""
    _moe_tp_body.calls += 1
    m = cfg.moe
    ep, group = topo.ep_size, topo.model_group
    E_loc = m.num_experts // ep
    t, d = x.shape
    k = m.top_k
    me = topo.model_index

    out = gating.gate(gate_params, x, m, expert_mask, aux=aux)  # replicated compute
    eid = out.topk_idx.reshape(-1)  # [t*k]
    xr, w = coll.fanout([x, out.topk_weight.reshape(-1)], group)
    tok = torch.arange(t * k, device=x.device) // k
    mine = torch.div(eid, E_loc, rounding_mode="floor") == me
    slot = mine.int().cumsum(0) - 1  # rank among my local assignments
    C = _capacity(t * k, ep, capacity_factor)
    keep = mine & (slot < C)

    idx = torch.where(keep, slot, C).long()  # the rest to the pad row
    sel_tok = torch.zeros(C + 1, dtype=torch.long, device=x.device)
    sel_tok[idx] = tok
    sel_eid = torch.zeros(C + 1, dtype=torch.long, device=x.device)
    sel_eid[idx] = eid % E_loc
    sel_w = torch.zeros(C + 1, dtype=torch.float32, device=x.device)
    sel_w[idx] = torch.where(keep, w, 0.0).float()
    sel_tok, sel_eid, sel_w = sel_tok[:C], sel_eid[:C], sel_w[:C]

    y_rows = _sorted_expert_ffn(xr[sel_tok], sel_eid, E_loc, experts, cfg.act)  # [C, d]
    y = _segment_sum(y_rows * sel_w[:, None].to(y_rows.dtype), sel_tok, t)
    if codec is not None:
        # compressed all-reduce: the codec is linear, so summing in the
        # low-rank space commutes with decoding; the psum moves r/d the bytes
        enc = {**codec, "enc": coll.fanout([codec["enc"]], group)[0]}
        y = comp.decode_1d(codec, coll.psum(comp.encode_1d(enc, y), group)).to(x.dtype)
    else:
        y = coll.psum(y.float(), group).to(x.dtype)
    if not aux:
        return y, {}
    stats = _pmean_all(dict(out.aux), topo.data_group if topo.dp_size > 1 else None)
    kept = _pmean_all({"_kept": keep.sum() / (t * k)}, topo.data_model_group)["_kept"]
    stats["dropped_frac"] = 1.0 - kept * ep
    return y, stats


def _pmean_all(values: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each value's mean over ``group``, all in one f32 all-reduce: the
    reference's ``pmean`` over the data and model axes is
    ``topo.data_model_group`` (a pipeline axis's replicas are not in it).
    ``group=None``: a group of one, the values as they are in f32."""
    flat = [v.float().reshape(-1) for v in values.values()]
    if group is None:
        return {k: f.reshape(v.shape) for (k, v), f in zip(values.items(), flat)}
    mean = coll.pmean(torch.cat(flat), group)
    out, i = {}, 0
    for (key, v), f in zip(values.items(), flat):
        out[key] = mean[i : i + f.numel()].reshape(v.shape)
        i += f.numel()
    return out


_moe_a2a_body.calls = 0
_moe_tp_body.calls = 0


def _expert_parallel(params: Dict, x: torch.Tensor, cfg, topo: Topology, impl: str,
                     expert_mask, cf: float, train: bool, seq_sharded: bool = False):
    """The reference's ``shard_map`` branch on one rank.  Serving: the
    tokens' data shard in (all of them when ``dp`` does not divide the
    count: they stay replicated), the body, and the data shards gathered
    back.  Training: ``x`` is already this rank's data shard, and the body
    takes it as it is.  Its token count ``T`` (the reference's, over the
    whole mesh) decides the body as there: ``a2a`` falls back to ``tp``
    when ``ep`` does not divide the data-local count, and under sequence
    parallelism ``a2a`` takes pre-sharded tokens (:func:`_pre_sharded`)."""
    m = cfg.moe
    if params["wi"].shape[-3] * topo.ep_size != m.num_experts:
        raise ValueError(
            f"expert-parallel MoE: wi {tuple(params['wi'].shape)} is not this rank's "
            f"{m.num_experts // topo.ep_size} of {m.num_experts} experts")
    dp, ep = topo.dp_size, topo.ep_size
    T = x.numel() // x.shape[-1] * (dp if train else 1) * (ep if seq_sharded else 1)
    batch_shardable = T % dp == 0
    t_loc = T // dp if batch_shardable else T
    if impl == "a2a" and t_loc % ep != 0:  # decode shapes that ep does not divide
        impl = "tp"
    experts = {kk: params[kk] for kk in ("wi", "wg", "wo") if kk in params}
    args = (experts, params["gate"], params.get("codec"), cfg, topo, expert_mask, cf)
    if topo.seq_parallel_attn and batch_shardable and impl == "a2a":
        return _pre_sharded(x, args, topo, train, seq_sharded)
    if seq_sharded:  # the tp body takes every token: the slices gathered, then cut again
        whole = coll.all_gather(x, topo.model_group, dim=1)
        y, aux = _expert_parallel(params, whole, cfg, topo, impl, expert_mask, cf, train)
        return coll.split(y, topo.model_group, dim=1), aux
    x2 = x.reshape(-1, x.shape[-1])
    sharded = batch_shardable and dp > 1 and not train
    if sharded:
        i = topo.data_index
        x2 = x2[i * t_loc : (i + 1) * t_loc]
    body = _moe_a2a_body if impl == "a2a" else _moe_tp_body
    y, aux = body(x2, *args, aux=train)
    if sharded:
        y = coll.all_gather(y, topo.data_group)
    return y.reshape(x.shape), aux


def _pre_sharded(x: torch.Tensor, args, topo: Topology, train: bool, seq_sharded: bool):
    """The a2a body on pre-sharded tokens: this rank's tile of the
    reference's layout, its rows flattened locally in the reference's
    order (bucket ranks, and so drops, follow it).  ``[B, S, d]``: the tile
    ``[B/dp, S/ep]`` of its ``body3d``, which refuses a B that ``dp`` or an
    S that ``ep`` does not divide (a ``ValueError`` here too); ``[T, d]``:
    the rows ``(data, model)``-major, ``T / (dp·ep)`` a rank.  With
    ``seq_sharded`` ``x`` is this rank's slice of the sequence already and
    so is the output; otherwise the tile is cut from the usual layout
    (serving: the whole batch; training: this rank's data shard) and the
    output gathered back into it."""
    dp, ep, model = topo.dp_size, topo.ep_size, topo.model_group
    data_cut = dp > 1 and not train  # serving holds every data shard
    if x.dim() == 3:
        B = x.shape[0] * (dp if train else 1)
        S = x.shape[1] * (ep if seq_sharded else 1)
        if B % dp or S % ep:
            raise ValueError(
                f"pre-sharded MoE tokens [{B}, {S}, {x.shape[2]}]: batch and sequence must "
                f"divide evenly over the data ({dp}) and model ({ep}) axes (the reference's "
                "shard_map refuses axis sizes that are not evenly divisible)")
        tile = x if seq_sharded else coll.split(x, model, dim=1)
        if data_cut:
            tile = coll.split(tile, topo.data_group)
        y, aux = _moe_a2a_body(tile.reshape(-1, tile.shape[-1]), *args, True, aux=train)
        y = y.reshape(tile.shape)
        if data_cut:
            y = coll.all_gather(y, topo.data_group)
        return (y if seq_sharded else coll.all_gather(y, model, dim=1)), aux
    group = topo.data_model_group if data_cut else model
    y, aux = _moe_a2a_body(coll.split(x, group), *args, True, aux=train)
    return coll.all_gather(y, group), aux


def apply_moe(params: Dict, x: torch.Tensor, cfg, topo: Optional[Topology] = None, *,
              expert_mask=None, train: bool = True, seq_sharded: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoE FFN over ``x [B, S, d]`` (or ``[T, d]``).  With
    ``params["resident"]`` (the pooled end tier) the dispatch runs over the
    resident slabs (:func:`moe_resident`).  On an expert-parallel ``topo``
    (``use_shard_map_moe``) ``impl="auto"`` is ``a2a``, and ``a2a``/``tp``
    run their bodies on this rank's expert slices.  Serving
    (``train=False``): ``x`` is the whole (replicated) batch and so is the
    output, and a token count that ``dp`` does not divide stays replicated
    over the data axes.  Training: ``x`` and the output are this rank's
    batch shard (the training stack carries it), and the bodies'
    gradients reach ``x``, the gate, the codec and this rank's experts.
    ``a2a`` falls back to ``tp`` when ``ep`` does not divide the
    data-local count.  Training takes ``capacity_factor``, serving
    ``eval_capacity_factor``, so serving can drop assignments.  Under
    sequence parallelism the a2a body takes pre-sharded tokens
    (:func:`_pre_sharded`); ``seq_sharded`` says that ``x [B, S/ep, d]`` is
    this rank's slice of the sequence (the sequence-parallel stack's
    residual stream), and the output is too.

    ``train=False`` (serving) skips the router losses and routing
    statistics and returns the gate's ``topk_idx`` in their place on one
    device, and an empty aux on a mesh: the reference computes them and
    lets XLA drop them when the serving step discards them, but eager
    PyTorch would run every one of those ops."""
    m = cfg.moe
    impl = cfg.moe_impl
    ep_mode = topo is not None and topo.use_shard_map_moe
    if impl == "auto":
        impl = "a2a" if ep_mode else "sorted"
    cf = m.capacity_factor if train else m.eval_capacity_factor
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if ep_mode and impl not in ("a2a", "tp"):
        raise ValueError(f"moe impl {impl!r} on an expert-parallel topology: its ranks "
                         "hold expert slices, which only 'a2a' and 'tp' run")
    if "resident" in params:
        y, aux = moe_resident(params, x2, cfg, expert_mask, aux=train)
    elif impl in ("a2a", "tp") and ep_mode:
        y, aux = _expert_parallel(params, x, cfg, topo, impl, expert_mask, cf, train,
                                  seq_sharded)
        y = y.reshape(-1, shape[-1])
    elif impl == "sorted":
        y, aux = moe_sorted(params, x2, cfg, expert_mask, aux=train)
    elif impl == "naive":
        y, aux = moe_naive(params, x2, cfg, expert_mask, aux=train)
    else:
        raise ValueError(f"unknown moe impl {impl!r} (topology={topo})")
    if m.shared_experts and "shared" in params:
        y = y + apply_mlp(params["shared"], x2, cfg.act)
    return y.reshape(shape), aux
