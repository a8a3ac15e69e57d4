"""Transformer stack (port of the reference's ``models/transformer.py``:
init, embedding and head, the full-sequence layer and stack (the one-shot
end-cloud pipeline, and ``Model.prefill`` with its collected dense
caches), the bidirectional encoder of an encoder-decoder, and the decode
stack over paged pools or dense caches and the chunked-prefill stack of
attention-only patterns), and the training form of the full-sequence stack
(router losses, the aux summed as the reference sums it, per-block
recomputation).  A layer is an attention layer, with
cross-attention to the encoder's output in an encoder-decoder's decoder,
or a Mamba-2 SSM layer (``models/ssm.py``), each with an optional dense or
MoE FFN.

Params keep the reference's layout: ``blocks["pos{i}"]`` leaves are stacked
over the ``block_repeat`` axis, and a Python loop over blocks takes the
place of ``lax.scan``.  The paged KV pools are updated in place.

``topo`` (a :class:`~repro_torch.distributed.topology.Topology`) reaches
every MoE and SSM layer: on an expert-parallel topology each rank runs the
same layers on the same activations (serving: the whole batch; training:
its data shard, alike over the model axis), its MoE layers run the
``a2a`` / ``tp`` bodies over the rank's expert slices, and its SSM layers
run head-sharded (``ssm.apply_ssm``).  Under sequence-parallel attention
(``topo.seq_parallel_attn``, the ``seqp`` policies) a block's attention
layers and what follows them run on this rank's slice of the sequence,
``S / ep`` tokens: where the reference's ``_constrain_tokens`` pins the
residual stream S-sharded at a layer's entry, the port cuts it
(``collectives.split``), and where it pins it whole at the block's end
(or an SSM or cross-attention layer needs the whole sequence), gathers it
back.  In between, attention gathers only the K/V heads
(:func:`_self_attention_seqp`) and the MoE dispatch takes the slice as its
pre-sharded tokens.  The replicated weights such a layer consumes on its
own slice pass ``collectives.fanout``, so their gradients are summed over
the model group where they are consumed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import LayerSpec
from repro_torch.core.compression import compute_codec
from repro_torch.core.moe import apply_moe, init_moe
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.topology import Topology
from repro_torch.models import attention as attn
from repro_torch.models import kvcache, ssm
from repro_torch.models.layers import (
    apply_mlp,
    init_embedding,
    init_mlp,
    init_norm,
    rms_norm,
    truncated_normal_init,
)

NEG_INF = -1e30
# weights every use site casts to the activation type (``.astype(x.dtype)``
# in the reference); norms and the gate stay in f32, and so do the SSM's
# conv weights (its decode step reads them in f32), A_log, D and dt_bias
COMPUTE_CAST = frozenset({"wq", "wk", "wv", "wo", "wi", "wg", "embed", "lm_head",
                          "w_z", "w_x", "w_bc", "w_dt", "out_proj"})


def _has_ffn(spec, cfg) -> bool:
    return bool(spec.moe and cfg.moe) or cfg.d_ff > 0


def init_layer(generator: torch.Generator, cfg, spec, R: int, draw_experts: bool = True) -> Dict:
    """One pattern position's params, stacked over ``R`` block repeats
    (``draw_experts=False``: a MoE layer's without its expert weights)."""
    dtype, dev, lead = cfg.torch_param_dtype, generator.device, (R,)
    p: Dict[str, Any] = {"norm1": init_norm(cfg.d_model, dtype, dev, lead)}
    if spec.kind == "attn":
        p["attn"] = attn.init_attention(generator, cfg, dtype, lead)
        if spec.cross_attn:
            p["norm_x"] = init_norm(cfg.d_model, dtype, dev, lead)
            p["cross"] = attn.init_attention(generator, cfg, dtype, lead)
    else:
        p["ssm"] = ssm.init_ssm(generator, cfg, dtype, lead)
    if _has_ffn(spec, cfg):
        p["norm2"] = init_norm(cfg.d_model, dtype, dev, lead)
        if spec.moe:
            p["moe"] = init_moe(generator, cfg, lead, draw_experts)
        else:
            p["ffn"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, cfg.ffn_gated, lead)
    return p


def init_params(cfg, generator: torch.Generator, draw_experts: bool = True) -> Dict:
    """Random params with the reference's shapes and init scales, made from
    ``generator`` on its device (``draw_experts=False``: without the MoE
    layers' expert weights, which ``Model.init`` draws apart)."""
    dtype = cfg.torch_param_dtype
    params: Dict[str, Any] = {
        "embed": init_embedding(generator, cfg.padded_vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg.d_model, dtype, generator.device),
        "blocks": {
            f"pos{i}": init_layer(generator, cfg, spec, cfg.block_repeat, draw_experts)
            for i, spec in enumerate(cfg.layer_pattern)
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = truncated_normal_init(
            generator, (cfg.d_model, cfg.padded_vocab_size), dtype, 1.0
        )
    if cfg.encoder_decoder:  # plain attention layers stacked over encoder_layers
        params["encoder"] = {
            "blocks": init_layer(generator, cfg, LayerSpec(kind="attn"), cfg.encoder_layers),
            "norm": init_norm(cfg.d_model, dtype, generator.device),
        }
    return params


def compute_params(params: Dict, cfg) -> Dict:
    """Params with every weight the forward casts to the activation type
    (``COMPUTE_CAST``) stored in that type once, at load.  Each use casts to
    the same type, so the values the forward sees are identical (parity
    holds) and the per-step casts become no-ops.  A MoE layer's dispatch
    codec keeps its f32 ``enc`` / ``dec`` and gains their activation-type
    copies (``compression.compute_codec``), which its roundtrips read."""
    dt = cfg.torch_dtype

    def walk(tree):
        return {
            k: (compute_codec(v, dt) if k == "codec" else walk(v)) if isinstance(v, dict)
            else (v.to(dt) if k in COMPUTE_CAST else v)
            for k, v in tree.items()
        }

    return walk(params)


def block_params(tree: Dict, r: int) -> Dict:
    """Block ``r``'s slice of stacked params (views, no copy)."""
    return {k: block_params(v, r) if isinstance(v, dict) else v[r] for k, v in tree.items()}


def _ffn(p: Dict, x: torch.Tensor, spec, cfg, expert_mask, expert_resident=None,
         train: bool = False, topo: Optional[Topology] = None, seq_sharded: bool = False):
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if spec.moe:
        mp = p["moe"]
        if expert_resident is not None:
            # pooled end tier: the stripped moe params get this layer's
            # resident tables and the shared slab store (core.expertpool)
            mp = {**mp, "resident": expert_resident}
        y, aux = apply_moe(mp, h, cfg, topo, expert_mask=expert_mask, train=train,
                           seq_sharded=seq_sharded)
        return x + y, aux
    return x + apply_mlp(p["ffn"], h, cfg.act), {}


def _self_attention_full(p: Dict, h: torch.Tensor, cfg, angles, causal: bool):
    """(output, (k, v)): the keys and values feed a collected cache."""
    q, k, v = attn.project_qkv(p, h, cfg, angles)
    o = attn.flash_attention(
        q, k, v, causal=causal, window=cfg.sliding_window if causal else None
    )
    return attn.output_proj(p, o), (k, v)


def _self_attention_seqp(p: Dict, h: torch.Tensor, cfg, topo: Topology, angles, causal: bool,
                         whole_kv: bool = False):
    """Sequence-parallel self attention (the reference's
    ``_self_attention_seqp``): ``h`` [B, S/ep, d] is this rank's slice of the
    sequence, ``angles`` its slice's; q, k and v are projected on it, only
    the K/V heads are gathered over the model axis (``all_gather_rs``: each
    rank's queries read them in their own way, so the backward sums the
    ranks' shares), and the flash call runs this rank's queries at
    positions ``model_index · S/ep + i`` against every key.  Returns
    (output [B, S/ep, d], (k, v)): this rank's K/V slice, as the reference
    returns it for the cache, or with ``whole_kv`` the gathered K/V."""
    group = topo.model_group
    q, k, v = attn.project_qkv(p, h, cfg, angles)
    kv = coll.all_gather_rs(torch.stack([k, v]), group, dim=2)
    kf, vf = kv[0], kv[1]
    o = attn.flash_attention(q, kf, vf, causal=causal,
                             window=cfg.sliding_window if causal else None,
                             q_offset=topo.model_index * h.shape[1])
    return attn.output_proj(p, o), ((kf, vf) if whole_kv else (k, v))


def seqp_stack(cfg, topo: Optional[Topology], x_shape, train: bool = False) -> bool:
    """The reference's ``use_seqp`` for a stack's attention layers (a
    cross-attention layer never): sequence-parallel attention on a mesh of
    more than one model rank, a batch the data axes divide (``x_shape`` is
    this rank's batch shard in training, the whole batch in serving) and a
    sequence the model axis divides."""
    if topo is None or topo.mesh_shape is None or not topo.seq_parallel_attn:
        return False
    if topo.model_axis is None or topo.ep_size == 1:
        return False
    B = x_shape[0] * (topo.dp_size if train else 1)
    return B % topo.dp_size == 0 and x_shape[1] % topo.ep_size == 0


def _seq_weights(p: Dict, topo: Topology) -> Dict:
    """A layer's params with every replicated leaf that the layer consumes
    on this rank's slice of the sequence (all but a MoE layer's gate and
    codec, whose bodies fan them out themselves, and its expert slices)
    through ``collectives.fanout``: their gradients are the ranks' shares,
    summed over the model group in the backward."""
    if not torch.is_grad_enabled():
        return p
    paths, leaves = [], []

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                if not (path == ("moe",) and k in ("gate", "codec")):
                    walk(v, path + (k,))
            elif not (path == ("moe",) and k in ("wi", "wg", "wo")):
                paths.append(path + (k,))
                leaves.append(v)

    walk(p, ())
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in p.items()}
    for path, leaf in zip(paths, coll.fanout(leaves, topo.model_group)):
        node = out
        for k in path[:-1]:
            node[k] = dict(node[k])
            node = node[k]
        node[path[-1]] = leaf
    return out


def _cross_attention_full(p: Dict, h: torch.Tensor, enc_out: torch.Tensor, cfg):
    """Decoder queries ``h`` [B, S, d] against the encoder's output
    ``enc_out`` [B, S_enc, d]: no RoPE, every frame visible (non-causal
    flash attention with Sq != Skv).  Returns (output, (k, v)): the
    projected frames feed the cross cache."""
    q = attn._project(h, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    k = attn._project(enc_out, p["wk"])
    v = attn._project(enc_out, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    o = attn.flash_attention(q, k, v, causal=False)
    return attn.output_proj(p, o), (k, v)


def apply_layer_full(
    p: Dict,
    x: torch.Tensor,  # [B, S, d]
    spec,
    cfg,
    angles: torch.Tensor,  # [B, S, hd/2]
    *,
    causal: bool = True,
    enc_out: Optional[torch.Tensor] = None,  # [B, S_enc, d] (cross-attention layers)
    expert_mask=None,
    collect_cache: bool = False,
    max_len: int = 0,
    train: bool = False,
    topo: Optional[Topology] = None,
    seq_sharded: bool = False,
):
    """Full-sequence layer.  ``train=False`` (serving) skips a MoE layer's
    router losses and statistics (its aux holds the gate's ``topk_idx``);
    ``train=True`` computes them (``apply_moe(train=True)``).  Returns
    (x, aux, cache_entry); with ``collect_cache`` the entry holds an
    attention layer's k/v written into fresh dense rings of ``max_len``
    (``kvcache.prefill_write``) and, with cross-attention, the projected
    encoder frames ``xk``/``xv`` [B, S_enc, KV, hd]; or an SSM layer's
    final state and conv tails (``ssm``, ``conv_x``, ``conv_bc``); else it
    is empty.

    ``seq_sharded``: ``x`` and ``angles`` are this rank's slice of the
    sequence (:func:`seqp_stack`; the caller cuts and gathers), the layer
    an attention layer without cross-attention: its attention runs
    :func:`_self_attention_seqp` (with ``collect_cache`` every rank writes
    the whole ring, the gathered K/V) and its MoE dispatch takes the
    slice's tokens as pre-sharded.  On a mesh an SSM layer runs
    head-sharded where the reference's does (``ssm.apply_ssm``)."""
    aux: Dict[str, torch.Tensor] = {}
    cache_entry: Dict[str, torch.Tensor] = {}
    if seq_sharded:
        p = _seq_weights(p, topo)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.kind == "attn":
        if seq_sharded:
            o, (k, v) = _self_attention_seqp(p["attn"], h, cfg, topo, angles, causal,
                                             whole_kv=collect_cache)
        else:
            o, (k, v) = _self_attention_full(p["attn"], h, cfg, angles, causal)
        x = x + o
        if collect_cache:
            shape = (x.shape[0], kvcache.attn_cache_len(cfg, max_len), cfg.num_kv_heads,
                     cfg.head_dim)
            kc = torch.zeros(shape, dtype=k.dtype, device=k.device)
            cache_entry["k"], cache_entry["v"] = kvcache.prefill_write(
                kc, torch.zeros_like(kc), k, v)
        if spec.cross_attn:
            hx = rms_norm(x, p["norm_x"], cfg.norm_eps)
            ox, (xk, xv) = _cross_attention_full(p["cross"], hx, enc_out, cfg)
            x = x + ox
            if collect_cache:
                cache_entry["xk"], cache_entry["xv"] = xk, xv
    else:
        o = ssm.apply_ssm(p["ssm"], h, cfg, return_state=collect_cache, topo=topo,
                          train=train)
        if collect_cache:
            o, (final_state, (cx, cbc)) = o
            cache_entry.update(ssm=final_state, conv_x=cx, conv_bc=cbc)
        x = x + o
    if _has_ffn(spec, cfg):
        x, aux = _ffn(p, x, spec, cfg, expert_mask, train=train, topo=topo,
                      seq_sharded=seq_sharded)
    return x, aux, cache_entry


def _merge_aux(acc: Dict, aux: Dict) -> Dict:
    """The reference's ``_merge_aux``: sum each key in layer order."""
    for k, v in aux.items():
        acc[k] = acc[k] + v if k in acc else v
    return acc


def _block(x, bp: Dict, cfg, angles, causal, enc_out, expert_mask, topo, train: bool,
           seqp: bool, collect_cache: bool = False, max_len: int = 0):
    """One block of the pattern: (x, each layer's aux, each layer's cache
    entry).  With ``seqp`` (:func:`seqp_stack`) the sequence is cut to this
    rank's slice at the entry of each attention layer without
    cross-attention, gathered back before any other layer and at the
    block's end."""
    sharded, angles_loc = False, None
    auxes, entries = [], []
    for i, spec in enumerate(cfg.layer_pattern):
        want = seqp and spec.kind == "attn" and not spec.cross_attn
        if want and not sharded:  # this rank's slice of the sequence (dim 1)
            x = coll.split(x, topo.model_group, dim=1)
            if angles_loc is None:
                angles_loc = coll.split(angles, topo.model_group, dim=1)
        elif sharded and not want:
            x = coll.all_gather(x, topo.model_group, dim=1)
        sharded = want
        x, aux, ce = apply_layer_full(
            bp[f"pos{i}"], x, spec, cfg, angles_loc if sharded else angles, causal=causal,
            enc_out=enc_out, expert_mask=expert_mask, collect_cache=collect_cache,
            max_len=max_len, train=train, topo=topo, seq_sharded=sharded)
        auxes.append(aux)
        entries.append(ce)
    if sharded:
        x = coll.all_gather(x, topo.model_group, dim=1)
    return x, auxes, entries


def _train_block(x, bp: Dict, cfg, angles, causal, enc_out, expert_mask, topo=None,
                 seqp: bool = False):
    """One block of the pattern in the training form: (x, the block's aux
    summed over its MoE layers)."""
    x, auxes, _ = _block(x, bp, cfg, angles, causal, enc_out, expert_mask, topo, True, seqp)
    aux_acc: Dict[str, torch.Tensor] = {}
    for aux in auxes:
        aux_acc = _merge_aux(aux_acc, aux)
    return x, aux_acc


def apply_stack_full(params: Dict, x: torch.Tensor, cfg, angles: torch.Tensor, *,
                     causal: bool = True, enc_out: Optional[torch.Tensor] = None,
                     expert_mask=None, collect_cache: bool = False, max_len: int = 0,
                     train: bool = False, remat: bool = False,
                     topo: Optional[Topology] = None):
    """Loop the block pattern over a full sequence (``enc_out``: the
    encoder's output, which cross-attention layers attend).  Returns (x,
    the aux of every MoE layer in order, cache blocks or None): with
    ``collect_cache`` the blocks pytree of ``kvcache.init_cache``'s layout,
    each leaf the layers' rings, cross caches or SSM states stacked over
    the block repeats.

    ``train=True`` is the training form: every MoE layer computes its
    router losses and statistics (and a dispatch codec's ``recon_loss``),
    and the aux comes back as one dict, summed within a block and then
    over blocks as the reference sums it, so vector statistics keep their
    ``[E]`` and ``[K]`` shapes; returns (x, aux, None).  With ``remat``
    (and grad mode on) each block runs under ``torch.utils.checkpoint``
    (non-reentrant), which drops its saved activations and recomputes the
    block in the backward, as the reference's ``jax.checkpoint``.  On a
    mesh ``topo`` the training form runs on this rank's batch shard: the
    layers compute on the weights they are handed (non-expert weights
    whole, this rank's experts), the MoE bodies exchange the tokens, and
    the router's aux is averaged over the ranks; every rank recomputes its
    blocks alike, so the recomputed collectives meet.  Under
    sequence-parallel attention (:func:`seqp_stack`) each block runs its
    attention layers on this rank's slice of the sequence and returns it
    whole (:func:`_block`)."""
    seqp = seqp_stack(cfg, topo, x.shape, train)
    if train:
        aux_sum: Dict[str, torch.Tensor] = {}
        for r in range(_n_blocks(params["blocks"])):
            bp = block_params(params["blocks"], r)
            if remat and torch.is_grad_enabled():
                x, aux = torch.utils.checkpoint.checkpoint(
                    _train_block, x, bp, cfg, angles, causal, enc_out, expert_mask, topo,
                    seqp, use_reentrant=False, preserve_rng_state=False)
            else:
                x, aux = _train_block(x, bp, cfg, angles, causal, enc_out, expert_mask, topo,
                                      seqp)
            aux_sum = _merge_aux(aux_sum, aux)
        return x, aux_sum, None
    layer_aux: List[Dict[str, torch.Tensor]] = []
    caches: Dict[str, Dict[str, List[torch.Tensor]]] = {}
    for r in range(_n_blocks(params["blocks"])):
        bp = block_params(params["blocks"], r)
        x, auxes, entries = _block(x, bp, cfg, angles, causal, enc_out, expert_mask, topo,
                                   False, seqp, collect_cache, max_len)
        for i, (aux, ce) in enumerate(zip(auxes, entries)):
            if aux:
                layer_aux.append(aux)
            for n, leaf in ce.items():
                caches.setdefault(f"pos{i}", {}).setdefault(n, []).append(leaf)
    if not collect_cache:
        return x, layer_aux, None
    blocks = {pos: {n: torch.stack(leaves) for n, leaves in entry.items()}
              for pos, entry in caches.items()}
    return x, layer_aux, blocks


def _write_kv(entry: Dict, k, v, table, positions, page_size: int, valid=None):
    """Write k/v into one layer's pages in place (one decode token at
    ``positions [B]``, or a chunk at ``positions [B, C]`` with its ``valid``
    rows); an int8 pool (``k_scale`` present) quantizes on write."""
    pools = (entry["k"], entry["v"])
    if "k_scale" in entry:
        pools += (entry["k_scale"], entry["v_scale"])
        if valid is None:
            kvcache.paged_ring_write_quant(*pools, k, v, table, positions, page_size)
        else:
            kvcache.paged_write_tokens_quant(*pools, k, v, table, positions, valid,
                                             page_size)
    elif valid is None:
        kvcache.paged_ring_write(*pools, k, v, table, positions, page_size)
    else:
        kvcache.paged_write_tokens(*pools, k, v, table, positions, valid, page_size)


def _scales(entry: Dict) -> Dict:
    """The int8 pool's scale operands of the attention call ({} if dense)."""
    if "k_scale" not in entry:
        return {}
    return {"k_scale": entry["k_scale"], "v_scale": entry["v_scale"]}


def apply_layer_decode(
    p: Dict,
    x: torch.Tensor,  # [B, 1, d]
    spec,
    cfg,
    angles: torch.Tensor,  # [B, 1, hd/2]
    cache_entry: Dict,  # {"k", "v"}: page pools [P+1, ps, KV, hd] (+ int8
    # scales) with a page table, else dense rings [B, W, KV, hd] (+ the
    # cross cache "xk", "xv" [B, S_enc, KV, hd]); an SSM layer's {"ssm",
    # "conv_x", "conv_bc"}
    lengths: torch.Tensor,  # [B] int32
    expert_mask=None,
    page_table: Optional[torch.Tensor] = None,  # [B, pps] int32
    page_size: int = 0,
    expert_resident: Optional[Dict] = None,  # this layer's resident tables
    topo: Optional[Topology] = None,
):
    """Single-token decode layer against the paged KV cache, or with no
    ``page_table`` against dense rings (``attn.decode_attention``, masked
    by ``kvcache.ring_key_positions``), and a cross-attention layer's query
    against its cross cache (every encoder frame visible, no RoPE); an SSM
    layer steps its dense ``ssm`` / ``conv_x`` / ``conv_bc`` entry.
    Returns (x, cache_entry, aux); the cache is written in place."""
    aux: Dict[str, torch.Tensor] = {}
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.kind != "attn":
        o, (new_ssm, (new_cx, new_cbc)) = ssm.apply_ssm_decode(
            p["ssm"], h, cfg, cache_entry["ssm"],
            (cache_entry["conv_x"], cache_entry["conv_bc"]), topo=topo,
        )
        for name, new in (("ssm", new_ssm), ("conv_x", new_cx), ("conv_bc", new_cbc)):
            cache_entry[name].copy_(new)
        x = x + o
    else:
        q, k, v = attn.project_qkv(p["attn"], h, cfg, angles)
        if page_table is None:
            kc, vc = kvcache.ring_write(cache_entry["k"], cache_entry["v"], k, v, lengths)
            o = attn.decode_attention(q, kc, vc, lengths,
                                      kvcache.ring_key_positions(lengths, kc.shape[1]),
                                      window=cfg.sliding_window)
        else:
            _write_kv(cache_entry, k, v, page_table, lengths, page_size)
            o = attn.paged_decode_attention(
                q, cache_entry["k"], cache_entry["v"], page_table, lengths,
                window=cfg.sliding_window, **_scales(cache_entry),
            )
        x = x + attn.output_proj(p["attn"], o)
        if spec.cross_attn:
            x = x + _cross_attention_decode(p, x, cfg, cache_entry["xk"], cache_entry["xv"])
    if _has_ffn(spec, cfg):
        x, aux = _ffn(p, x, spec, cfg, expert_mask, expert_resident, topo=topo)
    return x, cache_entry, aux


def _cross_attention_decode(p: Dict, x: torch.Tensor, cfg, xk: torch.Tensor,
                            xv: torch.Tensor) -> torch.Tensor:
    """One decode token's cross-attention over the cross cache ``xk``/``xv``
    [B, S_enc, KV, hd]: the query sits at S_enc and the frames at 0..S_enc-1,
    so every frame is visible."""
    hx = rms_norm(x, p["norm_x"], cfg.norm_eps)
    qx = attn._project(hx, p["cross"]["wq"])
    if cfg.qk_norm:
        qx = rms_norm(qx, p["cross"]["q_norm"], cfg.norm_eps)
    B, S_enc = x.shape[0], xk.shape[1]
    enc_pos = torch.full((B,), S_enc, dtype=torch.int32, device=x.device)
    key_pos = torch.arange(S_enc, dtype=torch.int32, device=x.device)[None].expand(B, S_enc)
    ox = attn.decode_attention(qx, xk, xv, enc_pos, key_pos)
    return attn.output_proj(p["cross"], ox)


def _n_blocks(blocks: Dict) -> int:
    """Block repeats a tier's stacked params hold (a tier of a split holds
    a leading slice of them)."""
    for v in blocks.values():
        return _n_blocks(v) if isinstance(v, dict) else v.shape[0]
    return 0


def _resident(expert_resident: Optional[Dict], i: int, spec, r: int) -> Optional[Dict]:
    """Block ``r``'s resident view for MoE position ``i``: row ``r`` of
    ``tables[f"pos{i}"]`` beside the shared slab store."""
    if expert_resident is None or not spec.moe:
        return None
    tab = expert_resident["tables"][f"pos{i}"]
    return {"ids": tab["ids"][r], "slot": tab["slot"][r], "store": expert_resident["store"]}


def apply_stack_decode(params: Dict, x: torch.Tensor, cfg, angles: torch.Tensor,
                       cache_blocks: Dict, lengths: torch.Tensor, expert_mask=None,
                       *, page_table: Optional[torch.Tensor] = None, page_size: int = 0,
                       expert_resident: Optional[Dict] = None,
                       topo: Optional[Topology] = None):
    """Loop the block pattern over one decode token, over the blocks the
    params hold (a tier may hold a slice), against paged pools through
    ``page_table``, or without one against the dense caches of
    ``kvcache.init_cache``.  ``expert_resident`` (pooled end
    tier) is ``{"store": {...}, "tables": {"pos{i}": {"ids": [R, S+1],
    "slot": [R, E]}}}`` from ``core.expertpool``.  Returns (x,
    cache_blocks, the aux of every MoE layer in order: each holds the
    gate's ``topk_idx``)."""
    layer_aux: List[Dict[str, torch.Tensor]] = []
    for r in range(_n_blocks(params["blocks"])):
        bp = block_params(params["blocks"], r)
        for i, spec in enumerate(cfg.layer_pattern):
            ce = {n: leaf[r] for n, leaf in cache_blocks[f"pos{i}"].items()}
            x, _, aux = apply_layer_decode(
                bp[f"pos{i}"], x, spec, cfg, angles, ce, lengths,
                expert_mask=expert_mask, page_table=page_table, page_size=page_size,
                expert_resident=_resident(expert_resident, i, spec, r), topo=topo,
            )
            if aux:
                layer_aux.append(aux)
    return x, cache_blocks, layer_aux


def apply_stack_prefill_chunk(
    params: Dict,
    x: torch.Tensor,  # [B, C, d] one fixed-size prompt chunk
    cfg,
    angles: torch.Tensor,  # [B, C, hd/2]
    page_blocks: Dict,
    page_table: torch.Tensor,  # [B, pps]
    positions: torch.Tensor,  # [B, C] absolute position of every chunk row
    n_valid: torch.Tensor,  # [B] rows < n_valid are real, the rest padding
    page_size: int,
    expert_mask=None,
    expert_resident: Optional[Dict] = None,
    topo: Optional[Topology] = None,
):
    """Chunked prefill: each layer writes the chunk's k/v through the page
    table (padding rows to the garbage page), then attends the chunk's
    queries against the slot's mapped pages; over the blocks the params
    hold, with ``expert_resident`` as in :func:`apply_stack_decode`.
    Returns (x, page_blocks)."""
    C = x.shape[1]
    valid = torch.arange(C, device=x.device)[None, :] < n_valid[:, None]
    last_pos = (positions[:, 0] + n_valid - 1).to(torch.int32)
    positions = positions.to(torch.int32)
    for r in range(_n_blocks(params["blocks"])):
        bp = block_params(params["blocks"], r)
        for i, spec in enumerate(cfg.layer_pattern):
            p = bp[f"pos{i}"]
            ce = {n: leaf[r] for n, leaf in page_blocks[f"pos{i}"].items()}
            h = rms_norm(x, p["norm1"], cfg.norm_eps)
            q, k, v = attn.project_qkv(p["attn"], h, cfg, angles)
            _write_kv(ce, k, v, page_table, positions, page_size, valid)
            o = attn.paged_chunk_attention(
                q, ce["k"], ce["v"], page_table, positions, last_pos,
                window=cfg.sliding_window, **_scales(ce),
            )
            x = x + attn.output_proj(p["attn"], o)
            if _has_ffn(spec, cfg):
                x, _ = _ffn(p, x, spec, cfg, expert_mask,
                            _resident(expert_resident, i, spec, r), topo=topo)
    return x, page_blocks


def apply_encoder(params: Dict, frame_embeds: torch.Tensor, cfg) -> torch.Tensor:
    """The bidirectional encoder over precomputed frame embeddings
    [B, S, d] (the audio frontend is a stub, as in the reference): RoPE at
    frame positions 0..S-1, plain attention layers without causality (no
    window), then the encoder's norm."""
    B, S, _ = frame_embeds.shape
    positions = torch.arange(S, device=frame_embeds.device)[None].expand(B, S)
    angles = attn.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    enc = params["encoder"]
    spec = LayerSpec(kind="attn")
    x = frame_embeds
    for r in range(_n_blocks(enc["blocks"])):
        x, _, _ = apply_layer_full(block_params(enc["blocks"], r), x, spec, cfg, angles,
                                   causal=False)
    return rms_norm(x, enc["norm"], cfg.norm_eps)


def embed_inputs(params: Dict, cfg, tokens: torch.Tensor,
                 patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather then cast: the same values as the reference's cast-then-gather,
    without converting the whole table.  Precomputed patch embeddings
    [B, P, d] (a VLM's stubbed vision frontend) go in front of the tokens'
    rows, cast to the activation type."""
    x = params["embed"][tokens.long()].to(cfg.torch_dtype)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def lm_logits(params: Dict, cfg, x: torch.Tensor, topo: Optional[Topology] = None
              ) -> torch.Tensor:
    """The final norm and the head: logits ``[..., V]``.  With a mesh
    ``topo`` that has a model axis (training's vocabulary-sharded loss,
    ``distributed.loss``) this rank's slice of the vocabulary ``[..., V/tp]``,
    whatever the head's own layout: an ``lm_head`` handed whole is cut here
    (``collectives.split``: its gradient comes back whole), one of ``V/tp``
    columns is taken as this rank's, a tied embedding is cut by rows.  The
    head's input is alike on the model axis and each rank's gradient of it
    a share, so it passes ``collectives.fanout``."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    V, lo = cfg.padded_vocab_size, 0
    if topo is not None and topo.mesh_shape is not None and topo.model_axis is not None:
        tp, group = topo.tp_size, topo.model_group
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"].T  # [V | V/tp, d]
        if tp > 1:
            x = coll.fanout([x], group)[0]
            if head.shape[0] == V:
                head = coll.split(head, group)
        lo = topo.model_index * (V // tp)
        head = head.T
    else:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(x.dtype)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    pad = max(cfg.vocab_size - lo, 0)  # the padded columns of this slice
    if pad < logits.shape[-1]:
        logits[..., pad:] = NEG_INF
    return logits
