"""Attention: GQA projections, RoPE, full-sequence flash attention,
attention straight off the KV page pool, and one decode token against a
dense ring (port of the reference's ``models/attention.py``: the parts the
serving engines, the one-shot end-cloud pipeline and training run, and the
O(S²) and dense-ring chunk oracles)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention_fwd
from repro_torch.kernels.flash_attention.ops import NEG_INF, fill_rows_without_a_key
from repro_torch.kernels.flash_attention.ops import block_mask as _block_mask
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_quant
from repro_torch.models.layers import rms_norm, truncated_normal_init


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """positions [B, S] (RoPE) or [B, 3, S] (M-RoPE) -> angles
    [B, S, head_dim // 2] (f32).  Under M-RoPE the half dimension is cut into
    the (temporal, height, width) ``mrope_sections``, each rotated by its own
    component of the positions; [B, 3, S] positions without sections take
    component 0."""
    half = head_dim // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    )
    if mrope_sections is None:
        if positions.dim() == 3:
            positions = positions[:, 0]
        return positions[..., None].float() * freqs
    if positions.dim() != 3:
        raise ValueError(f"M-RoPE needs [B, 3, S] positions, got {tuple(positions.shape)}")
    if sum(mrope_sections) != half:
        raise ValueError(f"M-RoPE sections {mrope_sections} do not sum to head_dim // 2 = {half}")
    parts, lo = [], 0
    for c, sec in enumerate(mrope_sections):
        parts.append(positions[:, c, :, None].float() * freqs[lo:lo + sec])
        lo += sec
    return torch.cat(parts, dim=-1)


def model_angles(cfg, positions: torch.Tensor) -> torch.Tensor:
    """The model's rotary angles at token positions [B, S]: under M-RoPE the
    same position on all three axes (text), as the reference's decode and
    chunk steps broadcast it."""
    if cfg.mrope_sections is not None and positions.dim() == 2:
        positions = positions[:, None].expand(-1, 3, -1)
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [B, S, n, head_dim]; angles [B, S, head_dim // 2]."""
    dtype = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    return torch.cat((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1).to(dtype)


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full-sequence (prefill-style) GQA attention in the models' layout:
    online softmax over kv tiles with causal / window tile skipping
    (``kernels.flash_attention``, the CUDA kernel on the card).  Query row i
    sits at position ``q_offset + i``; keys at 0..Skv-1.

    A row that sees no key gets the mean of V over every key, as in the
    reference consumer (every key masked to -1e30 leaves a uniform
    softmax); the kernel returns 0 there, so those rows, which follow from
    the positions alone, are filled after it.  When a gradient is wanted
    (grad mode on and an input that requires one) the call goes through
    ``FlashAttentionFn``, whose backward is the backward kernel; otherwise
    (every serving path) no autograd graph is built."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    out = flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return fill_rows_without_a_key(out, v, causal, window, q_offset)


def reference_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """O(S²)-memory oracle used by tests: one f32 softmax over every key."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    qr = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqgnd,bkgd->bqgnk", qr.float(), k.float()) * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = _block_mask(qpos, kpos, causal, window)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqgnk,bkgd->bqgnd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_cache: torch.Tensor,  # [B, S, KV, hd] dense ring
    v_cache: torch.Tensor,
    q_positions: torch.Tensor,  # [B] position of the query token
    key_positions: torch.Tensor,  # [B, S] position each ring slot holds
    window: Optional[int] = None,
) -> torch.Tensor:
    """One query token against a dense ring (speculative decode's draft
    cache, the dense-ring engine's caches) or an encoder-decoder's cross
    cache, in plain PyTorch as the reference computes it (``jnp``, no
    Pallas body): scores in f32, keys that hold a position past the query,
    outside the window or below 0 (slots never written) masked to -1e30,
    the softmax's p rounded to the cache type for the value product."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, hd)
    s = torch.einsum("bgnd,bkgd->bgnk", qr.float(), k_cache.float()) * (1.0 / hd ** 0.5)
    qp = q_positions.long()[:, None]
    kp = key_positions.long()
    valid = (kp <= qp) & (kp >= 0)
    if window is not None:
        valid &= kp > qp - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bgnk,bkgd->bgnd", p.float(), v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def chunk_attention(
    q: torch.Tensor,  # [B, C, H, hd] one prefill chunk of queries
    k_cache: torch.Tensor,  # [B, S, KV, hd] dense ring (pages gathered)
    v_cache: torch.Tensor,
    q_positions: torch.Tensor,  # [B, C] absolute position of each query
    key_positions: torch.Tensor,  # [B, S] position each ring slot holds
    window: Optional[int] = None,
) -> torch.Tensor:
    """C queries against a dense ring that already holds the chunk's own
    k/v, in plain PyTorch as the reference computes it: per-query causal
    masking over absolute positions (C = 1 is :func:`decode_attention`),
    scores in f32, p rounded to the cache type for the value product.  The
    oracle the paged chunk attention is held to; no engine path runs it."""
    B, C, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qr = q.reshape(B, C, KV, G, hd)
    s = torch.einsum("bcgnd,bkgd->bcgnk", qr.float(), k_cache.float()) * (1.0 / hd ** 0.5)
    qp = q_positions.long()[:, :, None]
    kp = key_positions.long()[:, None, :]
    valid = (kp <= qp) & (kp >= 0)  # [B, C, S]
    if window is not None:
        valid &= kp > qp - window
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    o = torch.einsum("bcgnk,bkgd->bcgnd", p.float(), v_cache.float())
    return o.reshape(B, C, H, hd).to(q.dtype)


def paged_chunk_attention(
    q: torch.Tensor,  # [B, C, H, hd]
    pool_k: torch.Tensor,  # [P+1, ps, KV, hd] (row P = garbage)
    pool_v: torch.Tensor,
    table: torch.Tensor,  # [B, pps] int32
    q_positions: torch.Tensor,  # [B, C] int32
    lengths: torch.Tensor,  # [B] int32 ring anchor (last written position)
    *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [P+1, ps] f16 (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C queries per slot against the slot's mapped pages: page lookup,
    ring-position masking and online softmax in one sweep, with no dense
    ring view (``kernels.paged_attention``).  With ``k_scale``/``v_scale``
    the pools hold int8 codes, dequantized page by page in registers."""
    if k_scale is not None:
        return paged_attention_quant(
            q, pool_k, pool_v, k_scale, v_scale, table, q_positions, lengths,
            window=window,
        )
    return paged_attention(
        q, pool_k, pool_v, table, q_positions, lengths, window=window
    )


def paged_decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    table: torch.Tensor,
    lengths: torch.Tensor,  # [B] position of the just-written token
    *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token decode: the C = 1 case of :func:`paged_chunk_attention`
    (the query sits at ``lengths``, which is also the ring anchor)."""
    return paged_chunk_attention(
        q, pool_k, pool_v, table, lengths[:, None], lengths, window=window,
        k_scale=k_scale, v_scale=v_scale,
    )


def init_attention(generator: torch.Generator, cfg, dtype: torch.dtype,
                   lead: Tuple[int, ...] = ()) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": truncated_normal_init(generator, (d, H * hd), dtype, 1.0, lead).reshape(*lead, d, H, hd),
        "wk": truncated_normal_init(generator, (d, KV * hd), dtype, 1.0, lead).reshape(*lead, d, KV, hd),
        "wv": truncated_normal_init(generator, (d, KV * hd), dtype, 1.0, lead).reshape(*lead, d, KV, hd),
        "wo": truncated_normal_init(generator, (H * hd, d), dtype, 1.0, lead).reshape(*lead, H, hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(lead + (hd,), dtype=dtype, device=generator.device)
        p["k_norm"] = torch.zeros(lead + (hd,), dtype=dtype, device=generator.device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] @ w [d, n, hd] -> [B, S, n, hd]."""
    d, n, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, n * hd)).view(*x.shape[:-1], n, hd)


def project_qkv(params: Dict, x: torch.Tensor, cfg, angles: Optional[torch.Tensor]):
    """x [B, S, d] -> q [B, S, H, hd], k, v [B, S, KV, hd] (rope and qk-norm
    applied)."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if angles is not None:
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    return q, k, v


def output_proj(params: Dict, o: torch.Tensor) -> torch.Tensor:
    """o [B, S, H, hd] @ wo [H, hd, d] -> [B, S, d]."""
    H, hd, d = params["wo"].shape
    return o.reshape(*o.shape[:-2], H * hd) @ params["wo"].to(o.dtype).reshape(H * hd, d)
