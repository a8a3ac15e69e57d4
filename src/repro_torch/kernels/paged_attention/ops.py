"""Paged decode / chunk attention: the CUDA kernel's wrapper and its plain
PyTorch version.

``paged_attention`` takes the models' layouts as they are: queries
``[B, C, H, hd]`` and page pools ``[P+1, ps, KV, hd]`` (row P = garbage
page).  ``paged_attention_quant`` takes int8 pools with their per-token f16
scales ``[P+1, ps]`` and dequantizes each fetched page in registers.  A CPU
tensor goes to :func:`paged_attention_plain`, a port of the reference's
``kernels/paged_attention/ref.py::paged_attention_ref`` (scales included); a
CUDA tensor launches ``csrc/paged_attention.cu`` or raises.  The kernel
splits each slot's page sweep over :func:`split_plan` blocks and merges
their partial softmax states in a second launch; bf16 pools with 16 or more
query rows a kv head run on the tensor cores (:func:`uses_tensor_cores`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's instantiations; 120 (h2o-danube-3-4b) is computed at a width
# of 128 over rows of stride 120 (csrc/paged_attention.cu), with no copy here
HEAD_DIMS = (32, 64, 120, 128)
SPLIT_TARGET_BLOCKS = 264  # two blocks on each of the H100's 132 SMs


def split_plan(B: int, KV: int, pps: int) -> int:
    """Blocks each (slot, kv head) page sweep is split over: enough for
    ``B * KV`` sweeps to fill ``SPLIT_TARGET_BLOCKS``, at most one a table
    entry.  Split ``s`` of ``S`` takes the entries ``s, s + S, ...``.  The
    lengths live on the device, so the plan cannot count live pages."""
    return max(1, min(pps, -(-SPLIT_TARGET_BLOCKS // max(1, B * KV))))


def uses_tensor_cores(dtype: torch.dtype, quantized: bool, rows: int, ps: int) -> bool:
    """The kernel's tensor-core body takes bf16 pools with at least 16 query
    rows a kv head (``rows = C * G``) and pages of a multiple of 16 tokens;
    f32 and int8 pools, and fewer rows, stay on the CUDA cores."""
    return dtype == torch.bfloat16 and not quantized and rows >= 16 and ps % 16 == 0


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("paged_attention").paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def paged_attention_plain(
    q: torch.Tensor,  # [B, C, H, hd]
    pool_k: torch.Tensor,  # [P+1, ps, KV, hd]
    pool_v: torch.Tensor,
    table: torch.Tensor,  # [B, pps] int32
    q_positions: torch.Tensor,  # [B, C] int32
    lengths: torch.Tensor,  # [B] int32 ring anchor
    *,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [P+1, ps] f16 (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Online softmax over the slot's page table, one page per step, with
    the reference's page-skip rule: a garbage-routed entry or a page with
    no visible (query, key) pair leaves the state untouched, and rows with
    no visible key come back as exact 0.  With ``k_scale``/``v_scale`` the
    pools hold int8 codes and each fetched page is dequantized to f32."""
    B, C, H, hd = q.shape
    ps, KV = pool_k.shape[1], pool_k.shape[2]
    pps = table.shape[1]
    W = pps * ps
    G = H // KV
    garbage = pool_k.shape[0] - 1
    scale = 1.0 / (hd ** 0.5)
    qr = q.reshape(B, C, KV, G, hd)
    ln = lengths.long()[:, None]  # [B, 1]
    qpos = q_positions.long()
    tab = table.long()
    m = torch.full((B, C, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, C, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, C, KV, G, hd), dtype=torch.float32, device=q.device)
    offs = torch.arange(ps, device=q.device)[None, :]
    for e in range(pps):
        phys = tab[:, e]
        k_page = pool_k[phys]  # [B, ps, KV, hd]
        v_page = pool_v[phys]
        if k_scale is not None:
            k_page = k_page.float() * k_scale[phys].float()[:, :, None, None]
            v_page = v_page.float() * v_scale[phys].float()[:, :, None, None]
        kp = ln - torch.remainder(ln - (e * ps + offs), W)  # [B, ps]
        valid = kp[:, None, :] <= qpos[:, :, None]  # [B, C, ps]
        if window is not None:
            valid &= kp[:, None, :] > qpos[:, :, None] - window
        valid &= kp[:, None, :] >= 0
        live = (phys != garbage) & valid.any(dim=2).any(dim=1)  # [B]
        s = torch.einsum(
            "bcgnd,bkgd->bcgnk", qr.float(), k_page.float()
        ) * scale  # [B, C, KV, G, ps]
        s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        pv = torch.einsum(
            "bcgnk,bkgd->bcgnd", p.to(v_page.dtype).float(), v_page.float()
        )
        keep = live[:, None, None, None]
        m = torch.where(keep, m_new, m)
        l = torch.where(keep, l * corr + p.sum(dim=-1), l)
        acc = torch.where(keep[..., None], acc * corr[..., None] + pv, acc)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = acc / l_safe[..., None]
    return out.reshape(B, C, H, hd).to(q.dtype)


def _check(what, q, pool_k, pool_v, table, q_positions, lengths, window, **scales):
    B, C, H, hd = q.shape
    P1, ps, KV, hd_k = pool_k.shape
    pps = table.shape[1]
    tensors = dict(q=q, pool_k=pool_k, pool_v=pool_v, table=table,
                   q_positions=q_positions, lengths=lengths, **scales)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    for name in ("table", "q_positions", "lengths"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"{what}: {name} must be int32")
    if (hd_k != hd or H % KV or pool_v.shape != pool_k.shape
            or table.shape != (B, pps) or q_positions.shape != (B, C)
            or lengths.shape != (B,)
            or any(t.shape != (P1, ps) for t in scales.values())):
        raise ValueError(
            f"{what}: shapes q={tuple(q.shape)} pool={tuple(pool_k.shape)} "
            f"table={tuple(table.shape)} q_positions={tuple(q_positions.shape)} "
            f"lengths={tuple(lengths.shape)} "
            + " ".join(f"{k}={tuple(t.shape)}" for k, t in scales.items())
            + " do not agree"
        )
    if window is not None and window <= 0:
        raise ValueError(f"{what}: window={window}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd}; the kernel takes {HEAD_DIMS}")
    for name in ("q", "pool_k", "pool_v"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def _launch(q, pool_k, pool_v, k_scale, v_scale, table, q_positions, lengths, window,
            splits: Optional[int] = None):
    """Launch ``csrc/paged_attention.cu`` on checked operands; ``splits``
    overrides :func:`split_plan` (the card tests sweep it)."""
    B, C, H, hd = q.shape
    P1, ps, KV, _ = pool_k.shape
    pps = table.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:  # an empty grid is no launch
        return out
    S = split_plan(B, KV, pps) if splits is None else splits
    if not 1 <= S <= pps:
        raise ValueError(f"paged_attention: splits={S} outside [1, {pps}]")
    ws = None
    if S > 1:  # each block's partial (m, l, acc) in f32
        ws = torch.empty(B * C * H * S * (hd + 2), dtype=torch.float32, device=q.device)
    mma = uses_tensor_cores(pool_k.dtype, k_scale is not None, C * (H // KV), ps)
    err = _launcher()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(), table.data_ptr(),
        q_positions.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        B, C, H, KV, hd, ps, pps, P1 - 1, -1 if window is None else window,
        1.0 / (hd ** 0.5), _DTYPES[q.dtype], int(k_scale is not None), S, int(mma),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(err, "paged_attention")
    return out


def paged_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    table: torch.Tensor,
    q_positions: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Attention of ``q`` against the mapped pages of ``pool_k``/``pool_v``
    (in q's type); the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, pool_k, pool_v, table, q_positions, lengths, window=window
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    _check("paged_attention", q, pool_k, pool_v, table, q_positions, lengths, window)
    build.refuse_grad("paged_attention", q, pool_k, pool_v)
    if q.dtype not in _DTYPES or pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise ValueError(
            f"paged_attention: dtypes q={q.dtype} k={pool_k.dtype} "
            f"v={pool_v.dtype}; want one of float32/bfloat16 for all three"
        )
    out = _launch(q, pool_k, pool_v, None, None, table, q_positions, lengths, window)
    if out.numel():
        paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_attention_quant(
    q: torch.Tensor,
    pool_k: torch.Tensor,  # [P+1, ps, KV, hd] int8
    pool_v: torch.Tensor,
    k_scale: torch.Tensor,  # [P+1, ps] f16
    v_scale: torch.Tensor,
    table: torch.Tensor,
    q_positions: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """:func:`paged_attention` over int8 pools with one f16 scale per token
    (the reference's ``_pa_kernel_quant``): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, pool_k, pool_v, table, q_positions, lengths, window=window,
            k_scale=k_scale, v_scale=v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_quant: unsupported device {q.device}")
    _check("paged_attention_quant", q, pool_k, pool_v, table, q_positions, lengths,
           window, k_scale=k_scale, v_scale=v_scale)
    build.refuse_grad("paged_attention_quant", q, k_scale, v_scale)
    if (q.dtype not in _DTYPES or pool_k.dtype != torch.int8 or pool_v.dtype != torch.int8
            or k_scale.dtype != torch.float16 or v_scale.dtype != torch.float16):
        raise ValueError(
            f"paged_attention_quant: dtypes q={q.dtype} k={pool_k.dtype} "
            f"v={pool_v.dtype} k_scale={k_scale.dtype} v_scale={v_scale.dtype}; want "
            "q float32/bfloat16, int8 pools, float16 scales"
        )
    out = _launch(q, pool_k, pool_v, k_scale, v_scale, table, q_positions, lengths, window)
    if out.numel():
        paged_attention_quant.launches += 1
    return out


paged_attention_quant.launches = 0
