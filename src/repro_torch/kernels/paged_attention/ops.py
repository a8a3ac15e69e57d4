"""Paged decode / chunk attention: the CUDA kernel's wrapper and its plain
PyTorch version.

``paged_attention`` takes the models' layouts as they are: queries
``[B, C, H, hd]`` and page pools ``[P+1, ps, KV, hd]`` (row P = garbage
page).  A CPU tensor goes to :func:`paged_attention_plain`, a port of the
reference's ``kernels/paged_attention/ref.py::paged_attention_ref``; a CUDA
tensor launches ``csrc/paged_attention.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("paged_attention").paged_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    ]
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
) -> torch.Tensor:
    """Online softmax over the slot's page table, one page per step, with
    the reference's page-skip rule: a garbage-routed entry or a page with
    no visible (query, key) pair leaves the state untouched, and rows with
    no visible key come back as exact 0."""
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
    """Attention of ``q`` against the mapped pages of ``pool_k``/``pool_v``;
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, pool_k, pool_v, table, q_positions, lengths, window=window
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    B, C, H, hd = q.shape
    P1, ps, KV, hd_k = pool_k.shape
    pps = table.shape[1]
    tensors = dict(q=q, pool_k=pool_k, pool_v=pool_v, table=table,
                   q_positions=q_positions, lengths=lengths)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is not contiguous")
    if q.dtype not in _DTYPES or pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise ValueError(
            f"paged_attention: dtypes q={q.dtype} k={pool_k.dtype} "
            f"v={pool_v.dtype}; want one of float32/bfloat16 for all three"
        )
    for name in ("table", "q_positions", "lengths"):
        if tensors[name].dtype != torch.int32:
            raise ValueError(f"paged_attention: {name} must be int32")
    if (hd_k != hd or H % KV or pool_v.shape != pool_k.shape
            or table.shape != (B, pps) or q_positions.shape != (B, C)
            or lengths.shape != (B,)):
        raise ValueError(
            f"paged_attention: shapes q={tuple(q.shape)} pool={tuple(pool_k.shape)} "
            f"table={tuple(table.shape)} q_positions={tuple(q_positions.shape)} "
            f"lengths={tuple(lengths.shape)} do not agree"
        )
    if window is not None and window <= 0:
        raise ValueError(f"paged_attention: window={window}")
    out = torch.empty_like(q)
    if out.numel() == 0:  # an empty grid is no launch
        return out
    err = _launcher()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), table.data_ptr(),
        q_positions.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, C, H, KV, hd, ps, pps, P1 - 1, -1 if window is None else window,
        1.0 / (hd ** 0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
