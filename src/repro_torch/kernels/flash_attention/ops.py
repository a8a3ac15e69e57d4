"""GQA flash-attention forward, causal or not: the CUDA kernel's wrapper
and its plain PyTorch version.

``flash_attention_fwd`` takes the models' layout as it is: queries
``[B, Sq, H, hd]``, keys and values ``[B, Skv, KV, hd]`` (H a multiple of
KV), and returns ``[B, Sq, H, hd]``.  Query row i sits at absolute position
``q_offset + i``, key j at j; j is visible iff ``(not causal or qp >= j)``
and ``(window is None or qp - j < window)``.  A CPU tensor goes to
:func:`flash_attention_plain`, an online softmax over kv tiles of the
kernel's size with the consumer's numerics (``attention._flash_fwd_inner``
of the reference); a CUDA tensor launches ``csrc/flash_attention.cu`` or
raises.  Any Sq and Skv are taken.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
BLOCK_KV = 64  # keys per kv tile (kBK in csrc/flash_attention.cu)
# the kernel's instantiations; 120 (h2o-danube-3-4b) is computed at a width
# of 128 over rows of stride 120 (csrc/flash_attention.cu), with no copy here
HEAD_DIMS = (32, 64, 120, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    ]
    return fn


def block_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """qpos [Sq], kpos [Sk] -> bool [Sq, Sk] (True = attend); the
    reference's ``attention._block_mask``."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def flash_attention_plain(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online softmax over kv tiles of ``BLOCK_KV`` keys: scores are dots
    in f32 of the inputs' values, masked scores -1e30, p rounded to V's
    type before p·V while l sums the unrounded p.  A masked key adds p = 0,
    so rows with no visible key come back as exact 0 (the l == 0 guard)."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    qr = q.reshape(B, Sq, KV, G, hd).float()
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32, device=q.device)
    for k0 in range(0, Skv, BLOCK_KV):
        kb = k[:, k0 : k0 + BLOCK_KV]
        vb = v[:, k0 : k0 + BLOCK_KV]
        kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
        vis = block_mask(qpos, kpos, causal, window)[None, :, None, None, :]
        s = torch.einsum("bqgnd,bkgd->bqgnk", qr, kb.float()) * scale
        s = torch.where(vis, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqgnk,bkgd->bqgnd", p.to(v.dtype).float(), vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full-sequence GQA attention in the ``[B, S, heads, hd]`` layout; the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    _, Skv, KV, hd_k = k.shape
    for name, t in dict(q=q, k=k, v=v).items():
        if t.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} is not contiguous")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention_fwd: dtypes q={q.dtype} k={k.dtype} v={v.dtype}; "
            "want one of float32/bfloat16 for all three"
        )
    if (k.shape[0] != B or hd_k != hd or H % KV or v.shape != k.shape):
        raise ValueError(
            f"flash_attention_fwd: shapes q={tuple(q.shape)} k={tuple(k.shape)} "
            f"v={tuple(v.shape)} do not agree"
        )
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} not in {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_fwd: window={window}")
    out = torch.empty_like(q)
    if out.numel() == 0:  # an empty grid is no launch
        return out
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KV, hd, q_offset, int(causal),
        -1 if window is None else window, 1.0 / (hd ** 0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
