"""GQA flash attention, causal or not: the CUDA kernels' wrappers (forward
and backward), their plain PyTorch versions, and the autograd Function
that joins them for training.

``flash_attention_fwd`` takes the models' layout as it is: queries
``[B, Sq, H, hd]``, keys and values ``[B, Skv, KV, hd]`` (H a multiple of
KV), and returns ``[B, Sq, H, hd]``.  Query row i sits at absolute position
``q_offset + i``, key j at j; j is visible iff ``(not causal or qp >= j)``
and ``(window is None or qp - j < window)``.  A CPU tensor goes to
:func:`flash_attention_plain`, an online softmax over kv tiles of the
kernel's size with the consumer's numerics (``attention._flash_fwd_inner``
of the reference); a CUDA tensor launches ``csrc/flash_attention.cu`` or
raises.  Any Sq and Skv are taken.  With ``return_lse`` the forward also
returns each row's log-sum-exp ``[B, H, Sq]`` (f32), which the backward
reads.

``flash_attention_bwd`` computes dQ, dK and dV from the forward's output
and log-sum-exp: :func:`flash_attention_bwd_plain` for CPU tensors (the
reference's ``make_flash_attention._bwd``, kv tile by kv tile with its
roundings), ``csrc/flash_attention_bwd.cu`` for CUDA tensors.
:class:`FlashAttentionFn` runs the forward, fills the rows that see no key
(:func:`fill_rows_without_a_key`) and saves what the backward needs.
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    ]
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    fn = build.load("flash_attention_bwd").flash_attention_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
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
    return_lse: bool = False,
):
    """Online softmax over kv tiles of ``BLOCK_KV`` keys: scores are dots
    in f32 of the inputs' values, masked scores -1e30, p rounded to V's
    type before p·V while l sums the unrounded p.  A masked key adds p = 0,
    so rows with no visible key come back as exact 0 (the l == 0 guard),
    and their log-sum-exp is m = -1e30.  With ``return_lse``: (out, lse
    [B, H, Sq] f32)."""
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
    out = (acc / l_safe[..., None]).reshape(B, Sq, H, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l_safe)).reshape(B, Sq, H).transpose(1, 2).contiguous()
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Full-sequence GQA attention in the ``[B, S, heads, hd]`` layout; the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors.  With
    ``return_lse``: (out, lse [B, H, Sq] f32)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    build.refuse_grad("flash_attention_fwd (FlashAttentionFn has its backward)", q, k, v)
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
    # every row's log-sum-exp is written by the kernel (-1e30 where it sees no key)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:  # an empty grid is no launch
        return (out, lse) if return_lse else out
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, Sq, Skv, H, KV, hd, q_offset, int(causal),
        -1 if window is None else window, 1.0 / (hd ** 0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def rows_without_a_key(Sq: int, Skv: int, causal: bool, window: Optional[int],
                       q_offset: int):
    """Query-row ranges ``[lo, hi)`` that see no key: row i sits at
    ``p = q_offset + i`` and sees key j in [0, Skv) iff ``(not causal or
    p >= j)`` and ``(window is None or p - j < window)``."""
    if Skv == 0:
        return [(0, Sq)] if Sq else []
    ranges = []
    if causal and q_offset < 0:  # p < 0 sees no key
        ranges.append((0, min(Sq, -q_offset)))
    if window is not None:  # p - (Skv - 1) >= window: the window lies past every key
        lo = max(0, Skv - 1 + window - q_offset)
        if lo < Sq:
            ranges.append((lo, Sq))
    return [(lo, hi) for lo, hi in ranges if lo < hi]


def fill_rows_without_a_key(out: torch.Tensor, v: torch.Tensor, causal: bool,
                            window: Optional[int], q_offset: int) -> torch.Tensor:
    """Give the rows that see no key (0 from the kernel and the plain
    version) the mean of V over every key, in place: the reference consumer
    masks every key to -1e30, which leaves a uniform softmax."""
    B, Sq, H, _ = out.shape
    for lo, hi in rows_without_a_key(Sq, v.shape[1], causal, window, q_offset):
        mean_v = v.float().mean(dim=1).repeat_interleave(H // v.shape[2], dim=1)
        out[:, lo:hi] = mean_v.to(out.dtype)[:, None]
    return out


def flash_attention_bwd_plain(
    dout: torch.Tensor,  # [B, Sq, H, hd]
    q: torch.Tensor,  # [B, Sq, H, hd]
    k: torch.Tensor,  # [B, Skv, KV, hd]
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output (rows without a key filled)
    lse: torch.Tensor,  # [B, H, Sq] f32
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
):
    """The reference's ``_bwd`` kv tile by kv tile: ``delta = rowsum(dO·O)``
    and dO in f32, P recomputed as ``exp(s - lse)`` from the masked f32
    scores (-1e30), ``dS = P (dP - delta) scale``; dQ sums dS rounded to
    K's type times K, dV the f32 P times dO, dK the f32 dS times Q in f32;
    each is returned in its input's type.  A row that sees no key has
    lse = -1e30 and so P = 1 on every key, as in ``_bwd``."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    do_f = dout.float()
    delta = (do_f * out.float()).sum(dim=-1).reshape(B, Sq, KV, G)
    qr = q.reshape(B, Sq, KV, G, hd).float()
    dor = do_f.reshape(B, Sq, KV, G, hd)
    lse_r = lse.transpose(1, 2).reshape(B, Sq, KV, G)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    dq = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, Skv, KV, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for k0 in range(0, Skv, BLOCK_KV):
        kb = k[:, k0 : k0 + BLOCK_KV].float()
        vb = v[:, k0 : k0 + BLOCK_KV].float()
        kpos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
        vis = block_mask(qpos, kpos, causal, window)[None, :, None, None, :]
        s = torch.where(vis, torch.einsum("bqgnd,bkgd->bqgnk", qr, kb) * scale, NEG_INF)
        p = torch.exp(s - lse_r[..., None])
        dp = torch.einsum("bqgnd,bkgd->bqgnk", dor, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bqgnk,bkgd->bqgnd", ds.to(k.dtype).float(), kb)
        dv[:, k0 : k0 + kb.shape[1]] = torch.einsum("bqgnk,bqgnd->bkgd", p, dor)
        dk[:, k0 : k0 + kb.shape[1]] = torch.einsum("bqgnk,bqgnd->bkgd", ds, qr)
    return dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _blind_rows_grads(dout, q, k, v, out, rows, scale):
    """The terms of the query rows ``rows`` that see no key, which ``_bwd``
    gives P = 1 on every key (the kernel gives them P = 0): (dQ of those
    rows, their dK and dV terms in f32)."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    n = rows.shape[0]
    dor = dout[:, rows].float().reshape(B, n, KV, G, hd)
    delta = (dor * out[:, rows].float().reshape(B, n, KV, G, hd)).sum(dim=-1)
    ds = (torch.einsum("bqgnd,bkgd->bqgnk", dor, v.float()) - delta[..., None]) * scale
    dq = torch.einsum("bqgnk,bkgd->bqgnd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bqgnk,bqgnd->bkgd", ds,
                      q[:, rows].float().reshape(B, n, KV, G, hd))
    dv = dor.sum(dim=(1, 3))[:, None].expand(B, k.shape[1], KV, hd)
    return dq.reshape(B, n, H, hd), dk, dv


def flash_attention_bwd(
    dout: torch.Tensor,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
):
    """(dq, dk, dv) of the flash forward: the plain version for CPU
    tensors, ``csrc/flash_attention_bwd.cu`` (two launches, counted as one
    call) for CUDA tensors, and the terms of rows that see no key added
    here after it."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(dout, q, k, v, out, lse, causal=causal,
                                         window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    build.refuse_grad("flash_attention_bwd", dout, q, k, v, out)
    B, Sq, H, hd = q.shape
    _, Skv, KV, hd_k = k.shape
    for name, t in dict(dout=dout, q=q, k=k, v=v, out=out, lse=lse).items():
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} is not contiguous")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, out, dout)):
        raise ValueError(
            "flash_attention_bwd: q, k, v, out and dout must share one dtype of "
            f"float32/bfloat16, got q={q.dtype} k={k.dtype} v={v.dtype} out={out.dtype} "
            f"dout={dout.dtype}"
        )
    if (k.shape[0] != B or hd_k != hd or H % KV or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape
            or lse.shape != (B, H, Sq) or lse.dtype != torch.float32):
        raise ValueError(
            f"flash_attention_bwd: shapes q={tuple(q.shape)} k={tuple(k.shape)} "
            f"v={tuple(v.shape)} out={tuple(out.shape)} dout={tuple(dout.shape)} "
            f"lse={tuple(lse.shape)} {lse.dtype} do not agree"
        )
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {hd} not in {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_bwd: window={window}")
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    if q.numel() and k.numel():
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        err = _bwd_launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Sq, Skv, H, KV, hd, q_offset, int(causal), -1 if window is None else window,
            1.0 / (hd ** 0.5), _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
        )
        build.check_launch(err, "flash_attention_bwd")
        flash_attention_bwd.launches += 1
    else:
        dq.zero_()
    ranges = rows_without_a_key(Sq, Skv, causal, window, q_offset)
    if ranges and Skv:
        rows = torch.cat([torch.arange(lo, hi, device=q.device) for lo, hi in ranges])
        bq, bk, bv = _blind_rows_grads(dout, q, k, v, out, rows, 1.0 / (hd ** 0.5))
        dq[:, rows] = bq.to(dq.dtype)
        dk = (dk.float() + bk).to(k.dtype)
        dv = (dv.float() + bv).to(v.dtype)
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the backward kernel: the forward kernel (which
    also returns the log-sum-exp), the rows that see no key filled inside
    the forward (so the output the backward saves is the one returned),
    and :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, return_lse=True)
        fill_rows_without_a_key(out, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.opts
        dq, dk, dv = flash_attention_bwd(dout.contiguous(), q, k, v, out, lse, causal=causal,
                                         window=window, q_offset=q_offset)
        return dq, dk, dv, None, None, None
