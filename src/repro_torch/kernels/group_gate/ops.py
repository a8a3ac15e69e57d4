"""HL-GGN group gate (eq. 5-7): the Triton kernel's wrapper and its plain
PyTorch version.

Replaces the reference's ``kernels/group_gate/kernel.py::group_gate_pallas``
(``_gate_kernel``).  Per token: local logits ``x @ w_local + b_local (+
additive mask)`` go through a softmax within each group (eq. 5); global
logits ``x @ w_global + b_global``, with groups whose experts are all
masked set to -1e30, go through a softmax over groups (eq. 6); the product
gives ``probs [T, E]`` (eq. 7).  Outputs are f32, as the router math is.

What bounds it on the H100: bytes, and a small grid.  The work is a skinny
product ``[T, d] x [d, E + K]`` (E + K = 12 for switch-base) followed by two
segmented softmaxes: about 2*(E+K) flops for each 2-byte element of x,
nowhere near the tensor cores' ridge.  The kernel reads x once and the
(L2-resident) gate weights once a block, keeps the logits in registers, and
writes only the probabilities -- the [T, E] logits never reach HBM.  It
reads ``w_local`` in the parameters' own ``[K, d, Mk]`` layout (column
``e = k*Mk + m`` sits at ``k*d*Mk + m``), so no relayout runs per call.
The f32 products are broadcast multiply-and-sum over k-blocks: exact f32
arithmetic, where ``tl.dot`` on f32 would drop to TF32 by default.

The kernel takes one ``[E]`` mask shared by all tokens; a per-token
``[T, E]`` mask runs only in the plain version (CPU), and a CUDA call with
one raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
BLOCK_TOKENS = 16
BLOCK_K = 32


def gate_logits(
    x: torch.Tensor,  # [T, d]
    w_local: torch.Tensor,  # [K, d, Mk]
    b_local: torch.Tensor,  # [K, Mk]
    w_global: torch.Tensor,  # [d, K]
    b_global: torch.Tensor,  # [K]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-mask logits in f32: (local [T, K, Mk], global [T, K])."""
    xf = x.float()
    local = torch.einsum("td,kdm->tkm", xf, w_local.float()) + b_local.float()[None]
    glob = xf @ w_global.float() + b_global.float()
    return local, glob


def group_gate_plain(
    x: torch.Tensor,  # [T, d]
    w_local: torch.Tensor,  # [K, d, Mk]
    b_local: torch.Tensor,  # [K, Mk]
    w_global: torch.Tensor,  # [d, K]
    b_global: torch.Tensor,  # [K]
    expert_mask: Optional[torch.Tensor] = None,  # bool [E] or [T, E]
) -> Tuple[torch.Tensor, torch.Tensor]:
    K, d, Mk = w_local.shape
    T = x.shape[0]
    local, glob = gate_logits(x, w_local, b_local, w_global, b_global)
    if expert_mask is not None:
        em = (expert_mask.reshape(-1, K, Mk) if expert_mask.dim() == 2
              else expert_mask.reshape(1, K, Mk))
        local = torch.where(em, local, NEG_INF)
        glob = torch.where(em.any(dim=-1), glob, NEG_INF)  # dead groups
    p_local = torch.softmax(local, dim=-1)
    p_group = torch.softmax(glob, dim=-1)
    probs = (p_group[:, :, None] * p_local).reshape(T, K * Mk)
    return probs, p_group


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def gate_kernel(x_ptr, wl_ptr, bl_ptr, wg_ptr, bg_ptr, mask_ptr,
                    probs_ptr, pg_ptr, T, d,
                    E: tl.constexpr, K: tl.constexpr, MK: tl.constexpr,
                    NE: tl.constexpr, NK: tl.constexpr, BT: tl.constexpr,
                    BK: tl.constexpr, HAS_MASK: tl.constexpr):
        rows = tl.program_id(0) * BT + tl.arange(0, BT)
        row_ok = rows < T
        cols = tl.arange(0, NE)
        col_ok = cols < E
        grp = cols // MK
        gcols = tl.arange(0, NK)
        g_ok = gcols < K
        wl_col = grp * d * MK + cols % MK  # column e of w_local [K, d, MK]
        acc_l = tl.zeros((BT, NE), tl.float32)
        acc_g = tl.zeros((BT, NK), tl.float32)
        for k0 in range(0, d, BK):
            ks = k0 + tl.arange(0, BK)
            k_ok = ks < d
            x = tl.load(x_ptr + rows[:, None] * d + ks[None, :],
                        mask=row_ok[:, None] & k_ok[None, :], other=0.0).to(tl.float32)
            wl = tl.load(wl_ptr + ks[:, None] * MK + wl_col[None, :],
                         mask=k_ok[:, None] & col_ok[None, :], other=0.0)
            wg = tl.load(wg_ptr + ks[:, None] * K + gcols[None, :],
                         mask=k_ok[:, None] & g_ok[None, :], other=0.0)
            acc_l += tl.sum(x[:, :, None] * wl[None, :, :], axis=1)
            acc_g += tl.sum(x[:, :, None] * wg[None, :, :], axis=1)

        neg_inf = -3.0e38  # below any logit, and exp() of it is 0
        local = acc_l + tl.load(bl_ptr + cols, mask=col_ok, other=0.0)[None, :]
        glob = acc_g + tl.load(bg_ptr + gcols, mask=g_ok, other=0.0)[None, :]
        if HAS_MASK:
            mask = tl.load(mask_ptr + cols, mask=col_ok, other=0.0)  # additive
            local += mask[None, :]
            dead = tl.zeros((NK,), tl.int1)
            for g in tl.static_range(K):
                mmax = tl.max(tl.where(grp == g, mask, neg_inf), axis=0)
                dead = tl.where(gcols == g, mmax <= -5.0e29, dead)  # NEG_INF / 2
            glob = tl.where(dead[None, :], -1.0e30, glob)  # NEG_INF
        local = tl.where(col_ok[None, :], local, neg_inf)
        glob = tl.where(g_ok[None, :], glob, neg_inf)

        # eq. 5: softmax within each group
        lmax = tl.zeros((BT, NE), tl.float32)
        for g in tl.static_range(K):
            in_g = (grp == g)[None, :]
            lmax = tl.where(in_g, tl.max(tl.where(in_g, local, neg_inf), axis=1)[:, None], lmax)
        lexp = tl.exp(local - lmax)
        lsum = tl.full((BT, NE), 1.0, tl.float32)
        for g in tl.static_range(K):
            in_g = (grp == g)[None, :]
            lsum = tl.where(in_g, tl.sum(tl.where(in_g, lexp, 0.0), axis=1)[:, None], lsum)
        p_local = tl.where(col_ok[None, :], lexp / lsum, 0.0)

        # eq. 6: softmax over groups
        gmax = tl.max(glob, axis=1)
        gexp = tl.exp(glob - gmax[:, None])
        p_group = gexp / tl.sum(gexp, axis=1)[:, None]

        # eq. 7: probs[:, e] = p_group[:, e // MK] * p_local[:, e]
        pg_col = tl.zeros((BT, NE), tl.float32)
        for g in tl.static_range(K):
            pg = tl.sum(tl.where(gcols[None, :] == g, p_group, 0.0), axis=1)
            pg_col = tl.where((grp == g)[None, :], pg[:, None], pg_col)
        tl.store(probs_ptr + rows[:, None] * E + cols[None, :], pg_col * p_local,
                 mask=row_ok[:, None] & col_ok[None, :])
        tl.store(pg_ptr + rows[:, None] * K + gcols[None, :], p_group,
                 mask=row_ok[:, None] & g_ok[None, :])

    return gate_kernel


def group_gate(
    x: torch.Tensor,
    w_local: torch.Tensor,
    b_local: torch.Tensor,
    w_global: torch.Tensor,
    b_global: torch.Tensor,
    expert_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused eq. 5-7 -> (probs [T, E], p_group [T, K]), f32; the plain
    version for CPU tensors, the Triton kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return group_gate_plain(x, w_local, b_local, w_global, b_global, expert_mask)
    if x.device.type != "cuda":
        raise ValueError(f"group_gate: unsupported device {x.device}")
    T, d = x.shape
    K, d_w, Mk = w_local.shape
    E = K * Mk
    params = dict(w_local=w_local, b_local=b_local, w_global=w_global, b_global=b_global)
    for name, t in dict(x=x, **params).items():
        if t.device != x.device:
            raise ValueError(f"group_gate: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"group_gate: {name} is not contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"group_gate: x dtype {x.dtype}")
    for name, t in params.items():
        if t.dtype != torch.float32:
            raise ValueError(f"group_gate: {name} must be float32, got {t.dtype}")
    if (d_w != d or b_local.shape != (K, Mk) or w_global.shape != (d, K)
            or b_global.shape != (K,)):
        raise ValueError(
            f"group_gate: shapes x={tuple(x.shape)} w_local={tuple(w_local.shape)} "
            f"w_global={tuple(w_global.shape)} do not agree"
        )
    mask = None
    if expert_mask is not None:
        if expert_mask.shape != (E,):
            raise ValueError(
                f"group_gate: the kernel takes one [E] = [{E}] expert mask for "
                f"all tokens, got shape {tuple(expert_mask.shape)}"
            )
        if expert_mask.device != x.device or expert_mask.dtype != torch.bool:
            raise ValueError("group_gate: expert_mask must be a bool tensor on x's device")
        mask = torch.where(expert_mask, 0.0, NEG_INF).float()
    probs = torch.empty((T, E), dtype=torch.float32, device=x.device)
    p_group = torch.empty((T, K), dtype=torch.float32, device=x.device)
    if T == 0:
        return probs, p_group
    kernel = _triton_kernel()
    kernel[(-(-T // BLOCK_TOKENS),)](
        x, w_local, b_local, w_global, b_global,
        mask if mask is not None else probs,  # unread without a mask
        probs, p_group, T, d,
        E=E, K=K, MK=Mk, NE=max(2, 1 << (E - 1).bit_length()),
        NK=max(2, 1 << (K - 1).bit_length()), BT=BLOCK_TOKENS, BK=BLOCK_K,
        HAS_MASK=mask is not None, num_warps=4,
    )
    group_gate.launches += 1
    return probs, p_group


group_gate.launches = 0
