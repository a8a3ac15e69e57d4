"""HL-GGN group gate (eq. 5-7): the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the reference's ``kernels/group_gate/kernel.py::group_gate_pallas``
(``_gate_kernel``).  Per token: local logits ``x @ w_local + b_local``,
masked experts set to -1e30, go through a softmax within each group (eq.
5); global logits ``x @ w_global + b_global``, with groups whose experts are
all masked set to -1e30, go through a softmax over groups (eq. 6); the
product gives ``probs [T, E]`` (eq. 7).  Outputs are f32, as the router
math is.

On the card ``csrc/group_gate.cu`` computes it in one launch: d split over
a block's threads (neighbouring threads on neighbouring elements), a token
(or a tile of tokens at large T) a block, the parameters read in their own
layouts (``w_local [K, d, Mk]``, ``w_global
[d, K]``), the ``[E]`` bool mask read as given; past 16 experts or 8
groups (qwen3-moe's 128 in 16) the wide form, a block for each of a
token's groups (its columns and the global ones), a warp a column set
over a slice of d; see the source for what bounds it.  A per-token ``[T, E]`` mask runs only in the plain version
(CPU), and a CUDA call with one raises.

For training, :class:`GroupGateFn` wraps the call: the forward is the same
kernel, the backward (the reference has none of its own: XLA
differentiates its ``jnp`` gate) goes back through eq. 7 and the two
softmaxes in PyTorch ops, in f32.  :func:`group_gate` enters it only when
grad mode is on and an input requires a gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_EXPERTS, MAX_GROUPS = 16, 8  # the kernel's register forms' bounds on E and K
# the wide form's (a block a token's group, a warp a set of columns over a
# slice of d): E and K up to these, Mk and K powers of two (qwen3-moe: 128
# in 16)
WIDE_EXPERTS, WIDE_GROUPS, WIDE_THREADS = 256, 32, 512
_XDTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
def _lib():
    lib = build.load("group_gate")
    lib.group_gate_launch.restype = ctypes.c_int
    lib.group_gate_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    return lib


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def wide(K: int, Mk: int) -> bool:
    """More experts or groups than the register forms hold (the wide form)."""
    return K * Mk > MAX_EXPERTS or K > MAX_GROUPS


def launch_plan(T: int, d: int, K: int, Mk: int,
                w_ptrs=(0, 0)) -> Tuple[int, int, int, int]:
    """(form, tokens a block, threads a block, deep) of a call.  Form 1 and 2
    are switch-base's (K, Mk) = (4, 2) and llama4-scout's (4, 4) with vector
    weight loads (both weight pointers ``w_ptrs`` 16-byte aligned), 0 any
    other shape up to 16 experts in 8 groups one float at a time: one token
    a block up to 256 tokens (T blocks side by side), then tiles of a
    multiple of 4 tokens (about 256 blocks); a thread for every element of
    d, 32 to 512 (256 for tiles); the loop over d unrolled four deep
    (``deep``) only where a thread takes more than two elements.  Form 3,
    the wide form, past 16 experts or 8 groups: a block of 512 threads for
    each of a token's K groups."""
    if wide(K, Mk):
        return 3, 1, WIDE_THREADS, 0
    form = {(4, 2): 1, (4, 4): 2}.get((K, Mk), 0) if all(p % 16 == 0 for p in w_ptrs) else 0
    rows = 1 if T <= 256 else 4 * -(-T // 1024)
    threads = min(512 if rows == 1 else 256, max(32, -(-d // 32) * 32))
    return form, rows, threads, int(d > 2 * threads)


def group_gate(
    x: torch.Tensor,
    w_local: torch.Tensor,
    b_local: torch.Tensor,
    w_global: torch.Tensor,
    b_global: torch.Tensor,
    expert_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused eq. 5-7 -> (probs [T, E], p_group [T, K]), f32; the plain
    version for CPU tensors, ``csrc/group_gate.cu`` for CUDA tensors;
    through :class:`GroupGateFn` when a gradient is wanted."""
    ins = (x, w_local, b_local, w_global, b_global)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return GroupGateFn.apply(*ins, expert_mask)
    return _group_gate(*ins, expert_mask)


def _group_gate(x, w_local, b_local, w_global, b_global, expert_mask):
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
    if x.dtype not in _XDTYPES:
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
    if wide(K, Mk) and (E > WIDE_EXPERTS or K > WIDE_GROUPS or Mk > 32
                        or not (_pow2(K) and _pow2(Mk))):
        raise ValueError(f"group_gate: the kernel takes E <= {WIDE_EXPERTS} experts in "
                         f"K <= {WIDE_GROUPS} groups (past {MAX_EXPERTS} in {MAX_GROUPS}, "
                         f"K and Mk powers of two), got E={E}, K={K}, Mk={Mk}")
    if expert_mask is not None:
        if expert_mask.shape != (E,):
            raise ValueError(
                f"group_gate: the kernel takes one [E] = [{E}] expert mask for "
                f"all tokens, got shape {tuple(expert_mask.shape)}"
            )
        if (expert_mask.device != x.device or expert_mask.dtype != torch.bool
                or not expert_mask.is_contiguous()):
            raise ValueError("group_gate: expert_mask must be a contiguous bool tensor on "
                             "x's device")
    probs = torch.empty((T, E), dtype=torch.float32, device=x.device)
    p_group = torch.empty((T, K), dtype=torch.float32, device=x.device)
    if T == 0:  # an empty grid is no launch
        return probs, p_group
    form, rows, threads, deep = launch_plan(T, d, K, Mk,
                                            (w_local.data_ptr(), w_global.data_ptr()))
    err = _lib().group_gate_launch(
        x.data_ptr(), w_local.data_ptr(), b_local.data_ptr(), w_global.data_ptr(),
        b_global.data_ptr(), None if expert_mask is None else expert_mask.data_ptr(),
        probs.data_ptr(), p_group.data_ptr(), T, d, K, Mk, _XDTYPES[x.dtype], form, rows,
        threads, deep, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check_launch(err, "group_gate")
    group_gate.launches += 1
    return probs, p_group


group_gate.launches = 0


class GroupGateFn(torch.autograd.Function):
    """The gate with an explicit backward through eq. 5-7.  With
    ``probs = p_group ⊗ p_local`` (eq. 7), the upstream gradients split
    into ``d p_local = d probs · p_group`` and ``d p_group = Σ_m d probs ·
    p_local`` (plus the gradient of the ``p_group`` output); each goes back
    through its softmax's Jacobian, ``p (dp - Σ dp p)``.  The logits are
    recomputed from :func:`gate_logits` and masked as the forward masks
    them; masked experts and dead groups get zero gradient.  Then ``dx``,
    ``dW_local`` and ``dW_global`` are products and the bias gradients
    sums, all in f32: ``dx`` goes back in x's type, the weight gradients
    stay f32 like the gate's parameters."""

    @staticmethod
    def forward(ctx, x, w_local, b_local, w_global, b_global, expert_mask):
        probs, p_group = _group_gate(x, w_local, b_local, w_global, b_global, expert_mask)
        ctx.save_for_backward(x, w_local, b_local, w_global, b_global, expert_mask)
        return probs, p_group

    @staticmethod
    def backward(ctx, d_probs, d_pgroup):
        x, w_local, b_local, w_global, b_global, expert_mask = ctx.saved_tensors
        K, d, Mk = w_local.shape
        T = x.shape[0]
        local, glob = gate_logits(x, w_local, b_local, w_global, b_global)
        em = group_ok = None
        if expert_mask is not None:
            em = (expert_mask.reshape(-1, K, Mk) if expert_mask.dim() == 2
                  else expert_mask.reshape(1, K, Mk))
            group_ok = em.any(dim=-1)
            local = torch.where(em, local, NEG_INF)
            glob = torch.where(group_ok, glob, NEG_INF)
        p_local = torch.softmax(local, dim=-1)  # [T, K, Mk]
        p_group = torch.softmax(glob, dim=-1)  # [T, K]
        dp = (torch.zeros((T, K, Mk), dtype=torch.float32, device=x.device) if d_probs is None
              else d_probs.float().reshape(T, K, Mk))
        d_local = dp * p_group[:, :, None]
        d_group = (dp * p_local).sum(dim=-1)
        if d_pgroup is not None:
            d_group = d_group + d_pgroup.float()
        d_local = p_local * (d_local - (d_local * p_local).sum(dim=-1, keepdim=True))
        d_glob = p_group * (d_group - (d_group * p_group).sum(dim=-1, keepdim=True))
        if em is not None:
            d_local = torch.where(em, d_local, 0.0)
            d_glob = torch.where(group_ok, d_glob, 0.0)
        xf = x.float()
        dx = (torch.einsum("tkm,kdm->td", d_local, w_local.float())
              + d_glob @ w_global.float().T)
        return (dx.to(x.dtype), torch.einsum("td,tkm->kdm", xf, d_local).to(w_local.dtype),
                d_local.sum(dim=0).to(b_local.dtype), (xf.T @ d_glob).to(w_global.dtype),
                d_glob.sum(dim=0).to(b_global.dtype), None)
