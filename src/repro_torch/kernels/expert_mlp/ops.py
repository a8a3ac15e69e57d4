"""Grouped expert FFN: the CUDA kernel's wrapper and its plain PyTorch
version.

``grouped_mlp`` computes the reference's ``core/moe.py::_grouped_mlp``:
rows ``xs [n, d]`` sorted by expert, ``group_sizes [E]`` rows each, and
``act(xs @ wi[e]) [* (xs @ wg[e])] @ wo[e]`` per run.  A CPU tensor goes to
:func:`grouped_mlp_plain` (a loop over the runs, rounding the hidden
activation to the input type as ``jax.lax.ragged_dot`` does); a CUDA tensor
launches ``csrc/expert_mlp.cu`` (hidden tile kept in f32 on chip) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import ACTIVATIONS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"silu": 0, "gelu": 1, "relu": 2}
HIDDEN_TILE = 64  # hidden columns per block (kTile in csrc/expert_mlp.cu)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("expert_mlp").expert_mlp_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def grouped_mlp_plain(
    xs: torch.Tensor,  # [n, d] sorted by expert
    group_sizes: torch.Tensor,  # [E] int32
    wi: torch.Tensor,  # [E, d, f]
    wg: Optional[torch.Tensor],  # [E, d, f] | None
    wo: torch.Tensor,  # [E, f, d]
    act: str,
) -> torch.Tensor:
    a = ACTIVATIONS[act]
    y = torch.zeros_like(xs)
    start = 0
    for e, cnt in enumerate(group_sizes.tolist()):
        if cnt:
            x = xs[start : start + cnt]
            h = x @ wi[e]
            h = a(h) * (x @ wg[e]) if wg is not None else a(h)
            y[start : start + cnt] = h @ wo[e]
        start += cnt
    return y


def grouped_mlp(
    xs: torch.Tensor,
    group_sizes: torch.Tensor,
    wi: torch.Tensor,
    wg: Optional[torch.Tensor],
    wo: torch.Tensor,
    act: str,
) -> torch.Tensor:
    """Expert FFN over expert-sorted rows; plain version for CPU tensors,
    the CUDA kernel for CUDA tensors.  Rows past ``sum(group_sizes)`` come
    back 0; the kernel reads no row past ``n`` whatever the group sizes
    (which live on the device and are not checked on the host)."""
    if xs.device.type == "cpu":
        return grouped_mlp_plain(xs, group_sizes, wi, wg, wo, act)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_mlp: unsupported device {xs.device}")
    n, d = xs.shape
    E, d_w, f = wi.shape
    weights = dict(wi=wi, wo=wo) if wg is None else dict(wi=wi, wg=wg, wo=wo)
    for name, t in dict(xs=xs, group_sizes=group_sizes, **weights).items():
        if t.device != xs.device:
            raise ValueError(f"grouped_mlp: {name} on {t.device}, xs on {xs.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_mlp: {name} is not contiguous")
    if xs.dtype not in _DTYPES or any(t.dtype != xs.dtype for t in weights.values()):
        raise ValueError(
            "grouped_mlp: xs and the weights must share one dtype of "
            f"float32/bfloat16, got xs={xs.dtype} "
            + " ".join(f"{k}={t.dtype}" for k, t in weights.items())
        )
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (E,):
        raise ValueError(
            f"grouped_mlp: group_sizes must be int32 [{E}], got "
            f"{group_sizes.dtype} {tuple(group_sizes.shape)}"
        )
    if (d_w != d or wo.shape != (E, f, d)
            or (wg is not None and wg.shape != wi.shape)):
        raise ValueError(
            f"grouped_mlp: shapes xs={tuple(xs.shape)} wi={tuple(wi.shape)} "
            f"wo={tuple(wo.shape)} do not agree"
        )
    if act not in _ACTS:
        raise ValueError(f"grouped_mlp: unknown activation {act!r}")
    y = torch.empty_like(xs)
    if n == 0:
        return y
    partial = torch.empty(
        (-(-f // HIDDEN_TILE), n, d), dtype=torch.float32, device=xs.device
    )
    err = _launcher()(
        xs.data_ptr(), group_sizes.data_ptr(), wi.data_ptr(),
        None if wg is None else wg.data_ptr(), wo.data_ptr(),
        partial.data_ptr(), y.data_ptr(), n, d, f, E, _ACTS[act],
        _DTYPES[xs.dtype], torch.cuda.current_stream(xs.device).cuda_stream,
    )
    build.check_launch(err, "grouped_mlp")
    grouped_mlp.launches += 1
    return y


grouped_mlp.launches = 0
