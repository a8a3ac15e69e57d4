"""Grouped expert FFN: the CUDA kernel's wrappers and their plain PyTorch
versions.

``grouped_mlp`` computes the reference's ``core/moe.py::_grouped_mlp``:
rows ``xs [n, d]`` sorted by expert, ``group_sizes [E]`` rows each, and
``act(xs @ wi[e]) [* (xs @ wg[e])] @ wo[e]`` per run.
``grouped_mlp_resident`` computes the expert product of
``core/moe.py::moe_resident``: rows sorted by resident slot, slot ``s``
reading slab row ``ids[s]`` of the end tier's slab store (kept in the
params' type), each weight rounded to the rows' type; the last slot is the
garbage slot, whose all-zero slab gives zero rows.
``grouped_mlp_resident_quant`` is the same over an int8 store with one f32
scale per output column, each weight read as ``f32(code) * scale`` rounded
to the rows' type (``core/moe.py::moe_resident``'s int8 branch).

A CPU tensor goes to the plain version (a loop over the runs, rounding the
hidden activation to the input type as ``jax.lax.ragged_dot`` does); a
CUDA tensor launches ``csrc/expert_mlp.cu`` or raises, on the path
:func:`ffn_plan` picks from the row count: weight streaming (the hidden
activation kept in f32 on chip) for decode-sized calls and every f32 call,
a grouped GEMM on the tensor cores for bf16 rows at prefill sizes.

For training, :class:`GroupedMLPFn` wraps ``grouped_mlp``: the forward is
the same kernel; the backward is per-group ``torch.matmul`` (the
reference has no backward of its own: XLA differentiates its
``ragged_dot`` trio).  ``grouped_mlp`` enters it only when grad mode is on
and an input requires a gradient.  The resident forms stay forward-only:
the end tier does not train.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.models.layers import ACTIVATION_GRADS, ACTIVATIONS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2  # the weight type code of an int8 store
_ACTS = {"silu": 0, "gelu": 1, "relu": 2}
HIDDEN_TILE = 32  # hidden columns a tile of the streaming path (kTile)
MMA_MIN_ROWS = 64  # rows from which bf16 calls take the tensor cores (one row tile)
SCRATCH_FLOATS = 1 << 22  # the streaming path's partial sums: at most 16 MB


def ffn_plan(n: int, d: int, f: int, dtype: torch.dtype) -> Tuple[str, int]:
    """The kernel's path for ``n`` rows of ``dtype`` and its split count.

    ``("mma", 1)``: bf16 rows, ``n >= MMA_MIN_ROWS`` and d, f multiples of
    8 -- the grouped GEMM on the tensor cores.  ``("stream", S)`` otherwise
    (every f32 call: exact on the CUDA cores): weight streaming with the
    hidden dimension's ``ceil(f / 64)`` tiles split over ``S`` blocks a
    routed group, one tile each while the ``[S, n, d]`` f32 partials stay
    under ``SCRATCH_FLOATS``.  The plan depends on the call's shape alone,
    so a row routed to the same expert gets the same bits through
    :func:`grouped_mlp` and :func:`grouped_mlp_resident`."""
    if dtype == torch.bfloat16 and n >= MMA_MIN_ROWS and d % 8 == 0 and f % 8 == 0:
        return "mma", 1
    tiles = -(-f // HIDDEN_TILE)
    return "stream", max(1, min(tiles, SCRATCH_FLOATS // max(1, n * d)))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("expert_mlp").expert_mlp_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
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
    the CUDA kernel for CUDA tensors; through :class:`GroupedMLPFn` when a
    gradient is wanted.  Rows past ``sum(group_sizes)`` come back 0; the
    kernel reads no row past ``n`` whatever the group sizes (which live on
    the device and are not checked on the host)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xs, wi, wg, wo)):
        return GroupedMLPFn.apply(xs, group_sizes, wi, wg, wo, act)
    return _grouped_mlp(xs, group_sizes, wi, wg, wo, act)


def _grouped_mlp(xs, group_sizes, wi, wg, wo, act):
    if xs.device.type == "cpu":
        return grouped_mlp_plain(xs, group_sizes, wi, wg, wo, act)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_mlp: unsupported device {xs.device}")
    weights = dict(wi=wi, wo=wo) if wg is None else dict(wi=wi, wg=wg, wo=wo)
    _check("grouped_mlp", xs, group_sizes, weights, act, wi.shape[0])
    if xs.dtype not in _DTYPES or any(t.dtype != xs.dtype for t in weights.values()):
        raise ValueError(
            "grouped_mlp: xs and the weights must share one dtype of "
            f"float32/bfloat16, got xs={xs.dtype} "
            + " ".join(f"{k}={t.dtype}" for k, t in weights.items())
        )
    _check_shapes("grouped_mlp", xs, wi, wg, wo)
    y = _launch(xs, group_sizes, None, wi, wg, wo, act, zero_group=-1)
    if xs.shape[0]:
        grouped_mlp.launches += 1
    return y


def _check(what: str, xs, group_sizes, tensors, act, G: int):
    for name, t in dict(xs=xs, group_sizes=group_sizes, **tensors).items():
        if t.device != xs.device:
            raise ValueError(f"{what}: {name} on {t.device}, xs on {xs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (G,):
        raise ValueError(
            f"{what}: group_sizes must be int32 [{G}], got "
            f"{group_sizes.dtype} {tuple(group_sizes.shape)}"
        )
    if act not in _ACTS:
        raise ValueError(f"{what}: unknown activation {act!r}")


def _check_shapes(what: str, xs, wi, wg, wo):
    n, d = xs.shape
    N, d_w, f = wi.shape
    if (d_w != d or wo.shape != (N, f, d)
            or (wg is not None and wg.shape != wi.shape)):
        raise ValueError(
            f"{what}: shapes xs={tuple(xs.shape)} wi={tuple(wi.shape)} "
            f"wo={tuple(wo.shape)} do not agree"
        )


def _launch(xs, group_sizes, ids, wi, wg, wo, act, *, zero_group: int, scales=None):
    """Launch ``csrc/expert_mlp.cu`` on checked operands (``scales``: the
    int8 store's ``(wi, wg, wo)`` column scales) on the path of
    :func:`ffn_plan`; no launch for zero rows (an empty grid)."""
    n, d = xs.shape
    f = wi.shape[2]
    y = torch.empty_like(xs)
    if n == 0:
        return y
    path, splits = ffn_plan(n, d, f, xs.dtype)
    if path == "mma":  # the hidden activation, bf16, written once
        scratch = torch.empty((n, f), dtype=torch.bfloat16, device=xs.device)
    else:  # each split's partial y, f32
        scratch = torch.empty((splits, n, d), dtype=torch.float32, device=xs.device)
    operands = [xs, wi, wo, scratch] + [t for t in (wg, *(scales or ())) if t is not None]
    vec = d % 8 == 0 and f % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in operands)
    err = _launcher()(
        xs.data_ptr(), group_sizes.data_ptr(),
        None if ids is None else ids.data_ptr(), wi.data_ptr(),
        None if wg is None else wg.data_ptr(), wo.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (scales or (None,) * 3)),
        scratch.data_ptr(), y.data_ptr(), n, d, f, group_sizes.shape[0],
        _ACTS[act], _DTYPES[xs.dtype], _INT8 if scales else _DTYPES[wi.dtype], zero_group,
        int(path == "mma"), splits, int(vec), torch.cuda.current_stream(xs.device).cuda_stream,
    )
    build.check_launch(err, "expert_mlp")
    return y


grouped_mlp.launches = 0


class GroupedMLPFn(torch.autograd.Function):
    """The grouped expert FFN with an explicit backward, per expert group
    (rows ``xs_e`` of group e, upstream ``dY_e``):

    - recompute ``H = xs_e·Wi``, and ``G = xs_e·Wg`` where the FFN is gated;
      ``A = act(H)``, times ``G`` where gated;
    - ``dA = dY_e·Woᵀ``, ``dWo = Aᵀ·dY_e``;
    - ``dH = dA ⊙ act'(H)``, times ``G`` where gated, and ``dG = dA ⊙
      act(H)``, elementwise in f32 and rounded to the rows' type;
    - ``dWi = xs_eᵀ·dH``, ``dWg = xs_eᵀ·dG``, ``dxs_e = dH·Wiᵀ + dG·Wgᵀ``.

    The products are ``torch.matmul`` in the rows' type over the group
    segments (as XLA computes the reference's ``ragged_dot`` gradients
    outside any kernel), and the gradients come back in the weights' type;
    an empty group gets zero weight gradients."""

    @staticmethod
    def forward(ctx, xs, group_sizes, wi, wg, wo, act):
        ctx.save_for_backward(xs, group_sizes, wi, wg, wo)
        ctx.act = act
        return _grouped_mlp(xs, group_sizes, wi, wg, wo, act)

    @staticmethod
    def backward(ctx, dy):
        xs, group_sizes, wi, wg, wo = ctx.saved_tensors
        a, a_grad = ACTIVATIONS[ctx.act], ACTIVATION_GRADS[ctx.act]
        dt = xs.dtype
        dy = dy.to(dt)
        dxs = torch.zeros_like(xs)
        dwi, dwo = torch.zeros_like(wi), torch.zeros_like(wo)
        dwg = None if wg is None else torch.zeros_like(wg)
        start = 0
        # one host read of the group sizes a layer's backward: the products
        # run over host-side slices of the sorted rows
        for e, cnt in enumerate(group_sizes.tolist()):
            if cnt:
                x, dy_e = xs[start : start + cnt], dy[start : start + cnt]
                h = x @ wi[e]
                act_h = a(h)
                g = None if wg is None else x @ wg[e]
                dwo[e] = ((act_h if g is None else act_h * g).T @ dy_e).to(dwo.dtype)
                da = (dy_e @ wo[e].T).float()
                dh = da * a_grad(h.float())
                if g is not None:
                    dh = dh * g.float()
                    dg = (da * act_h.float()).to(dt)
                    dwg[e] = (x.T @ dg).to(dwg.dtype)
                dh = dh.to(dt)
                dwi[e] = (x.T @ dh).to(dwi.dtype)
                dx = dh @ wi[e].T
                if g is not None:
                    dx = dx + dg @ wg[e].T
                dxs[start : start + cnt] = dx
            start += cnt
        return dxs, None, dwi, dwg, dwo, None


def grouped_mlp_resident_plain(
    xs: torch.Tensor,  # [n, d] sorted by resident slot
    group_sizes: torch.Tensor,  # [S+1] int32 (slot S = the garbage slot)
    store_wi: torch.Tensor,  # [N+1, d, f] slab store (row N = zero garbage slab)
    store_wg: Optional[torch.Tensor],
    store_wo: torch.Tensor,  # [N+1, f, d]
    ids: torch.Tensor,  # [S+1] int32 slab row of each slot
    act: str,
) -> torch.Tensor:
    """Gather the slots' slabs, cast them to the rows' type, and run the
    grouped product over the slot-sorted rows."""
    idx = ids.long()
    gather = lambda w: None if w is None else w[idx].to(xs.dtype)  # noqa: E731
    return grouped_mlp_plain(
        xs, group_sizes, gather(store_wi), gather(store_wg), gather(store_wo), act
    )


def _resident(what, xs, group_sizes, store_wi, store_wg, store_wo, ids, act, scales=None):
    """Check and launch the resident kernel on CUDA tensors: a store in
    float32 or the rows' type, or (``scales``: the ``wi``/``wg``/``wo``
    column scales) int8 codes with float32 scales."""
    if xs.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {xs.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xs, store_wi, store_wg, store_wo)):
        raise NotImplementedError(
            f"{what}: the resident kernel has no backward (the end tier serves; "
            "training runs moe_sorted's grouped_mlp)")
    store = dict(store_wi=store_wi, store_wo=store_wo)
    if store_wg is not None:
        store["store_wg"] = store_wg
    named = {}
    if scales is not None:
        named = dict(wi_scale=scales[0], wo_scale=scales[2])
        if store_wg is not None:
            if scales[1] is None:
                raise ValueError(f"{what}: a gated int8 store needs wg_scale")
            named["wg_scale"] = scales[1]
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"{what}: ids must be int32 [S+1], got {ids.dtype} {tuple(ids.shape)}")
    G = ids.shape[0]
    _check(what, xs, group_sizes, dict(ids=ids, **store, **named), act, G)
    wdt = store_wi.dtype
    if scales is None:
        ok = wdt in (torch.float32, xs.dtype) and all(t.dtype == wdt for t in store.values())
        want = "one store dtype, float32 or the rows' own"
    else:
        ok = (all(t.dtype == torch.int8 for t in store.values())
              and all(t.dtype == torch.float32 for t in named.values()))
        want = "an int8 store and float32 scales"
    if xs.dtype not in _DTYPES or not ok:
        raise ValueError(
            f"{what}: rows float32/bfloat16 and {want}, got xs={xs.dtype} "
            + " ".join(f"{k}={t.dtype}" for k, t in {**store, **named}.items())
        )
    _check_shapes(what, xs, store_wi, store_wg, store_wo)
    N1, d, f = store_wi.shape
    shapes = dict(wi_scale=(N1, f), wg_scale=(N1, f), wo_scale=(N1, d))
    if any(tuple(t.shape) != shapes[k] for k, t in named.items()):
        raise ValueError(f"{what}: scales " + " ".join(
            f"{k}={tuple(t.shape)}" for k, t in named.items()) + f", want {shapes}")
    return _launch(xs, group_sizes, ids, store_wi, store_wg, store_wo, act,
                   zero_group=G - 1, scales=scales)


def grouped_mlp_resident(
    xs: torch.Tensor,
    group_sizes: torch.Tensor,
    store_wi: torch.Tensor,
    store_wg: Optional[torch.Tensor],
    store_wo: torch.Tensor,
    ids: torch.Tensor,
    act: str,
) -> torch.Tensor:
    """Expert FFN over rows sorted by resident slot, each slot reading its
    slab of the store in place (no gathered copy); plain version for CPU
    tensors, the CUDA kernel for CUDA tensors.  Rows of the last slot (the
    garbage slot) come back 0 without a weight read, as from the zero
    garbage slab."""
    if xs.device.type == "cpu":
        return grouped_mlp_resident_plain(
            xs, group_sizes, store_wi, store_wg, store_wo, ids, act
        )
    y = _resident("grouped_mlp_resident", xs, group_sizes, store_wi, store_wg, store_wo,
                  ids, act)
    if xs.shape[0]:
        grouped_mlp_resident.launches += 1
    return y


grouped_mlp_resident.launches = 0


def grouped_mlp_resident_quant_plain(
    xs: torch.Tensor,  # [n, d] sorted by resident slot
    group_sizes: torch.Tensor,  # [S+1] int32
    store_wi: torch.Tensor,  # [N+1, d, f] int8
    store_wg: Optional[torch.Tensor],
    store_wo: torch.Tensor,  # [N+1, f, d] int8
    ids: torch.Tensor,  # [S+1] int32
    act: str,
    *,
    wi_scale: torch.Tensor,  # [N+1, f] f32 per output column
    wg_scale: Optional[torch.Tensor],
    wo_scale: torch.Tensor,  # [N+1, d]
) -> torch.Tensor:
    """Gather the slots' int8 slabs, dequantize them in f32 with their
    column scales, cast to the rows' type, and run the grouped product."""
    idx = ids.long()

    def deq(w, s):
        return None if w is None else (w[idx].float() * s[idx][:, None, :]).to(xs.dtype)

    return grouped_mlp_plain(xs, group_sizes, deq(store_wi, wi_scale),
                             deq(store_wg, wg_scale), deq(store_wo, wo_scale), act)


def grouped_mlp_resident_quant(
    xs: torch.Tensor,
    group_sizes: torch.Tensor,
    store_wi: torch.Tensor,
    store_wg: Optional[torch.Tensor],
    store_wo: torch.Tensor,
    ids: torch.Tensor,
    act: str,
    *,
    wi_scale: torch.Tensor,
    wg_scale: Optional[torch.Tensor],
    wo_scale: torch.Tensor,
) -> torch.Tensor:
    """:func:`grouped_mlp_resident` over an int8 slab store with f32 scales
    per output column (the reference's ``_kernel_resident_quant``); plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if xs.device.type == "cpu":
        return grouped_mlp_resident_quant_plain(
            xs, group_sizes, store_wi, store_wg, store_wo, ids, act,
            wi_scale=wi_scale, wg_scale=wg_scale, wo_scale=wo_scale,
        )
    y = _resident("grouped_mlp_resident_quant", xs, group_sizes, store_wi, store_wg,
                  store_wo, ids, act, scales=(wi_scale, wg_scale, wo_scale))
    if xs.shape[0]:
        grouped_mlp_resident_quant.launches += 1
    return y


grouped_mlp_resident_quant.launches = 0
