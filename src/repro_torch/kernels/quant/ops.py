"""Symmetric int8 quantization of lines: the CUDA kernel's wrappers and
their plain PyTorch versions.

``quantize_rows`` computes the reference's ``kernels/quant/ref.py::
quantize_rows_ref`` in its int8 mode, and with it the jnp quantizers of the
reference's consumers (KV tokens, the boundary payload, expert slabs): per
line ``s = max(amax / 127, 1e-8)`` rounded to ``scale_dtype`` *before* the
divide, ``q = clip(round(x / s), -127, 127)``.  With an f16 scale the floor
underflows to 0 for lines whose amax is below ~3.8e-6; then ``x / 0`` clips
to +-127 and ``0 / 0`` is code 0, as the reference's convert gives.
``dequantize_rows`` is ``q * s`` in f32, cast to the output type.  (The
reference's fp8 mode has no kernel and no consumer and is not ported.)

The line is the last axis (``axis=-1``, one scale per row) or the one
before it (``axis=-2``, one scale per column: the slab store's scale per
output column); the scale keeps the reduced axis with size 1.  The column
form splits the reduced axis over a thread-block cluster (:func:`cols_plan`).
A CPU tensor goes to the plain version; a CUDA tensor launches
``csrc/quant.cu`` or raises.  ``paged_write_quant`` quantizes a layer's k
and v tokens straight into the int8 KV pools' page slots in one launch, for
CUDA tensors only: its plain version is
``models.kvcache.paged_write_quant_plain``, and the kvcache writers route
between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

SCALE_FLOOR = 1e-8  # all-zero lines: the divide stays finite, the codes 0
_XDTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SDTYPES = {torch.float32: 0, torch.float16: 1}
COL_TILE_BYTES = 128  # a column block's tile: 8 threads x 16 bytes of a row
MAX_CLUSTER = 8  # the portable thread-block cluster size
STAGE_BYTES = 96 * 1024  # a column block keeps its slice in shared memory up to this


def cols_plan(outer: int, n: int, inner: int, itemsize: int, sms: int) -> Tuple[int, bool]:
    """``(cluster, staged)`` of the column form on ``[outer, n, inner]``
    (``itemsize``-byte values, a card of ``sms`` SMs): each block takes a
    128-byte tile of neighbouring columns and ``ceil(n / cluster)`` rows;
    the cluster (1, 2, 4 or 8 blocks) doubles until the grid holds two
    blocks an SM or the slice fits in ``STAGE_BYTES``, whichever needs more,
    and the slice stays in shared memory (``staged``) where it fits."""
    tiles = -(-inner * itemsize // COL_TILE_BYTES)
    cluster = 1
    while cluster < MAX_CLUSTER and (tiles * outer * cluster < 2 * sms
                                     or -(-n // cluster) * COL_TILE_BYTES > STAGE_BYTES):
        cluster *= 2
    return cluster, -(-n // cluster) * COL_TILE_BYTES <= STAGE_BYTES


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("quant")
    lib.quantize_launch.restype = ctypes.c_int
    lib.quantize_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.dequantize_launch.restype = ctypes.c_int
    lib.dequantize_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.paged_write_quant_launch.restype = ctypes.c_int
    lib.paged_write_quant_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return lib


def quantize_rows_plain(x: torch.Tensor, *, scale_dtype: torch.dtype = torch.float32,
                        axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, one ulp off the IEEE quotient the reference takes
    scale = torch.clamp_min(amax / amax.new_tensor(127.0), SCALE_FLOOR).to(scale_dtype)
    q = torch.round(xf / scale.float()).clamp(-127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), scale


def quantize_rows(x: torch.Tensor, *, scale_dtype: torch.dtype = torch.float32,
                  axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 like x, scale scale_dtype)`` over the lines of ``axis``
    (-1 or -2); the plain version for CPU tensors, the kernel for CUDA."""
    if axis not in (-1, -2) or x.dim() < -axis:
        raise ValueError(f"quantize_rows: axis={axis} of a {x.dim()}-d tensor")
    if x.device.type == "cpu":
        return quantize_rows_plain(x, scale_dtype=scale_dtype, axis=axis)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    build.refuse_grad("quantize_rows", x)
    if not x.is_contiguous():
        raise ValueError("quantize_rows: x is not contiguous")
    if x.dtype not in _XDTYPES or scale_dtype not in _SDTYPES:
        raise ValueError(f"quantize_rows: x {x.dtype} (want float32/bfloat16), "
                         f"scale {scale_dtype} (want float32/float16)")
    sshape = list(x.shape)
    sshape[axis] = 1
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(sshape, dtype=scale_dtype, device=x.device)
    if x.numel() == 0:  # an empty grid is no launch
        return q, scale
    n = x.shape[axis]
    inner = 1 if axis == -1 else x.shape[-1]
    outer = x.numel() // (n * inner)
    cluster, staged = (1, False) if axis == -1 else cols_plan(
        outer, n, inner, x.element_size(), _sms(x.device.index or 0))
    err = _lib().quantize_launch(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), outer, n, inner, cluster, int(staged),
        _XDTYPES[x.dtype], _SDTYPES[scale_dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check_launch(err, "quantize_rows")
    quantize_rows.launches += 1
    return q, scale


quantize_rows.launches = 0


def dequantize_rows_plain(q: torch.Tensor, scale: torch.Tensor, *,
                          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, *,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``q [..., n] int8`` times its row scale ``[..., 1]``, in ``dtype``;
    the plain version for CPU tensors, the kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return dequantize_rows_plain(q, scale, dtype=dtype)
    if q.device.type != "cuda":
        raise ValueError(f"dequantize_rows: unsupported device {q.device}")
    build.refuse_grad("dequantize_rows", scale)
    if scale.device != q.device or not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequantize_rows: q and scale must be contiguous on one device")
    if (q.dtype != torch.int8 or scale.dtype not in _SDTYPES or dtype not in _XDTYPES
            or q.dim() < 1 or tuple(scale.shape) != (*q.shape[:-1], 1)):
        raise ValueError(
            f"dequantize_rows: q {q.dtype} {tuple(q.shape)} (want int8), scale "
            f"{scale.dtype} {tuple(scale.shape)} (want float32/float16 [..., 1]), "
            f"out {dtype} (want float32/bfloat16)")
    y = torch.empty(q.shape, dtype=dtype, device=q.device)
    if q.numel() == 0:
        return y
    err = _lib().dequantize_launch(
        q.data_ptr(), scale.data_ptr(), y.data_ptr(), q.numel() // q.shape[-1], q.shape[-1],
        _XDTYPES[dtype], _SDTYPES[scale.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check_launch(err, "dequantize_rows")
    dequantize_rows.launches += 1
    return y


dequantize_rows.launches = 0


_KV_MAX_LOADS = 16  # 16-byte loads a lane of csrc/quant.cu's KV write keeps


def paged_write_quant(pool_k, pool_v, pool_ks, pool_vs, k, v, table, positions,
                      page_size: int, valid=None):
    """The int8 KV pools' layer write in one launch of ``csrc/quant.cu``:
    each token's k and v ``[B, C, KV, hd]`` quantized (one f16 scale a token
    over its ``KV * hd`` values) and written at ``positions`` (``[B]`` with
    C = 1, or ``[B, C]``) through the page table ``[B, pps]``: row
    ``table[b, (pos // ps) % pps]``, offset ``pos % ps``, tokens not
    ``valid`` to the garbage row (the pool's last).  Codes and scales are
    bit-equal to ``models.kvcache.paged_write_quant_plain``'s (outside the
    garbage row, which takes one of several writes in either), whose
    writers call this on the card.  CUDA tensors only; the pools may be
    views of block-stacked leaves if they are contiguous; ``table`` and
    ``positions`` int32, ``valid`` bool, as the engine holds them (no cast,
    no host sync).  In place; returns the four pools."""
    if k.device.type != "cuda":
        raise ValueError(f"paged_write_quant: unsupported device {k.device}")
    build.refuse_grad("paged_write_quant", k, v)
    B, C, KV, hd = k.shape
    rows, ps, n = pool_k.shape[0], page_size, KV * hd
    tensors = dict(pool_k=pool_k, pool_v=pool_v, pool_ks=pool_ks, pool_vs=pool_vs, k=k, v=v,
                   table=table, positions=positions)
    if valid is not None:
        tensors["valid"] = valid
    for name, t in tensors.items():
        if t.device != k.device:
            raise ValueError(f"paged_write_quant: {name} on {t.device}, k on {k.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_write_quant: {name} is not contiguous")
    want_pos = (B,) if positions.dim() == 1 and C == 1 else (B, C)
    if (k.dtype not in _XDTYPES or v.dtype != k.dtype or pool_k.dtype != torch.int8
            or pool_v.dtype != torch.int8 or pool_ks.dtype != torch.float16
            or pool_vs.dtype != torch.float16 or table.dtype != torch.int32
            or positions.dtype != torch.int32
            or (valid is not None and valid.dtype != torch.bool)):
        raise ValueError(
            f"paged_write_quant: dtypes k/v {k.dtype}/{v.dtype} (want float32 or bfloat16), "
            f"pools {pool_k.dtype}/{pool_v.dtype} (want int8), scales "
            f"{pool_ks.dtype}/{pool_vs.dtype} (want float16), table {table.dtype} and "
            f"positions {positions.dtype} (want int32), valid "
            f"{None if valid is None else valid.dtype} (want bool)")
    if (tuple(v.shape) != (B, C, KV, hd) or tuple(pool_k.shape[1:]) != (ps, KV, hd)
            or pool_v.shape != pool_k.shape or tuple(pool_ks.shape) != (rows, ps)
            or pool_vs.shape != pool_ks.shape or table.dim() != 2 or table.shape[0] != B
            or tuple(positions.shape) != want_pos
            or (valid is not None and tuple(valid.shape) != (B, C))):
        raise ValueError(
            f"paged_write_quant: shapes k {tuple(k.shape)} v {tuple(v.shape)} pools "
            f"{tuple(pool_k.shape)} scales {tuple(pool_ks.shape)} table "
            f"{tuple(table.shape)} positions {tuple(positions.shape)} (page_size {ps}) "
            f"do not agree")
    per_load = 16 // k.element_size()
    if (n % per_load or -(-n // per_load) > 32 * _KV_MAX_LOADS
            or k.data_ptr() % 16 or v.data_ptr() % 16
            or pool_k.data_ptr() % per_load or pool_v.data_ptr() % per_load):
        raise ValueError(
            f"paged_write_quant: a token's {n} values must be a multiple of {per_load} and "
            f"at most {32 * _KV_MAX_LOADS * per_load}, k/v 16-byte aligned, the pools "
            f"{per_load}-byte aligned")
    if B * C == 0:  # an empty grid is no launch
        return pool_k, pool_v, pool_ks, pool_vs
    err = _lib().paged_write_quant_launch(
        k.data_ptr(), v.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), pool_ks.data_ptr(),
        pool_vs.data_ptr(), table.data_ptr(), positions.data_ptr(),
        None if valid is None else valid.data_ptr(), B, C, n, table.shape[1], ps, rows,
        _XDTYPES[k.dtype], torch.cuda.current_stream(k.device).cuda_stream,
    )
    build.check_launch(err, "paged_write_quant")
    paged_write_quant.launches += 1
    return pool_k, pool_v, pool_ks, pool_vs


paged_write_quant.launches = 0
