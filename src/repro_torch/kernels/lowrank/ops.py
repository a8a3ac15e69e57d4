"""Low-rank boundary codec (eq. 8, 1-D form): the CUDA kernel's wrappers
and their plain PyTorch versions.

``lowrank_encode`` computes ``Z = X·E``, ``lowrank_decode`` ``X̂ = Z·D``,
and ``lowrank_roundtrip`` both in one pass plus ``Σ(X − X̂)²``, with f32
accumulation and outputs in X's type (the reference's
``kernels/lowrank/ref.py``).  Both operands of a product share one type:
the consumer (``core.compression``) casts the codec to the activation type
first, as the reference's ``encode_1d`` / ``decode_1d`` do.  A CPU tensor
goes to the plain version; a CUDA tensor launches ``csrc/lowrank.cu`` or
raises.  Any number of rows T is taken (the kernel masks the tail).

Encode and decode share one kernel on 64 x 64 output tiles, each block
walking all of K in a fixed order, so two launches give the same bits.

The int8 boundary folds into the codec: ``lowrank_encode_quant`` is
``quantize_rows(lowrank_encode(x, enc), scale_dtype=float16)`` and
``lowrank_decode_quant`` is ``lowrank_decode(dequantize_rows(q, s), dec)``,
each bit for bit in one launch, where :func:`codec_quant_plan` says the
fused form applies (the encode's row tile runs as one thread-block cluster
of its ``ceil(r / 64)`` column tiles, at most 8).  Its callers
(``core.compression``) compose the standalone kernels elsewhere.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant import dequantize_rows_plain, quantize_rows_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 8  # token rows per roundtrip block (kRows in csrc/lowrank.cu)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100
TILE = 64  # output columns per block (kBN in csrc/lowrank.cu)
MAX_CLUSTER = 8  # the portable thread-block cluster size
BOUNDARY_SCALE_DTYPE = torch.float16  # the fused forms' row scales


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("lowrank")
    lib.lowrank_project_launch.restype = ctypes.c_int
    lib.lowrank_project_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.lowrank_encode_quant_launch.restype = ctypes.c_int
    lib.lowrank_encode_quant_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.lowrank_encode_quant_clusters.restype = ctypes.c_int
    lib.lowrank_encode_quant_clusters.argtypes = [ctypes.c_int] * 2
    lib.lowrank_decode_quant_launch.restype = ctypes.c_int
    lib.lowrank_decode_quant_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.lowrank_roundtrip_launch.restype = ctypes.c_int
    lib.lowrank_roundtrip_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    return lib


def lowrank_project_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [T, k] @ w [k, n]`` in f32, rounded to x's type once (encode with
    ``w = E``, decode with ``w = D``)."""
    return (x.float() @ w.float()).to(x.dtype)


def codec_quant_plan(r: int) -> str:
    """``"fused"`` where one launch computes the codec and its int8 boundary
    (rank ``r`` spans at most ``MAX_CLUSTER`` column tiles of ``TILE``:
    ``r <= 512``), else ``"composed"``: the codec's and the quantizer's
    standalone kernels, one after the other.  Both f32 and bf16 have a
    fused form, and unaligned or ragged widths take its scalar loads, so
    the plan depends on ``r`` alone."""
    return "fused" if -(-r // TILE) <= MAX_CLUSTER else "composed"


def lowrank_encode_quant_plain(
    x: torch.Tensor, enc: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows(x @ enc)``: Z rounded to x's type, then int8 codes
    ``[T, r]`` and one f16 scale a row ``[T, 1]``."""
    return quantize_rows_plain(lowrank_project_plain(x, enc), scale_dtype=BOUNDARY_SCALE_DTYPE)


def lowrank_decode_quant_plain(
    q: torch.Tensor, scale: torch.Tensor, dec: torch.Tensor
) -> torch.Tensor:
    """``dequantize_rows(q, scale) @ dec`` in dec's type."""
    return lowrank_project_plain(dequantize_rows_plain(q, scale, dtype=dec.dtype), dec)


def lowrank_roundtrip_plain(
    x: torch.Tensor, enc: torch.Tensor, dec: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X̂ in x's type, Σ(X − X̂)² in f32): Z stays in f32 and the error is
    taken from the unrounded f32 X̂."""
    xf = x.float()
    x_hat = (xf @ enc.float()) @ dec.float()
    return x_hat.to(x.dtype), (xf - x_hat).square().sum()


def _check(what: str, x: torch.Tensor, *ws: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    for t in (x, *ws):
        if t.device != x.device:
            raise ValueError(f"{what}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: an operand is not contiguous")
        if t.dim() != 2:
            raise ValueError(f"{what}: operands must be 2-D, got {tuple(t.shape)}")
    if x.dtype not in _DTYPES or any(w.dtype != x.dtype for w in ws):
        raise ValueError(
            f"{what}: operands must share one dtype of float32/bfloat16, got "
            + " ".join(str(t.dtype) for t in (x, *ws))
        )


def _project(fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The shared body of encode and decode; counts launches on ``fn``."""
    if x.device.type == "cpu":
        return lowrank_project_plain(x, w)
    what = fn.__name__
    _check(what, x, w)
    nt, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"{what}: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]  # any widths: the tiles' shared memory does not grow with them
    y = torch.empty((nt, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:  # an empty grid is no launch
        return y
    err = _lib().lowrank_project_launch(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), nt, k, n, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check_launch(err, what)
    fn.launches += 1
    return y


def lowrank_encode(x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """``Z [T, r] = X [T, d] · E [d, r]``; the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    return _project(lowrank_encode, x, enc)


def lowrank_decode(z: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    """``X̂ [T, d] = Z [T, r] · D [r, d]``; the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    return _project(lowrank_decode, z, dec)


def _fused(what: str, r: int) -> None:
    if codec_quant_plan(r) != "fused":
        raise ValueError(f"{what}: rank {r} spans more than {MAX_CLUSTER} column tiles of "
                         f"{TILE}; codec_quant_plan composes the standalone kernels there")


@functools.lru_cache(maxsize=None)
def encode_quant_clusters(dtype: torch.dtype, cluster: int) -> int:
    """How many clusters of ``cluster`` column tiles of the fused encode in
    ``dtype`` the card runs at once (``cudaOccupancyMaxActiveClusters``,
    read once a shape); raises if it runs none."""
    n = _lib().lowrank_encode_quant_clusters(_DTYPES[dtype], cluster)
    if n <= 0:
        raise RuntimeError(f"lowrank_encode_quant: the card co-schedules no cluster of {cluster} "
                           f"blocks of the {dtype} form (cudaOccupancyMaxActiveClusters: {n})")
    return n


def lowrank_encode_quant(x: torch.Tensor, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 [T, r], scale f16 [T, 1]) = quantize_rows(X · E)`` in one
    launch; the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (bit-equal to ``lowrank_encode`` then ``quantize_rows``)."""
    if x.device.type == "cpu":
        return lowrank_encode_quant_plain(x, enc)
    _check("lowrank_encode_quant", x, enc)
    nt, k = x.shape
    if enc.shape[0] != k:
        raise ValueError(f"lowrank_encode_quant: shapes {tuple(x.shape)} @ {tuple(enc.shape)}")
    r = enc.shape[1]
    _fused("lowrank_encode_quant", r)
    q = torch.empty((nt, r), dtype=torch.int8, device=x.device)
    scale = torch.empty((nt, 1), dtype=BOUNDARY_SCALE_DTYPE, device=x.device)
    if q.numel() == 0:  # an empty grid is no launch
        return q, scale
    encode_quant_clusters(x.dtype, -(-r // TILE))
    err = _lib().lowrank_encode_quant_launch(
        x.data_ptr(), enc.data_ptr(), q.data_ptr(), scale.data_ptr(), nt, k, r,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check_launch(err, "lowrank_encode_quant")
    lowrank_encode_quant.launches += 1
    return q, scale


def lowrank_decode_quant(q: torch.Tensor, scale: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    """``X̂ [T, d] = T(f32(q) · f32(scale)) · D`` in D's type T, in one
    launch; the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (bit-equal to ``dequantize_rows`` then ``lowrank_decode``)."""
    if q.device.type == "cpu":
        return lowrank_decode_quant_plain(q, scale, dec)
    _check("lowrank_decode_quant", dec)
    for name, t in (("q", q), ("scale", scale)):
        if t.device != dec.device or not t.is_contiguous():
            raise ValueError(f"lowrank_decode_quant: {name} must be contiguous on {dec.device}")
    nt, r = q.shape if q.dim() == 2 else (-1, -1)
    if (q.dtype != torch.int8 or scale.dtype != BOUNDARY_SCALE_DTYPE or r != dec.shape[0]
            or tuple(scale.shape) != (nt, 1)):
        raise ValueError(
            f"lowrank_decode_quant: q {q.dtype} {tuple(q.shape)} (want int8 [T, r]), scale "
            f"{scale.dtype} {tuple(scale.shape)} (want float16 [T, 1]), dec "
            f"{tuple(dec.shape)} (want [r, d])")
    _fused("lowrank_decode_quant", r)
    d = dec.shape[1]
    y = torch.empty((nt, d), dtype=dec.dtype, device=dec.device)
    if y.numel() == 0:
        return y
    err = _lib().lowrank_decode_quant_launch(
        q.data_ptr(), scale.data_ptr(), dec.data_ptr(), y.data_ptr(), nt, r, d,
        _DTYPES[dec.dtype], torch.cuda.current_stream(dec.device).cuda_stream,
    )
    build.check_launch(err, "lowrank_decode_quant")
    lowrank_decode_quant.launches += 1
    return y


def lowrank_roundtrip(
    x: torch.Tensor, enc: torch.Tensor, dec: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused eq. 8 path: (X̂ in x's type, Σ(X − X̂)² as an f32 scalar); the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors (the
    error sum is deterministic: per-block partials summed in fixed order)."""
    if x.device.type == "cpu":
        return lowrank_roundtrip_plain(x, enc, dec)
    _check("lowrank_roundtrip", x, enc, dec)
    nt, d = x.shape
    r = enc.shape[1]
    if enc.shape[0] != d or dec.shape != (r, d):
        raise ValueError(
            f"lowrank_roundtrip: shapes x={tuple(x.shape)} enc={tuple(enc.shape)} "
            f"dec={tuple(dec.shape)} do not agree"
        )
    if 4 * ROWS * (d + r) > SMEM_LIMIT:
        raise ValueError(f"lowrank_roundtrip: d + r = {d + r} exceeds the kernel's shared memory")
    x_hat = torch.empty_like(x)
    err_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return x_hat, err_sum
    partial = torch.empty(-(-nt // ROWS), dtype=torch.float32, device=x.device)
    err = _lib().lowrank_roundtrip_launch(
        x.data_ptr(), enc.data_ptr(), dec.data_ptr(), x_hat.data_ptr(),
        partial.data_ptr(), err_sum.data_ptr(), nt, d, r, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check_launch(err, "lowrank_roundtrip")
    lowrank_roundtrip.launches += 1
    return x_hat, err_sum


lowrank_encode.launches = 0
lowrank_decode.launches = 0
lowrank_encode_quant.launches = 0
lowrank_decode_quant.launches = 0
lowrank_roundtrip.launches = 0
