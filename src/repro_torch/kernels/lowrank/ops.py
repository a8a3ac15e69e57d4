"""Low-rank boundary codec (eq. 8, 1-D form): the CUDA kernel's wrappers
and their plain PyTorch versions.

``lowrank_encode`` computes ``Z = X·E``, ``lowrank_decode`` ``X̂ = Z·D``,
with f32 accumulation and outputs in X's type (the reference's
``kernels/lowrank/ref.py``).  Both operands of a product share one type:
the consumer (``core.compression``) casts the codec to the activation type
first, as the reference's ``encode_1d`` / ``decode_1d`` do.  A CPU tensor
goes to the plain version; a CUDA tensor launches ``csrc/lowrank.cu`` or
raises.  Any number of rows T is taken (the kernel masks the tail).

Encode and decode share one kernel on 64 x 64 output tiles, each block
walking all of K in a fixed order, so two launches give the same bits.

The roundtrip runs in one launch where :func:`roundtrip_plan` says so
(rank ``r`` spans at most 8 column tiles: a 64-row tile is one
thread-block cluster of them).  ``lowrank_roundtrip_loss`` is the MoE
dispatch codec's form (``core.compression.roundtrip_loss_1d``, on the
dispatched rows and the expert outputs of every MoE layer): the
consumer's roundings, Z rounded to X's type between the products, and
``Σ(X − X̂)²`` and its mean taken over the rounded X̂.
``lowrank_roundtrip`` keeps the reference kernel's own contract (Z and
X̂ in f32, the error from the unrounded X̂, X̂ rounded at the end): on
the card, the same kernel's f32 form on f32 copies of its operands.  The
error sums are deterministic: per-block partials summed in a fixed order.
Training enters ``roundtrip_loss`` through :class:`RoundtripLossFn`, whose
forward is that launch (or the composed kernels) and whose backward is
plain products, as the reference differentiates its consumer; and
``lowrank_encode`` / ``lowrank_decode`` through :class:`ProjectFn` (the
expert-parallel bodies' codec on the wire), likewise.  Every other
wrapper here has no backward and raises on an operand that wants a
gradient.

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
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.quant import dequantize_rows_plain, quantize_rows_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.lowrank_roundtrip_clusters.restype = ctypes.c_int
    lib.lowrank_roundtrip_clusters.argtypes = [ctypes.c_int] * 3
    return lib


def roundtrip_split(nt: int, r: int, dtype: torch.dtype) -> int:
    """The K split of the roundtrip's launch: 2 (a cluster of 2·ceil(r/64)
    blocks, each running phase 1 over half of K and phase 2 over half as
    many X̂ tiles, so each reads half as much of E and D) for bf16 where
    that cluster is at most 12 blocks and the grid at most 4 row tiles of
    64 (T <= 256: the serving and streaming steps), else 1 (the f32 form,
    and large T, whose many clusters already spread E and D over the
    card)."""
    c = -(-r // TILE)
    return 2 if dtype == torch.bfloat16 and 2 * c <= 12 and -(-nt // TILE) <= 4 else 1


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


def roundtrip_plan(r: int) -> str:
    """``"fused"`` where one launch computes the roundtrip and its error
    (rank ``r`` spans at most ``MAX_CLUSTER`` column tiles: ``r <= 512``),
    else ``"composed"``: ``lowrank_encode``, ``lowrank_decode`` and the
    error summed by PyTorch; :func:`codec_quant_plan`'s rule."""
    return codec_quant_plan(r)


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
    taken from the unrounded f32 X̂ (the reference kernel's contract)."""
    xf = x.float()
    x_hat = (xf @ enc.float()) @ dec.float()
    return x_hat.to(x.dtype), (xf - x_hat).square().sum()


def lowrank_roundtrip_loss_plain(
    x: torch.Tensor, enc: torch.Tensor, dec: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The consumer's roundtrip: (X̂ = T(T(X·E)·D) in x's type T, Σ(X − X̂)²
    and its mean over X's elements, both f32), the error over the rounded
    X̂ (the reference's ``roundtrip_1d`` then ``recon_loss``)."""
    x_hat = lowrank_project_plain(lowrank_project_plain(x, enc), dec)
    sq = (x.float() - x_hat.float()).square().sum()
    return x_hat, sq, sq / x.numel()


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
    """The shared body of encode and decode; through :class:`ProjectFn`
    when a gradient is wanted (grad mode on and an operand that requires
    one), so serving builds no graph."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return ProjectFn.apply(x, w, fn)
    return _launch_project(fn, x, w)


class ProjectFn(torch.autograd.Function):
    """``x @ w`` (encode with ``w = E``, decode with ``w = D``) with an
    explicit backward: the forward is the wrapper's launch (the plain
    version on CPU tensors, the kernel on CUDA tensors), the backward the
    product's adjoint as ``torch.matmul`` in the operands' type, dX = dY·Wᵀ
    and dW = Xᵀ·dY.  In the reference these products are ``jnp`` code
    outside any Pallas kernel, and autodiff gives the same two."""

    @staticmethod
    def forward(ctx, x, w, fn):
        ctx.save_for_backward(x, w)
        return _launch_project(fn, x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dy @ w.t() if ctx.needs_input_grad[0] else None
        dw = x.t() @ dy if ctx.needs_input_grad[1] else None
        return dx, dw, None


def _launch_project(fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One encode or decode on CUDA operands (the plain version on CPU
    ones); counts launches on ``fn``."""
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


def _co_scheduled(what: str, n: int, dtype: torch.dtype, blocks: int) -> int:
    if n <= 0:
        raise RuntimeError(f"{what}: the card co-schedules no cluster of {blocks} "
                           f"blocks of the {dtype} form (cudaOccupancyMaxActiveClusters: {n})")
    return n


@functools.lru_cache(maxsize=None)
def encode_quant_clusters(dtype: torch.dtype, cluster: int) -> int:
    """How many clusters of ``cluster`` column tiles of the fused encode in
    ``dtype`` the card runs at once (``cudaOccupancyMaxActiveClusters``,
    read once a shape); raises if it runs none."""
    return _co_scheduled("lowrank_encode_quant",
                         _lib().lowrank_encode_quant_clusters(_DTYPES[dtype], cluster), dtype,
                         cluster)


@functools.lru_cache(maxsize=None)
def roundtrip_clusters(dtype: torch.dtype, cluster: int, split: int = 1) -> int:
    """How many clusters of ``cluster`` column tiles times the K split
    ``split`` of the roundtrip in ``dtype`` the card runs at once (read once
    a shape); raises if it runs none."""
    return _co_scheduled("lowrank_roundtrip",
                         _lib().lowrank_roundtrip_clusters(_DTYPES[dtype], cluster, split), dtype,
                         cluster * split)


def lowrank_encode_quant(x: torch.Tensor, enc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8 [T, r], scale f16 [T, 1]) = quantize_rows(X · E)`` in one
    launch; the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (bit-equal to ``lowrank_encode`` then ``quantize_rows``)."""
    if x.device.type == "cpu":
        return lowrank_encode_quant_plain(x, enc)
    _check("lowrank_encode_quant", x, enc)
    build.refuse_grad("lowrank_encode_quant", x, enc)
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
    build.refuse_grad("lowrank_decode_quant", scale, dec)
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


# one ticket a (device, stream): the roundtrip's last block to finish sums
# the error partials and puts its ticket back to 0; launches on one stream
# never overlap, so none shares a ticket with another in flight
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def _roundtrip(what: str, x: torch.Tensor, enc: torch.Tensor,
               dec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the roundtrip kernel on checked CUDA operands: (X̂ in
    x's type, f32 [2]: Σ(X − X̂)² over the rounded X̂ and its mean)."""
    nt, d = x.shape
    r = enc.shape[1]
    if enc.shape[0] != d or dec.shape != (r, d):
        raise ValueError(
            f"{what}: shapes x={tuple(x.shape)} enc={tuple(enc.shape)} "
            f"dec={tuple(dec.shape)} do not agree"
        )
    if roundtrip_plan(r) != "fused":
        raise ValueError(f"{what}: rank {r} spans more than {MAX_CLUSTER} column tiles of "
                         f"{TILE}; roundtrip_plan composes the standalone kernels there")
    x_hat = torch.empty_like(x)
    if x.numel() == 0:  # an empty grid is no launch; the mean of nothing is NaN
        return x_hat, torch.tensor([0.0, float("nan")], device=x.device)
    c, split = -(-r // TILE), roundtrip_split(nt, r, x.dtype)
    roundtrip_clusters(x.dtype, c, split)
    err = torch.empty(2, dtype=torch.float32, device=x.device)
    partial = torch.empty(-(-nt // TILE), dtype=torch.float32, device=x.device)  # a row tile each
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _lib().lowrank_roundtrip_launch(
        x.data_ptr(), enc.data_ptr(), dec.data_ptr(), x_hat.data_ptr(), partial.data_ptr(),
        _ticket(x.device, stream).data_ptr(), err.data_ptr(), nt, d, r, split,
        _DTYPES[x.dtype], stream,
    )
    build.check_launch(code, what)
    return x_hat, err


def lowrank_roundtrip_loss(
    x: torch.Tensor, enc: torch.Tensor, dec: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The consumer's roundtrip in one launch: (X̂ = T(T(X·E)·D) in x's type
    T, Σ(X − X̂)² over the rounded X̂, its mean over X's elements), the sums
    in f32; the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (rank at most 512, :func:`roundtrip_plan`)."""
    if x.device.type == "cpu":
        return lowrank_roundtrip_loss_plain(x, enc, dec)
    _check("lowrank_roundtrip_loss", x, enc, dec)
    build.refuse_grad("lowrank_roundtrip_loss (RoundtripLossFn has its backward)", x, enc, dec)
    x_hat, err = _roundtrip("lowrank_roundtrip_loss", x, enc, dec)
    lowrank_roundtrip_loss.launches += 1
    return x_hat, err[0], err[1]


def lowrank_roundtrip(
    x: torch.Tensor, enc: torch.Tensor, dec: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference kernel's contract: (X̂ in x's type, Σ(X − X̂)² as an f32
    scalar), Z and X̂ in f32 and the error from the unrounded X̂; the plain
    version for CPU tensors, the roundtrip kernel's f32 form on f32 copies
    of the operands for CUDA tensors, X̂ rounded to x's type after it."""
    if x.device.type == "cpu":
        return lowrank_roundtrip_plain(x, enc, dec)
    _check("lowrank_roundtrip", x, enc, dec)
    build.refuse_grad("lowrank_roundtrip", x, enc, dec)
    x_hat, err = _roundtrip("lowrank_roundtrip", x.float(), enc.float(), dec.float())
    lowrank_roundtrip.launches += 1
    return x_hat.to(x.dtype), err[0]


def _roundtrip_loss(x: torch.Tensor, enc: torch.Tensor, dec: torch.Tensor):
    """(X̂, Σ(X − X̂)², its mean, Z or None) by :func:`roundtrip_plan`: one
    ``lowrank_roundtrip_loss`` where it fuses the rank (Z stays inside the
    launch: None), else ``lowrank_encode``, ``lowrank_decode`` and the
    error summed by PyTorch.  Each wrapper takes the plain version on CPU
    tensors."""
    if roundtrip_plan(enc.shape[1]) == "fused":
        return (*lowrank_roundtrip_loss(x, enc, dec), None)
    z = lowrank_encode(x, enc)
    x_hat = lowrank_decode(z, dec)
    err = (x.float() - x_hat.float()).square()
    return x_hat, err.sum(), err.mean(), z


def roundtrip_loss(
    x: torch.Tensor, enc: torch.Tensor, dec: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The MoE dispatch codec's roundtrip: (X̂ = T(T(X·E)·D) in x's type T,
    Σ(X − X̂)² and its mean over X's elements, f32), in one launch where
    :func:`roundtrip_plan` fuses the rank, else the encode and decode
    kernels; through :class:`RoundtripLossFn` when a gradient is wanted
    (grad mode on and an input that requires one), so serving builds no
    graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, enc, dec)):
        return RoundtripLossFn.apply(x, enc, dec)
    return _roundtrip_loss(x, enc, dec)[:3]


class RoundtripLossFn(torch.autograd.Function):
    """The roundtrip with an explicit backward, the autodiff of the
    reference's ``roundtrip_1d`` then ``recon_loss`` (and of the plain
    version) at their rounding points.  The forward is
    :func:`_roundtrip_loss` (the kernels on the card).  The backward
    recomputes Z = T(X·E) where the fused launch kept it inside (the
    composed plan saves it), then, with N = X's elements and c the
    gradient reaching Σ(X − X̂)² (the mean's over N added):

    - dX̂ = upstream + T(2c(X̂ − X)), summed in T;
    - dZ = T(dX̂·Dᵀ), dD = T(Zᵀ·dX̂);
    - dX = T(dZ·Eᵀ) + T(2c(X − X̂)), dE = T(Xᵀ·dZ);

    each product in f32 (``torch.matmul``: the reference has no backward
    kernel for the codec, only plain products).  E and D arrive in T, as
    the consumer casts its f32 masters; the cast's own backward returns
    their gradients to f32."""

    @staticmethod
    def forward(ctx, x, enc, dec):
        x_hat, sq, loss, z = _roundtrip_loss(x, enc, dec)
        ctx.save_for_backward(x, enc, dec, x_hat, z)
        return x_hat, sq, loss

    @staticmethod
    def backward(ctx, d_xhat, d_sq, d_loss):
        x, enc, dec, x_hat, z = ctx.saved_tensors
        dt = x.dtype
        f32 = torch.float32
        c = torch.zeros((), dtype=f32, device=x.device)
        if d_sq is not None:
            c = c + d_sq.float()
        if d_loss is not None:
            c = c + d_loss.float() / max(x.numel(), 1)
        d_err = (x.float() - x_hat.float()) * (2.0 * c)  # the error's gradient at X
        g = (-d_err).to(dt)
        if d_xhat is not None:
            g = d_xhat.to(dt) + g
        if z is None:
            z = (x.float() @ enc.float()).to(dt)
        gf = g.float()
        dz = (gf @ dec.float().T).to(dt)
        d_dec = (z.float().T @ gf).to(dec.dtype)
        dzf = dz.float()
        dx = (dzf @ enc.float().T).to(dt) + d_err.to(dt)
        d_enc = (x.float().T @ dzf).to(enc.dtype)
        return dx, d_enc, d_dec


lowrank_encode.launches = 0
lowrank_decode.launches = 0
lowrank_encode_quant.launches = 0
lowrank_decode_quant.launches = 0
lowrank_roundtrip.launches = 0
lowrank_roundtrip_loss.launches = 0
