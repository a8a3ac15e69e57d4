"""PO-ECC low-rank compression (paper eq. 8), 1-D token-tensor form, and
the int8 second stage of the boundary payload: the port of the reference's
``core/compression.py`` parts the end-cloud engines use.

Token tensors ``[..., d]`` cross a communication boundary as
``Z = X E`` (``E`` in R^{d x r}) and are restored as ``X̂ = Z D``, cutting
the bytes on the wire by r/d.  The products run in ``kernels.lowrank`` (the
CUDA kernel on the card) with the reference consumer's casting: the codec
is cast to the activation type before the product.  The boundary's int8
stage (``quantize_boundary``) runs in ``kernels.quant``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.lowrank import lowrank_decode, lowrank_encode
from repro_torch.kernels.quant import dequantize_rows, quantize_rows

BOUNDARY_SCALE_DTYPE = torch.float16  # f16 keeps a quantized row <= 0.55x of bf16


def init_lowrank_1d(generator: torch.Generator, d: int, r: int,
                    dtype: torch.dtype = torch.float32, device=None) -> Dict:
    """Orthonormal codec ``{"enc": Q [d, r], "dec": Q^T [r, d]}`` from the QR
    of a standard normal draw, so the identity is recoverable at r = d.

    The draw and the QR run on the CPU (``generator`` must be a CPU
    generator) and the result moves to ``device``.  The reference draws from
    ``jax.random.PRNGKey(7)``; no torch generator reproduces those numbers,
    so a codec that must equal the reference's is carried across with
    ``bridge.params_from_numpy`` and passed in as ``codec_params``."""
    e = torch.linalg.qr(torch.randn(d, r, generator=generator, dtype=torch.float32))[0]
    # QR returns Q column-major; the kernels take row-major operands
    return {"enc": e.contiguous().to(device=device, dtype=dtype),
            "dec": e.T.contiguous().to(device=device, dtype=dtype)}


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def encode_1d(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x [..., d] -> z [..., r]``."""
    z = lowrank_encode(_rows(x), params["enc"].to(x.dtype))
    return z.reshape(*x.shape[:-1], z.shape[-1])


def decode_1d(params: Dict, z: torch.Tensor) -> torch.Tensor:
    """``z [..., r] -> x̂ [..., d]``."""
    x = lowrank_decode(_rows(z), params["dec"].to(z.dtype))
    return x.reshape(*z.shape[:-1], x.shape[-1])


def roundtrip_1d(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``decode_1d(encode_1d(x))``, composed as the reference composes it:
    Z is rounded to x's type between the two products.  (The fused
    ``kernels.lowrank.lowrank_roundtrip`` keeps Z in f32 and also returns
    the error sum; no consumer of the port needs that yet.)"""
    return decode_1d(params, encode_1d(params, x))


def recon_loss(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """||X - X_hat||_2^2 (mean over elements, f32)."""
    return (x.float() - x_hat.float()).square().mean()


def quantize_boundary(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second codec stage of a boundary payload ``[..., r]`` (low-rank
    encoded, or raw without a codec): int8 codes with one f16 scale per row
    ``[..., 1]``, rounded to f16 before the divide, so a row costs ``r + 2``
    bytes on the wire instead of ``2r`` (bf16)."""
    return quantize_rows(z.contiguous(), scale_dtype=BOUNDARY_SCALE_DTYPE)


def dequantize_boundary(q: torch.Tensor, scale: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return dequantize_rows(q, scale, dtype=dtype)


def compression_ratio(d: int, r: int, in_bits: int = 16, codec: str = "lowrank"):
    """Bytes-on-wire ratio used by the route-aware scheduler's comm model."""
    if codec == "lowrank":
        return r / d
    if codec == "int8":
        return 8 / in_bits
    if codec == "none":
        return 1.0
    raise ValueError(codec)
