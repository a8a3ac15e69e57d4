"""PO-ECC low-rank compression (paper eq. 8), 1-D token-tensor form, and
the int8 second stage of the boundary payload: the port of the reference's
``core/compression.py`` (its 2-D faithful form, ``joint_loss`` and the
int8 range codec too, which only tests call).

Token tensors ``[..., d]`` cross a communication boundary as
``Z = X E`` (``E`` in R^{d x r}) and are restored as ``X̂ = Z D``, cutting
the bytes on the wire by r/d.  The products run in ``kernels.lowrank`` (the
CUDA kernel on the card) with the reference consumer's casting: the codec
is cast to the activation type before the product (``compute_codec``
keeps that copy beside the f32 one, made once).  The MoE dispatch codec
runs both products and its reconstruction loss in one launch
(``roundtrip_loss_1d``), and trains through an autograd Function around
that launch.  The boundary's int8
stage runs with the codec in one launch a side (``encode_quantized_1d``,
``decode_quantized_1d``, ``kernels.lowrank``'s fused forms), or alone
(``quantize_boundary``, ``kernels.quant``) where there is no codec.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels.lowrank import (
    codec_quant_plan,
    lowrank_decode,
    lowrank_decode_quant,
    lowrank_encode,
    lowrank_encode_quant,
    roundtrip_loss,
)
from repro_torch.kernels.lowrank.ops import BOUNDARY_SCALE_DTYPE  # f16: a row is r + 2 bytes
from repro_torch.kernels.quant import dequantize_rows, quantize_rows


def init_lowrank_1d(generator: torch.Generator, d: int, r: int,
                    dtype: torch.dtype = torch.float32, device=None,
                    lead: Tuple[int, ...] = ()) -> Dict:
    """Orthonormal codec ``{"enc": Q [*lead, d, r], "dec": Q^T [*lead, r,
    d]}`` from the QR of a standard normal draw, so the identity is
    recoverable at r = d; ``lead`` stacks independent codecs (one a block
    of a layer stack).

    The draw runs on the generator's device, the QR on the CPU, and the
    result moves to ``device``.  The reference draws from a
    ``jax.random.PRNGKey``; no torch generator reproduces those numbers, so
    a codec that must equal the reference's is carried across with
    ``bridge.params_from_numpy``."""
    g = torch.randn(*lead, d, r, generator=generator, dtype=torch.float32,
                    device=generator.device)
    e = torch.linalg.qr(g.cpu())[0]
    # QR returns Q column-major; the kernels take row-major operands
    return {"enc": e.contiguous().to(device=device, dtype=dtype),
            "dec": e.transpose(-1, -2).contiguous().to(device=device, dtype=dtype)}


def compute_codec(params: Dict, dtype: torch.dtype) -> Dict:
    """The codec with copies of ``enc`` and ``dec`` in the activation type
    (``enc_act``, ``dec_act``) beside them, cast once (as
    ``transformer.compute_params`` does for the weights): the products read
    them with no cast a call, and the values are the same cast's.  Entries
    that are not tensors pass through uncopied (a planner reads only the
    rank, ``enc.shape[1]``)."""
    return {**params, **{f"{k}_act": params[k].to(dtype) for k in ("enc", "dec")
                         if isinstance(params.get(k), torch.Tensor)}}


def _weight(params: Dict, key: str, dtype: torch.dtype) -> torch.Tensor:
    """``params[key]`` in ``dtype``: the copy ``compute_codec`` made, or a cast."""
    w = params.get(f"{key}_act")
    return w if w is not None and w.dtype == dtype else params[key].to(dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def encode_1d(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x [..., d] -> z [..., r]``."""
    z = lowrank_encode(_rows(x), _weight(params, "enc", x.dtype))
    return z.reshape(*x.shape[:-1], z.shape[-1])


def decode_1d(params: Dict, z: torch.Tensor) -> torch.Tensor:
    """``z [..., r] -> x̂ [..., d]``."""
    x = lowrank_decode(_rows(z), _weight(params, "dec", z.dtype))
    return x.reshape(*z.shape[:-1], x.shape[-1])


def encode_quantized_1d(params: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_boundary(encode_1d(params, x))``: ``x [..., d] -> (q int8
    [..., r], scale f16 [..., 1])``, in one launch where
    ``codec_quant_plan`` fuses it, else the two standalone kernels."""
    enc = _weight(params, "enc", x.dtype)
    if codec_quant_plan(enc.shape[1]) == "fused":
        q, scale = lowrank_encode_quant(_rows(x), enc)
    else:
        q, scale = quantize_rows(lowrank_encode(_rows(x), enc), scale_dtype=BOUNDARY_SCALE_DTYPE)
    return q.reshape(*x.shape[:-1], q.shape[-1]), scale.reshape(*x.shape[:-1], 1)


def decode_quantized_1d(params: Dict, q: torch.Tensor, scale: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """``decode_1d(params, dequantize_boundary(q, scale, dtype))``: ``(q
    [..., r], scale [..., 1]) -> x̂ [..., d]`` in ``dtype``, in one launch
    where ``codec_quant_plan`` fuses it, else the two standalone kernels."""
    dec = _weight(params, "dec", dtype)
    qr, sr = _rows(q), scale.reshape(-1, 1)
    if codec_quant_plan(dec.shape[0]) == "fused":
        x = lowrank_decode_quant(qr, sr, dec)
    else:
        x = lowrank_decode(dequantize_rows(qr, sr, dtype=dtype), dec)
    return x.reshape(*q.shape[:-1], x.shape[-1])


def roundtrip_1d(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``decode_1d(encode_1d(x))`` with the reference's roundings (Z
    rounded to x's type between the two products), through the fused
    roundtrip of :func:`roundtrip_loss_1d`."""
    return roundtrip_loss_1d(params, x)[0]


def roundtrip_loss_1d(params: Dict, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x̂, recon_loss(x, x̂))`` with ``x̂ = roundtrip_1d(params, x)``: the
    MoE dispatch codec's two numbers, in one launch
    (``kernels.lowrank.lowrank_roundtrip_loss``) where ``roundtrip_plan``
    fuses the rank, else encode, decode and the loss one after the other
    (``kernels.lowrank.roundtrip_loss``).  When a gradient is wanted the
    call goes through ``RoundtripLossFn``, whose backward carries the task
    loss's gradient and the eq. 8 term's through the codec to x and to the
    codec's f32 ``enc`` / ``dec``."""
    enc, dec = _weight(params, "enc", x.dtype), _weight(params, "dec", x.dtype)
    x_hat, _, loss = roundtrip_loss(_rows(x), enc, dec)
    return x_hat.reshape(x.shape), loss


def recon_loss(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """||X - X_hat||_2^2 (mean over elements, f32)."""
    return (x.float() - x_hat.float()).square().mean()


def joint_loss(x: torch.Tensor, x_hat: torch.Tensor, task_loss: torch.Tensor,
               recon_weight: float = 1.0, task_weight: float = 1.0) -> torch.Tensor:
    """L_rec = ||X - X_hat||^2 + lambda * L_task  (eq. 8)."""
    return recon_weight * recon_loss(x, x_hat) + task_weight * task_loss


# -- the 2-D faithful form (eq. 8 verbatim, feature maps [..., h, w, c]) -----


def init_lowrank_2d(generator: torch.Generator, h: int, w: int, r: int,
                    dtype: torch.dtype = torch.float32, device=None) -> Dict:
    """``{"U", "V", "U_hat", "V_hat"}``: ``U`` [h, r] and ``V`` [w, r] from
    the QRs of standard normal draws, the decoder starting as the encoder
    (the identity is recoverable at r = min(h, w)).  As with
    :func:`init_lowrank_1d`, a codec that must equal the reference's is
    carried across."""
    u, v = (torch.linalg.qr(torch.randn(n, r, generator=generator, dtype=torch.float32,
                                        device=generator.device).cpu())[0]
            for n in (h, w))
    u, v = (t.contiguous().to(device=device, dtype=dtype) for t in (u, v))
    return {"U": u, "V": v, "U_hat": u.clone(), "V_hat": v.clone()}


def encode_2d(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x [..., h, w, c] -> z [..., r, r, c]`` (Z = U^T X V, per channel)."""
    return torch.einsum("hr,...hwc,ws->...rsc", params["U"].to(x.dtype), x,
                        params["V"].to(x.dtype))


def decode_2d(params: Dict, z: torch.Tensor) -> torch.Tensor:
    """``z [..., r, r, c] -> x_hat [..., h, w, c]`` (X_hat = U_hat Z V_hat^T)."""
    return torch.einsum("hr,...rsc,ws->...hwc", params["U_hat"].to(z.dtype), z,
                        params["V_hat"].to(z.dtype))


# -- the int8 range codec (the reference's beyond-paper alternative) ---------


def quantize_int8(x: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along ``axis``: (codes, f32 scale = max|x| / 127,
    at least 1e-12), codes rounded half to even and clipped to ±127."""
    xf = x.float()
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # reciprocal, one ulp off the reference's quotient
    scale = (xf.abs().amax(dim=axis, keepdim=True)
             / torch.tensor(127.0, device=x.device)).clamp_min(1e-12)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


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
