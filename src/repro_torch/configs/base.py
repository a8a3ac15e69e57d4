"""Configuration dataclasses of the PyTorch port.

A copy of the reference package's ``repro/configs/base.py``, cut to what the
port runs: a model is ``block_repeat`` copies of ``layer_pattern`` (a tuple
of :class:`LayerSpec`), and the port's transformer loops over the stacked
block parameters.  Field names and defaults are the reference's, so a
config built here compares equal field by field with its reference twin
(``tests/test_torch_configs.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts + HL-GGN (group gate, eq. 5-7) configuration.

    ``num_groups`` is K: experts split into K groups, each with its own
    softmax gate, and a K-way global gate over groups."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    num_groups: int = 1
    # 0 = soft (eq. 7 product, top-k over all experts); g > 0 = only experts
    # in the top-g groups are eligible
    group_top_k: int = 0
    shared_experts: int = 0  # always-on experts (llama4-style)
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 1.0
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    local_selection_cap: float = 0.4

    def __post_init__(self):
        if self.num_experts % self.num_groups != 0:
            raise ValueError(
                f"num_experts={self.num_experts} not divisible by "
                f"num_groups={self.num_groups}"
            )

    @property
    def experts_per_group(self) -> int:
        return self.num_experts // self.num_groups


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) configuration."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 128  # SSD chunk length (intra-chunk quadratic)
    n_groups: int = 1  # B/C groups (Mamba-2 "G")
    head_block: int = 8  # heads processed per step (bounds the [Q, Q, hb] buffer)


@dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating block pattern."""

    kind: str = "attn"  # "attn" | "ssm"
    moe: bool = False
    cross_attn: bool = False


@dataclass(frozen=True)
class CompressionConfig:
    """PO-ECC low-rank compression (eq. 8) of cross-boundary traffic."""

    rank: int = 0  # 0 = disabled
    boundaries: Tuple[str, ...] = ("pipeline",)
    recon_weight: float = 1.0
    task_weight: float = 1.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    compression: Optional[CompressionConfig] = None

    qk_norm: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, ...]] = None

    encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0
    vision_patches: int = 0

    norm_eps: float = 1e-6
    act: str = "silu"  # silu | gelu | relu
    ffn_gated: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    dtype: str = "bfloat16"  # activation dtype
    param_dtype: str = "float32"

    attn_chunk_q: int = 512
    attn_chunk_kv: int = 512
    moe_impl: str = "auto"  # the port runs "sorted" (auto) and "naive"

    optimizer: str = "adamw"
    grad_accum: int = 1
    seq_parallel: bool = False
    mesh_policy: str = "tp"
    serve_mesh_policy: str = "tp"

    def __post_init__(self):
        if self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not a multiple of "
                f"pattern length {len(self.layer_pattern)}"
            )
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if any(s.moe for s in self.layer_pattern) and self.moe is None:
            raise ValueError(f"{self.name}: pattern has MoE layers but moe=None")

    @property
    def padded_vocab_size(self) -> int:
        """Vocab rounded up to a multiple of 512; the tail columns are masked
        to -1e30 in ``lm_logits``."""
        pad = 512
        return -(-self.vocab_size // pad) * pad

    @property
    def block_repeat(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size  # lm head
        n += d  # final norm

        def attn_params() -> int:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            qk = 2 * hd if self.qk_norm else 0
            return q + kv + o + qk

        n_mats = 3 if self.ffn_gated else 2

        def dense_ffn() -> int:
            return n_mats * d * self.d_ff

        def moe_ffn() -> int:
            m = self.moe
            e = m.num_experts * n_mats * d * m.d_ff_expert
            e += m.shared_experts * n_mats * d * m.d_ff_expert
            # group gate: K group gates (M_k x d each) + global gate (K x d)
            e += m.num_experts * d + m.num_groups * d
            return e

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            # in_proj -> [z, x, B, C, dt], conv, A, D, norm, out_proj
            zxbcdt = d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
            conv = (d_in + 2 * s.n_groups * s.d_state) * s.d_conv
            return zxbcdt + conv + 2 * nheads + d_in + d_in * d

        per_pattern = 0
        for spec in self.layer_pattern:
            per_pattern += 2 * d  # two norms
            if spec.kind == "attn":
                per_pattern += attn_params()
                if spec.cross_attn:
                    per_pattern += attn_params() + d
            else:
                per_pattern += ssm_params()
            if spec.kind != "ssm":  # ssm blocks subsume the FFN (d_ff=0 models)
                per_pattern += moe_ffn() if spec.moe else (dense_ffn() if self.d_ff else 0)
            elif spec.moe:
                per_pattern += moe_ffn()
            elif self.d_ff:
                per_pattern += dense_ffn()
        n += per_pattern * self.block_repeat
        if self.encoder_decoder:
            n += self.encoder_layers * (2 * d + attn_params() + dense_ffn())
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive_frac = 1.0 - (m.top_k + m.shared_experts) / (
            m.num_experts + m.shared_experts
        )
        n_mats = 3 if self.ffn_gated else 2
        expert_params = m.num_experts * n_mats * self.d_model * m.d_ff_expert
        n_moe_layers = sum(1 for s in self.layer_pattern if s.moe) * self.block_repeat
        return self.param_count() - int(
            n_moe_layers * expert_params * inactive_frac
        )

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
