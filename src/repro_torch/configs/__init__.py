"""Architecture registry of the port: the reference's ``get_config`` and
``smoke_config`` over the configs the port serves and tests."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import (
    h2o_danube_3_4b,
    internlm2_20b,
    jamba_1_5_large_398b,
    llama4_scout_17b_16e,
    mamba2_130m,
    qwen2_vl_2b,
    qwen3_14b,
    qwen3_moe_235b_a22b,
    switch_base,
    tinyllama_1_1b,
    whisper_base,
)
from repro_torch.configs.base import (
    CompressionConfig,
    LayerSpec,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (jamba_1_5_large_398b, h2o_danube_3_4b, tinyllama_1_1b, internlm2_20b,
              qwen3_14b, llama4_scout_17b_16e, qwen3_moe_235b_a22b, whisper_base,
              qwen2_vl_2b, mamba2_130m, switch_base)
}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    return cfg.replace(**overrides) if overrides else cfg


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config to a CPU-runnable size, keeping its structure (layer
    pattern, MoE grouping, SSM-ness, enc-dec-ness, M-RoPE and patches); the reference's
    ``smoke_config``."""
    kw = dict(
        num_layers=len(cfg.layer_pattern),
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        attn_chunk_q=64,
        attn_chunk_kv=64,
        sliding_window=96 if cfg.sliding_window else None,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            num_groups=min(cfg.moe.num_groups, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=128,
            capacity_factor=2.0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=32, chunk_size=32
        )
    if cfg.encoder_decoder:
        kw["encoder_layers"] = 2
        kw["encoder_seq_len"] = 64
    if cfg.vision_patches:
        kw["vision_patches"] = 16
    if cfg.mrope_sections is not None:
        kw["mrope_sections"] = (4, 6, 6)  # sums to head_dim/2 = 16
    if cfg.compression is not None and cfg.compression.rank > 0:
        kw["compression"] = dataclasses.replace(
            cfg.compression, rank=min(cfg.compression.rank, 128 // 2)
        )
    return cfg.replace(**kw)


__all__ = [
    "ARCHS",
    "CompressionConfig",
    "LayerSpec",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "get_config",
    "smoke_config",
]
