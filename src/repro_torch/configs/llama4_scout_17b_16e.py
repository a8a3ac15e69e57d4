"""Llama-4-Scout-17B-16E: 48 layers, d_model 5120, 40 heads (GQA kv=8),
every layer MoE with 16 experts (top-1) in 4 groups plus one shared
expert.  The MoE parity config."""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=(LayerSpec(kind="attn", moe=True),),
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        num_groups=4,
        shared_experts=1,
        capacity_factor=1.25,
    ),
    rope_theta=500000.0,
    optimizer="adafactor",
    mesh_policy="seqp",
    serve_mesh_policy="seqp",
)
