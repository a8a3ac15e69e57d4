"""Switch-Base, the paper's own evaluation model (Switch Transformer,
arXiv:2101.03961): 12 layers, d_model 768, 12 heads, d_ff 3072, as a
decoder-only stack with MoE on every other FFN (8 experts in 4 groups,
top-1, non-gated GELU)."""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="switch-base",
    family="moe",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=32128,
    layer_pattern=(LayerSpec(kind="attn"), LayerSpec(kind="attn", moe=True)),
    moe=MoEConfig(
        num_experts=8,
        top_k=1,
        d_ff_expert=3072,
        num_groups=4,
        capacity_factor=1.25,
    ),
    act="gelu",
    ffn_gated=False,
    rope_theta=10000.0,
)
