"""Qwen3-MoE-235B-A22B — 128-expert top-8 MoE with QK-norm.

[hf:Qwen/Qwen3-30B-A3B; hf]  94L, d_model=4096, 64 heads (GQA kv=4,
head_dim=128), expert d_ff=1536, vocab=151936, 128 experts top-8, no shared
expert, every layer MoE.

This is the arch most representative of HL-GGN: 128 experts split into
K=16 groups of 8 maps groups one-to-one onto a 16-way expert-parallel axis,
so stage-1 (group) routing doubles as dispatch-shard selection.
"""

from repro_torch.configs.base import CompressionConfig, LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,  # no dense FFN layers; all layers MoE
    vocab_size=151936,
    layer_pattern=(LayerSpec(kind="attn", moe=True),),
    moe=MoEConfig(
        num_experts=128,
        top_k=8,
        d_ff_expert=1536,
        num_groups=16,
        capacity_factor=1.25,
    ),
    qk_norm=True,
    rope_theta=1000000.0,
    optimizer="adafactor",
    grad_accum=2,
    mesh_policy="seqp",
    serve_mesh_policy="seqp",
    # PO-ECC low-rank compression on the EP dispatch boundary (eq. 8):
    # rank d/4 quarters the all-to-all wire bytes; trained jointly.
    compression=CompressionConfig(rank=1024, boundaries=("dispatch",), recon_weight=0.05),
)
