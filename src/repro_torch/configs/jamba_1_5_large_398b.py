"""Jamba-1.5-Large (398B): hybrid Mamba + attention at 1:7, with MoE.

[arXiv:2403.19887]  72 layers, d_model 8192, 64 heads (GQA, 8 kv heads),
d_ff 24576, vocab 65536, MoE of 16 experts top-2 on every other layer.  The
attention layer sits at position 4 of each 8-layer block; the MoE FFNs at
the odd positions.  Jamba's Mamba-1 layers (d_state 16) are realised with
the SSD layer, as in the reference.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig, SSMConfig

_PATTERN = tuple(
    LayerSpec(kind=("attn" if i == 4 else "ssm"), moe=(i % 2 == 1))
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern=_PATTERN,
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_ff_expert=24576,
        num_groups=4,
        capacity_factor=1.25,
    ),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, chunk_size=256),
    rope_theta=10000.0,
    optimizer="adafactor",
    grad_accum=1,
)
