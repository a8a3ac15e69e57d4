"""Qwen3-14B — dense GQA model with QK-norm.

[hf:Qwen/Qwen3-8B; hf]  40L, d_model=5120, 40 heads (GQA kv=8, head_dim=128),
d_ff=17408, vocab=151936.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    layer_pattern=(LayerSpec(kind="attn"),),
    qk_norm=True,
    rope_theta=1000000.0,
    mesh_policy="fsdp",
    serve_mesh_policy="serve_tp",
)
