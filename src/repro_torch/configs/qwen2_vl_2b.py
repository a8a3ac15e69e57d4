"""Qwen2-VL-2B — VLM backbone with M-RoPE; vision frontend stubbed.

[arXiv:2409.12191; hf]  28L, d_model=1536, 12 heads (GQA kv=2,
head_dim=128), d_ff=8960, vocab=151936.  M-RoPE splits each rotary
half-dimension into (temporal, height, width) = (16, 24, 24) sections.
The ViT frontend + dynamic-resolution merger is a STUB: ``Model.prefill``
takes precomputed patch embeddings [B, P, d], spliced in front of the token
embeddings, with per-position 3D M-RoPE indices [B, 3, P + S].
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    layer_pattern=(LayerSpec(kind="attn"),),
    mrope_sections=(16, 24, 24),
    vision_patches=256,
    rope_theta=1000000.0,
    mesh_policy="fsdp",
    serve_mesh_policy="serve_tp",
)
