"""Mamba2-130M: attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060]  24 layers, d_model 768, vocab 50280, ssm_state 128,
expand 2 (d_inner 1536, 24 heads of 64), no FFN, tied embeddings.  Decode
carries a constant-size recurrent state instead of a KV cache.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=(LayerSpec(kind="ssm"),),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=256),
    tie_embeddings=True,
    mesh_policy="dp",
    serve_mesh_policy="dp",
)
