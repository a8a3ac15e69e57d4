"""H2O-Danube-3-4B — dense llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]  24L, d_model=3840, 32 heads (GQA kv=8),
d_ff=10240, vocab=32000.  SWA window 4096 (mistral-style), which makes the
long_500k decode cell applicable (window-bounded KV cache).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    layer_pattern=(LayerSpec(kind="attn"),),
    sliding_window=4096,
    rope_theta=500000.0,
    mesh_policy="fsdp",
    serve_mesh_policy="serve_tp",
)
