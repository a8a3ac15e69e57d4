"""TinyLlama-1.1B (arXiv:2401.02385): 22 layers, d_model 2048, 32 heads
(GQA kv=4), d_ff 5632, vocab 32000.  The dense parity config."""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    layer_pattern=(LayerSpec(kind="attn"),),
    rope_theta=10000.0,
    mesh_policy="fsdp",
    serve_mesh_policy="serve_tp",
)
