"""Whisper-base — encoder-decoder with a (stubbed) conv audio frontend.

[arXiv:2212.04356; unverified]  6 decoder layers (self + cross attention)
over a 6-layer bidirectional encoder; d_model=512, 8 heads (MHA), d_ff=2048,
vocab=51865.  The conv frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings [B, 1500, d] (see assignment note).  Whisper
uses non-gated GELU FFNs and learned positions; we keep GELU + RoPE-free
sinusoidal-equivalent (learned) positions for the backbone.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    layer_pattern=(LayerSpec(kind="attn", cross_attn=True),),
    encoder_decoder=True,
    encoder_layers=6,
    encoder_seq_len=1500,
    act="gelu",
    ffn_gated=False,
    rope_theta=10000.0,
    mesh_policy="dp",
    serve_mesh_policy="dp",
)
