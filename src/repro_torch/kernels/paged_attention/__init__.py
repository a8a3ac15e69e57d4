from repro_torch.kernels.paged_attention.ops import (
    paged_attention,
    paged_attention_plain,
    paged_attention_quant,
)

__all__ = ["paged_attention", "paged_attention_plain", "paged_attention_quant"]
