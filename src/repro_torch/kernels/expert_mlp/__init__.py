from repro_torch.kernels.expert_mlp.ops import (
    ffn_plan,
    grouped_mlp,
    grouped_mlp_plain,
    grouped_mlp_resident,
    grouped_mlp_resident_plain,
    grouped_mlp_resident_quant,
    grouped_mlp_resident_quant_plain,
)

__all__ = [
    "ffn_plan",
    "grouped_mlp",
    "grouped_mlp_plain",
    "grouped_mlp_resident",
    "grouped_mlp_resident_plain",
    "grouped_mlp_resident_quant",
    "grouped_mlp_resident_quant_plain",
]
