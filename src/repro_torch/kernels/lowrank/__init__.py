from repro_torch.kernels.lowrank.ops import (
    codec_quant_plan,
    lowrank_decode,
    lowrank_decode_quant,
    lowrank_decode_quant_plain,
    lowrank_encode,
    lowrank_encode_quant,
    lowrank_encode_quant_plain,
    lowrank_project_plain,
    lowrank_roundtrip,
    lowrank_roundtrip_plain,
)

__all__ = [
    "codec_quant_plan",
    "lowrank_decode",
    "lowrank_decode_quant",
    "lowrank_decode_quant_plain",
    "lowrank_encode",
    "lowrank_encode_quant",
    "lowrank_encode_quant_plain",
    "lowrank_project_plain",
    "lowrank_roundtrip",
    "lowrank_roundtrip_plain",
]
