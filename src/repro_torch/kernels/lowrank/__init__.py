from repro_torch.kernels.lowrank.ops import (
    lowrank_decode,
    lowrank_encode,
    lowrank_project_plain,
    lowrank_roundtrip,
    lowrank_roundtrip_plain,
)

__all__ = [
    "lowrank_decode",
    "lowrank_encode",
    "lowrank_project_plain",
    "lowrank_roundtrip",
    "lowrank_roundtrip_plain",
]
