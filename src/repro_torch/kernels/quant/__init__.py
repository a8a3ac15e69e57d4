from repro_torch.kernels.quant.ops import (
    SCALE_FLOOR,
    cols_plan,
    dequantize_rows,
    dequantize_rows_plain,
    paged_write_quant,
    quantize_rows,
    quantize_rows_plain,
)

__all__ = [
    "SCALE_FLOOR",
    "cols_plan",
    "dequantize_rows",
    "dequantize_rows_plain",
    "paged_write_quant",
    "quantize_rows",
    "quantize_rows_plain",
]
