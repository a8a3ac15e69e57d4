"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.

  paged_attention — fused paged decode / chunk attention (CUDA C++,
                    ``csrc/paged_attention.cu``)
  group_gate      — fused HL-GGN group gate, eq. 5-7 (CUDA C++,
                    ``csrc/group_gate.cu``)
  expert_mlp      — grouped expert FFN over expert-sorted rows (CUDA C++,
                    ``csrc/expert_mlp.cu``)
  lowrank         — eq. 8 low-rank codec: encode, decode and the fused
                    roundtrip with its error sum (CUDA C++,
                    ``csrc/lowrank.cu``)
  flash_attention — full-sequence causal GQA attention forward with
                    sliding window (CUDA C++, ``csrc/flash_attention.cu``)
  quant           — symmetric int8 quantize / dequantize of rows or columns
                    with the scale rounded to its storage type, and the int8
                    KV pools' quantize-and-write of a layer's k and v through
                    the page table (CUDA C++, ``csrc/quant.cu``)

The paged attention and the resident expert FFN each have an int8 variant
(``paged_attention_quant``, ``grouped_mlp_resident_quant``) that reads int8
codes with their scales and dequantizes in registers.

Each wrapper runs the plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises); it counts its launches in ``<wrapper>.launches``.
Nothing is built with ``nvcc`` until a kernel is first launched
(``kernels.build``).
"""
