"""PyTorch/CUDA port of the EC2MoE serving path.

The JAX package ``repro`` is the reference; this package imports nothing of
it (nor JAX) and keeps the reference's module names and layouts so each
counterpart can be found: params are dicts stacked over blocks
``[n_blocks, ...]``, KV page pools are ``[n_blocks, P+1, ps, KV, hd]`` with
the garbage page last.  Every entry point takes an explicit ``device``
(default ``"cuda"``); on the card the hot spots run hand-written Hopper
kernels (``repro_torch.kernels``), on the CPU their plain PyTorch versions.
"""

import torch

# The reference computes float32 products in full float32; TF32 would keep
# only ~3 decimal digits, so both switches are pinned off explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"
