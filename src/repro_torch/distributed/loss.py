"""The language-model loss at the model's output (port of the reference's
``distributed/loss.py``: its single-device branch).

The reference's vocabulary-sharded branch (local max / sum-exp / label hit
combined over the model axis) needs a device mesh and comes with ROADMAP
item 8b.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers import cross_entropy_loss


def sharded_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, topo=None,
                          z_weight: float = 1e-4) -> Tuple[torch.Tensor, Dict]:
    """Cross-entropy with the z-term over ``logits [B, S, V]``: on one
    device (no ``topo``, or one of one device) exactly
    ``layers.cross_entropy_loss``."""
    if topo is not None and topo.num_devices > 1:
        raise NotImplementedError(
            "the vocabulary-sharded cross-entropy needs a device mesh (ROADMAP item 8b)")
    return cross_entropy_loss(logits, labels, z_weight)
