"""Expert-mask validation at the engine boundary (the port's own copy of the
reference's ``core/selection.py::validate_expert_mask``)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def validate_expert_mask(mask, num_experts: Optional[int] = None, *,
                         where: str = "end tier"):
    """Reject an expert mask that selects no experts, or has the wrong
    shape.  An all-False mask would make the gate renormalize to uniform
    weights over the very experts it excluded.  ``None`` passes through."""
    if mask is None:
        return None
    m = np.asarray(mask)
    if m.ndim != 1:
        raise ValueError(f"{where}: expert mask must be 1-D [E], got shape {m.shape}")
    if num_experts is not None and m.shape[0] != num_experts:
        raise ValueError(
            f"{where}: expert mask has {m.shape[0]} entries for {num_experts} experts"
        )
    if not m.astype(bool).any():
        raise ValueError(
            f"{where}: expert mask selects no experts — the gate would "
            "silently renormalize to uniform weights over the excluded "
            "experts; widen the selection or drop the mask entirely"
        )
    return mask
