"""Hardware-aware local expert selection (paper eq. 4) and expert-mask
validation at the engine boundary (the port's own copy of the reference's
``core/selection.py``: ``local_expert_mask``, ``end_mask_for``,
``group_priority_from_freq``, ``validate_expert_mask`` and the fleet's
``fleet_device_mask`` / ``shard_masks_for_fleet``).

    E_local = { e_i | f(V_expert_i, T_capability) <= eps }

capped at ``local_selection_cap`` of the expert set.  Experts are admitted
greedily by whole groups, so the selected set stays aligned with the
HL-GGN group structure.  Masks are boolean ``[E]`` numpy arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.hardware import (
    Capability,
    DeviceProfile,
    DeviceState,
    ExpertComplexity,
    capability,
    complexity_match,
    expert_complexity,
)


def local_expert_mask(
    v: ExpertComplexity,
    cap: Capability,
    num_experts: int,
    num_groups: int,
    *,
    eps: float = 1.0,
    selection_cap: float = 0.4,
    group_priority: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Boolean [E] mask of experts admitted for local (end-side) evaluation.

    ``group_priority``: group indices in decreasing preference; defaults to
    natural order."""
    E, K = num_experts, num_groups
    Mk = E // K
    max_local = int(np.floor(selection_cap * E))
    mask = np.zeros((E,), bool)
    order = list(group_priority) if group_priority is not None else list(range(K))
    n_resident = 0
    for g in order:
        for j in range(Mk):
            if n_resident >= max_local:
                return mask
            if complexity_match(v, cap, n_resident) <= eps:
                mask[g * Mk + j] = True
                n_resident += 1
            else:
                return mask
    return mask


def end_mask_for(
    profile: DeviceProfile,
    state: DeviceState,
    d_model: int,
    d_ff_expert: int,
    num_experts: int,
    num_groups: int,
    *,
    gated: bool = True,
    eps: float = 1.0,
    selection_cap: float = 0.4,
    group_priority: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Profile + state -> expert mask (the full eq. 2-4 path)."""
    cap = capability(profile, state)
    v = expert_complexity(d_model, d_ff_expert, gated)
    return local_expert_mask(
        v, cap, num_experts, num_groups, eps=eps, selection_cap=selection_cap,
        group_priority=group_priority,
    )


def group_priority_from_freq(group_freq: Optional[np.ndarray], num_groups: int,
                             group_cost: Optional[np.ndarray] = None) -> Sequence[int]:
    """Group order for the eq. 4 greedy admit from *measured* stage-1
    routing frequencies (the serving engine's EMA of the gate's
    ``group_frac``): most-routed group first, stable natural order on ties,
    and exactly natural order before anything has been measured.

    ``group_cost`` ([K] >= 0) is the fleet expert registry's modeled wire
    seconds to make each group resident; both signals are normalized to sum
    1 and the score is ``freq - 0.5 * cost``, so among similarly routed
    groups the cheap-to-place ones are admitted first.  All-zero costs leave
    the frequency order as it is."""
    if group_freq is None:
        return list(range(num_groups))
    f = np.asarray(group_freq, np.float64)
    if f.shape != (num_groups,) or not np.isfinite(f).all():
        return list(range(num_groups))
    score = f / s if (s := float(f.sum())) > 0 else f
    if group_cost is not None:
        c = np.asarray(group_cost, np.float64)
        if c.shape == (num_groups,) and np.isfinite(c).all() and c.sum() > 0:
            score = score - 0.5 * c / float(c.sum())
    return [int(g) for g in np.argsort(-score, kind="stable")]


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


def fleet_device_mask(profile: DeviceProfile, state: DeviceState, d_model: int,
                      d_ff_expert: int, num_experts: int, num_groups: int, **kw) -> np.ndarray:
    """One fleet device's mask: the eq. 2-4 mask with the fleet's never-empty
    guarantee (a device whose budget admits no expert still exposes its
    first one)."""
    m = end_mask_for(profile, state, d_model, d_ff_expert, num_experts, num_groups, **kw)
    if not m.any():
        m = m.copy()
        m[0] = True
    return m


def shard_masks_for_fleet(profiles: Sequence[DeviceProfile], states: Sequence[DeviceState],
                          d_model: int, d_ff_expert: int, num_experts: int, num_groups: int,
                          **kw) -> np.ndarray:
    """One mask a fleet device, ``[n_devices, E]``."""
    return np.stack([
        fleet_device_mask(p, s, d_model, d_ff_expert, num_experts, num_groups, **kw)
        for p, s in zip(profiles, states)
    ])
