"""Hardware-aware capability model (paper eq. 2-3), the port's own copy of
the reference's ``core/hardware.py`` (numpy only).

A device's real-time state vector S_device = {C_cpu, M_mem, P_power,
B_bandwidth} (eq. 2) maps through a calibrated linear model H to an
inference-capability threshold T = H(S) (eq. 3): a compute budget (GFLOP
per token), a memory budget for resident expert weights, and the effective
uplink.  The profiles below are *modeled* inputs to the split search and
the expert selection, not measurements of any device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class DeviceProfile:
    """Static description of a device class."""

    name: str
    peak_gflops: float  # achievable dense-matmul throughput
    mem_gb: float  # memory capacity available to weights
    mem_bw_gbs: float  # memory bandwidth
    net_gbps: float  # link bandwidth to the other tier
    power_w: float = 100.0  # power budget


# Calibration anchors, as in the reference (public spec sheets).
PROFILES: Dict[str, DeviceProfile] = {
    # The paper's testbed: Xeon Silver 4214R ends + A100 cloud, 300 Mbps link.
    "xeon-4214r": DeviceProfile("xeon-4214r", 1300.0, 64.0, 94.0, 0.3),
    "a100": DeviceProfile("a100", 312000.0, 80.0, 2039.0, 0.3),
    # Edge-class devices for heterogeneity sweeps.
    "jetson-orin": DeviceProfile("jetson-orin", 10000.0, 16.0, 102.0, 0.1),
    "phone-soc": DeviceProfile("phone-soc", 2000.0, 6.0, 51.0, 0.05, power_w=8.0),
    "tpu-v5e": DeviceProfile("tpu-v5e", 197000.0, 16.0, 819.0, 50.0),
}


@dataclass(frozen=True)
class DeviceState:
    """Real-time state vector S_device (eq. 2), as utilization fractions."""

    cpu_free: float = 1.0  # C_cpu   — fraction of compute currently free
    mem_free: float = 1.0  # M_mem   — fraction of memory currently free
    power_free: float = 1.0  # P_power — fraction of power budget available
    bandwidth_free: float = 1.0  # B_bw — fraction of nominal link available

    def as_vector(self) -> np.ndarray:
        return np.array(
            [self.cpu_free, self.mem_free, self.power_free, self.bandwidth_free],
            np.float64,
        )


@dataclass(frozen=True)
class Capability:
    """T_capability (eq. 3): budgets the selection mechanism checks against."""

    gflop_budget: float  # per-token compute budget
    mem_budget_gb: float  # resident expert-weight budget
    net_gbps: float  # effective uplink


# H(.) weights: how strongly each state component modulates each budget.
_H_COMPUTE = np.array([0.30, 0.00, 0.70, 0.00])  # cpu, mem, power, bw
_H_MEMORY = np.array([0.00, 1.00, 0.00, 0.00])


def capability(profile: DeviceProfile, state: DeviceState) -> Capability:
    """T = H(S_device)  (eq. 3)."""
    s = state.as_vector()
    compute_scale = float(_H_COMPUTE @ s)  # in [0, 1]
    mem_scale = float(_H_MEMORY @ s)
    return Capability(
        gflop_budget=profile.peak_gflops * 0.30 * compute_scale * 1e-3,
        mem_budget_gb=profile.mem_gb * mem_scale,
        net_gbps=profile.net_gbps * state.bandwidth_free,
    )


@dataclass(frozen=True)
class ExpertComplexity:
    """V_expert (paper): per-expert complexity characteristics."""

    gflop_per_token: float
    weight_bytes: int


def expert_complexity(d_model: int, d_ff: int, gated: bool = True) -> ExpertComplexity:
    mats = 3 if gated else 2
    return ExpertComplexity(
        gflop_per_token=2.0 * mats * d_model * d_ff * 1e-9,
        weight_bytes=mats * d_model * d_ff * 2,  # bf16
    )


def complexity_match(v: ExpertComplexity, t: Capability, n_resident: int) -> float:
    """f(V_expert, T_capability) (eq. 4): a scalar 'overload' score.  <= eps
    means the expert can join the locally-evaluated set given ``n_resident``
    experts already selected."""
    compute_load = v.gflop_per_token / max(t.gflop_budget, 1e-12)
    mem_load = (n_resident + 1) * v.weight_bytes / max(
        t.mem_budget_gb * 1e9, 1.0
    )
    return max(compute_load, mem_load)
