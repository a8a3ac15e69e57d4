"""Route-aware pipeline split (paper eq. 9-11), the port's own copy of the
split search in the reference's ``core/pipeline.py``.

The objective (eq. 9) weighs compute time against communication; in its
pipeline reading the model's blocks are cut at one split point, blocks
``[0, split)`` run on the end tier and the rest on the cloud, and the
boundary activation may be compressed (eq. 8).  The estimates come from
the capability model (``core.hardware``): they are modeled times that
steer the search, not measurements.  Replanning re-runs the search
against measured link conditions (``BandwidthEstimator``,
``replan_pipeline``) with hysteresis (``should_replan``).  The draft
length of speculative decode is planned from the same estimates
(``plan_spec_k``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

from repro_torch.core.hardware import Capability


@dataclass(frozen=True)
class PipelinePlan:
    """Where each layer runs and what crosses the boundary."""

    split_layer: int  # layers [0, split) on end/stage-0, rest on cloud
    compress_boundary: bool
    est_end_time_s: float
    est_cloud_time_s: float
    est_comm_time_s: float

    @property
    def est_step_time_s(self) -> float:
        # Steady-state pipelined throughput is bounded by the slowest stage.
        return max(self.est_end_time_s, self.est_cloud_time_s, self.est_comm_time_s)

    @property
    def est_latency_s(self) -> float:
        return self.est_end_time_s + self.est_comm_time_s + self.est_cloud_time_s


def plan_pipeline_split(
    layer_gflops: Sequence[float],
    boundary_bytes: float,
    end_cap: Capability,
    cloud_cap: Capability,
    *,
    compression_ratio: float = 1.0,
    alpha: float = 0.5,
    end_servers: int = 1,
    cloud_servers: int = 1,
    edge_boundary: bool = False,
    pin_split: Optional[int] = None,
    pin_compress: Optional[bool] = None,
) -> PipelinePlan:
    """Pick the layer split (and whether to compress the boundary) that
    minimizes the eq. 9 objective in its pipeline reading: weighted sum of
    bottleneck stage time (throughput) and boundary comm (latency).

    With ``end_servers`` / ``cloud_servers`` the throughput bottleneck
    compares per-fleet stage rates while latency uses per-request times.
    ``edge_boundary=True`` models executors whose edge splits still ship an
    activation (the embedding stays on the end and the LM head on the
    cloud, so d_model bytes cross the wire even at split 0 or n,
    uncompressed: the codec applies only to interior splits).
    ``pin_split`` / ``pin_compress`` restrict the search to one split /
    compress choice, so the estimates come from the same formulas as the
    free search.
    """
    n = len(layer_gflops)
    if pin_split is not None and not 0 <= pin_split <= n:
        raise ValueError(f"pin_split={pin_split} outside [0, {n}]")
    best: Optional[PipelinePlan] = None
    best_score = None
    splits = range(0, n + 1) if pin_split is None else (pin_split,)
    compress_opts = (False, True) if pin_compress is None else (pin_compress,)
    for compress in compress_opts:
        for split in splits:
            interior = 0 < split < n
            ratio = compression_ratio if (compress and interior) else 1.0
            ct = boundary_bytes * ratio * 8.0 / max(end_cap.net_gbps * 1e9, 1e-9)
            end_t = sum(layer_gflops[:split]) / max(end_cap.gflop_budget * 1e3, 1e-9)
            cloud_t = sum(layer_gflops[split:]) / max(
                cloud_cap.gflop_budget * 1e3, 1e-9
            )
            comm = ct if (interior or edge_boundary) else 0.0
            plan = PipelinePlan(split, compress and interior, end_t, cloud_t, comm)
            bottleneck = max(
                end_t / max(end_servers, 1),
                cloud_t / max(cloud_servers, 1),
                comm,
            )
            score = alpha * bottleneck + (1 - alpha) * (comm + 0.01 * plan.est_latency_s)
            if best is None or score < best_score:
                best, best_score = plan, score
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# Replanning (dynamic load and network, paper figs. 7-8)
# ---------------------------------------------------------------------------


@dataclass
class BandwidthEstimator:
    """EWMA estimate of the effective end<->cloud link rate, fed direct
    rate observations (``observe_rate``) or declared rates (``set_rate``);
    consumers replan when the estimate drifts from the rate the current
    plan was computed against."""

    nominal_gbps: float
    ewma: float = 0.3  # weight of the newest sample
    _estimate: Optional[float] = None

    def observe_rate(self, gbps: float) -> float:
        if self._estimate is None:
            self._estimate = gbps
        else:
            self._estimate = (1 - self.ewma) * self._estimate + self.ewma * gbps
        return self.gbps

    def set_rate(self, gbps: float) -> float:
        """Hard assignment, bypassing the EWMA: a *declared* link event (a
        blackout beginning or ending) is a fact, not a noisy sample."""
        self._estimate = gbps
        return self.gbps

    @property
    def gbps(self) -> float:
        return self._estimate if self._estimate is not None else self.nominal_gbps


def should_replan(current: PipelinePlan, proposed: PipelinePlan, *,
                  rel_threshold: float = 0.15) -> bool:
    """True when the proposed steady-state step time beats the current one
    by more than ``rel_threshold`` (the hysteresis that keeps a noisy
    estimate near a split tie from thrashing the pipeline)."""
    cur = max(current.est_step_time_s, 1e-12)
    return (cur - proposed.est_step_time_s) / cur > rel_threshold


def replan_pipeline(
    current: PipelinePlan,
    layer_gflops: Sequence[float],
    boundary_bytes: float,
    end_cap: Capability,
    cloud_cap: Capability,
    *,
    measured_gbps: Optional[float] = None,
    compression_ratio: float = 1.0,
    alpha: float = 0.5,
    rel_threshold: float = 0.15,
    edge_boundary: bool = False,
) -> Tuple[PipelinePlan, bool]:
    """Re-run the split search against measured conditions.  The incumbent
    is re-evaluated first under the same conditions (split and compress
    pinned), so stale estimates never bias the comparison.  Returns
    ``(plan, changed)``: adopt ``plan`` when ``changed``; otherwise ``plan``
    is the incumbent's split and compress choice with refreshed estimates.
    ``measured_gbps`` overrides the capability's nominal uplink."""
    if measured_gbps is not None:
        end_cap = replace(end_cap, net_gbps=measured_gbps)
    kwargs = dict(compression_ratio=compression_ratio, alpha=alpha,
                  edge_boundary=edge_boundary)
    refreshed = plan_pipeline_split(
        layer_gflops, boundary_bytes, end_cap, cloud_cap,
        pin_split=current.split_layer, pin_compress=current.compress_boundary,
        **kwargs,
    )
    proposed = plan_pipeline_split(layer_gflops, boundary_bytes, end_cap, cloud_cap, **kwargs)
    if should_replan(refreshed, proposed, rel_threshold=rel_threshold):
        return proposed, True
    return refreshed, False


def plan_spec_k(
    layer_gflops: Sequence[float],
    boundary_bytes: float,
    end_cap: Capability,
    cloud_cap: Capability,
    *,
    split: int,
    link_rtt_s: float = 0.0,
    measured_gbps: Optional[float] = None,
    compression_ratio: float = 1.0,
    acceptance: float = 0.7,
    k_max: int = 8,
    min_gain: float = 1.1,
) -> int:
    """Speculative draft length k for the current plan, or 1 to turn
    speculation off.  A plain round pays end chunk + RTT + boundary wire +
    cloud chunk for one token; a speculative round adds k full-stack draft
    steps on the end tier and spreads the round over ``1 + acceptance *
    (k - 1)`` expected tokens.  Candidates are powers of two up to
    ``k_max``; a best rate under ``min_gain`` times the plain rate gives 1
    (the compute-bound regime: no speculative machinery at all)."""
    n = len(layer_gflops)
    if not 0 <= split <= n:
        raise ValueError(f"split={split} outside [0, {n}]")
    gbps = measured_gbps if measured_gbps is not None else end_cap.net_gbps
    end_rate = max(end_cap.gflop_budget * 1e3, 1e-9)
    cloud_rate = max(cloud_cap.gflop_budget * 1e3, 1e-9)
    draft_s = sum(layer_gflops) / end_rate
    end_tok_s = sum(layer_gflops[:split]) / end_rate
    cloud_tok_s = sum(layer_gflops[split:]) / cloud_rate
    wire_s_per_tok = boundary_bytes * compression_ratio * 8.0 / max(gbps * 1e9, 1e-9)

    def round_s(k: int) -> float:
        draft = k * draft_s if k > 1 else 0.0  # k = 1: the plain round
        return draft + k * end_tok_s + link_rtt_s + k * wire_s_per_tok + k * cloud_tok_s

    base_rate = 1.0 / max(round_s(1), 1e-12)
    best_k, best_rate = 1, base_rate
    k = 2
    while k <= k_max:
        rate = (1.0 + acceptance * (k - 1)) / max(round_s(k), 1e-12)
        if rate > best_rate:
            best_k, best_rate = k, rate
        k *= 2
    if best_k > 1 and best_rate < min_gain * base_rate:
        return 1
    return best_k
