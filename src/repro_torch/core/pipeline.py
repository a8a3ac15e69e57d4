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

The fleet reading (N heterogeneous end devices sharing one cloud tier):
each device plans its split against its share of the cloud
(``fleet_cloud_share``, ``plan_fleet_splits``), and requests are placed
across devices by the eq. 9 marginal cost (``place_fleet``, built on the
eq. 10 ``priority`` and the ``Task`` / ``SchedulerConfig`` records).  A
peer expert-slab fetch between two end devices is priced over the modeled
end<->end link (``peer_link_gbps``, ``peer_comm_time``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.hardware import Capability


@dataclass(frozen=True)
class Task:
    """One schedulable inference sub-stage (a fleet request, here)."""

    task_id: int
    gflops: float  # C(t_i): compute complexity
    comm_bytes: float  # Comm(t_i): input that must move if offloaded
    request_id: int = -1
    stage: str = ""
    priority_class: int = 0  # request SLO class (0 = interactive)


@dataclass
class SchedulerConfig:
    alpha: float = 0.5  # eq. 9 compute/comm trade-off
    beta: float = 1.0  # eq. 11 priority threshold for local execution
    eps: float = 1e-6  # eq. 10 division guard
    t_end: float = 50.0  # eq. 11 max tolerable end load (GFLOP in flight)


@dataclass(frozen=True)
class Placement:
    task: Task
    location: str  # "end" | "cloud"
    exec_time_s: float
    comm_time_s: float
    priority: float


def priority(task: Task, comm_time_s: float, eps: float) -> float:
    """P(t_i) = C(t_i) / (Comm(t_i) + eps) (eq. 10), Comm in seconds so the
    ratio is bandwidth-aware."""
    return task.gflops / (comm_time_s + eps)


def exec_time(task: Task, cap: Capability) -> float:
    return task.gflops / max(cap.gflop_budget * 1e3, 1e-9)


def comm_time(task: Task, net_gbps: float, compression: float = 1.0) -> float:
    return task.comm_bytes * compression * 8.0 / max(net_gbps * 1e9, 1e-9)


def peer_link_gbps(gbps_a: float, gbps_b: float, *, lan_gbps: Optional[float] = None) -> float:
    """Modeled end<->end link rate between two fleet devices: the declared
    fleet LAN's rate, else both WAN uplinks' slower one (which can then
    never beat the direct cloud path)."""
    if lan_gbps is not None:
        return lan_gbps
    return min(gbps_a, gbps_b)


def peer_comm_time(nbytes: float, gbps_a: float, gbps_b: float, *,
                   lan_gbps: Optional[float] = None) -> float:
    """Wire seconds for ``nbytes`` over the modeled end<->end link."""
    rate = peer_link_gbps(gbps_a, gbps_b, lan_gbps=lan_gbps)
    return nbytes * 8.0 / max(rate * 1e9, 1e-9)


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


# ---------------------------------------------------------------------------
# Fleet planning (N heterogeneous end devices sharing one cloud tier)
# ---------------------------------------------------------------------------


def fleet_cloud_share(cloud_cap: Capability, cloud_servers: int, n_devices: int) -> Capability:
    """Per-device view of a shared cloud tier: ``cloud_servers`` servers
    split across ``n_devices`` end devices, as a scaled capability."""
    share = cloud_servers / max(n_devices, 1)
    return replace(cloud_cap, gflop_budget=cloud_cap.gflop_budget * share)


def plan_fleet_splits(
    layer_gflops: Sequence[float],
    boundary_bytes: float,
    end_caps: Sequence[Capability],
    cloud_cap: Capability,
    *,
    cloud_servers: int = 1,
    compression_ratio: float = 1.0,
    alpha: float = 0.5,
    edge_boundary: bool = False,
    pin_splits: Optional[Sequence[Optional[int]]] = None,
) -> List[PipelinePlan]:
    """The route-aware split of every end device (eq. 9-11), each planned
    against its share of the cloud tier: a weak device offloads more
    layers than a strong one."""
    share_cap = fleet_cloud_share(cloud_cap, cloud_servers, len(end_caps))
    return [
        plan_pipeline_split(
            layer_gflops, boundary_bytes, end_cap, share_cap,
            compression_ratio=compression_ratio, alpha=alpha, edge_boundary=edge_boundary,
            pin_split=pin_splits[i] if pin_splits is not None else None,
        )
        for i, end_cap in enumerate(end_caps)
    ]


def place_fleet(
    tasks: Sequence[Task],
    end_caps: Sequence[Capability],
    cfg: SchedulerConfig,
    *,
    loads: Optional[Sequence[float]] = None,
    measured_gbps: Optional[Sequence[float]] = None,
    capacity: Optional[Sequence[int]] = None,
    max_spill: Optional[float] = None,
    order: Optional[Sequence[int]] = None,
    expert_cost: Optional[Sequence[float]] = None,
) -> Tuple[List[int], Dict[str, float]]:
    """Route-aware request placement across N end devices (eq. 10/11
    generalized from the end/cloud choice to a fleet).

    Tasks are taken in their best-case eq. 10 priority order, or in an
    explicit ``order`` (a permutation, used verbatim); each goes to the
    open device (``capacity`` left) minimizing the eq. 9 marginal

        alpha * (load_d + C) / rate_d + (1 - alpha) * Comm_d + expert_cost_d * C

    preferring devices whose load stays under ``cfg.t_end``.  ``loads``
    seeds the in-flight GFLOPs, ``measured_gbps`` overrides the nominal
    uplinks, ``expert_cost`` is the fleet registry's residency surcharge in
    seconds per task GFLOP.  With ``max_spill``, a task whose cheapest open
    device costs more than ``max_spill`` times the fleet-wide best stays
    unplaced (-1) for a better device to free up.  Returns one device index
    a task and stats."""
    n = len(end_caps)
    load = list(loads) if loads is not None else [0.0] * n
    cap_left = list(capacity) if capacity is not None else [len(tasks)] * n
    gbps = [(measured_gbps[d] if measured_gbps is not None else end_caps[d].net_gbps)
            for d in range(n)]
    ecost = list(expert_cost) if expert_cost is not None else [0.0] * n
    if len(ecost) != n:
        raise ValueError(f"expert_cost has {len(ecost)} entries for {n} devices")

    def marginal(t: Task, d: int) -> float:
        ex = (load[d] + t.gflops) / max(end_caps[d].gflop_budget * 1e3, 1e-9)
        cm = t.comm_bytes * 8.0 / max(gbps[d] * 1e9, 1e-9)
        return cfg.alpha * ex + (1.0 - cfg.alpha) * cm + ecost[d] * t.gflops

    if order is None:
        order = sorted(
            range(len(tasks)),
            key=lambda i: -max(priority(tasks[i], comm_time(tasks[i], g), cfg.eps) for g in gbps),
        )
    elif sorted(order) != list(range(len(tasks))):
        raise ValueError("order must be a permutation of the task indices")
    assignment = [-1] * len(tasks)
    obj = 0.0
    for i in order:
        t = tasks[i]
        open_d = [d for d in range(n) if cap_left[d] > 0]
        if not open_d:
            continue
        # eq. 11: devices with headroom first; spill past t_end only when
        # every device is loaded
        headroom = [d for d in open_d if load[d] + t.gflops <= cfg.t_end]
        best = min(headroom or open_d, key=lambda d: marginal(t, d))
        if max_spill is not None:
            best_any = min(marginal(t, d) for d in range(n))
            if marginal(t, best) > max_spill * best_any:
                best = min(open_d, key=lambda d: marginal(t, d))
                if marginal(t, best) > max_spill * best_any:
                    continue  # wait for a better device to free a slot
        obj += marginal(t, best)
        assignment[i] = best
        load[best] += t.gflops
        cap_left[best] -= 1
    stats = {
        "objective": obj,
        "n_unplaced": sum(1 for a in assignment if a < 0),
        **{f"load_dev{d}": load[d] for d in range(n)},
    }
    return assignment, stats
