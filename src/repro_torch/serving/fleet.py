"""Heterogeneous multi-end fleet serving engine: many end devices sharing
one cloud tier, the paper's scalability setting (the port of the
reference's ``serving/fleet.py``).

``FleetServingEngine`` runs N end devices against one shared cloud.  Each
device is a ``FleetLane``, the streaming end-cloud engine
(``serving.stream.EndCloudServingEngine``) with

* its own hardware-aware expert mask under the fleet's never-empty rule
  (``selection.fleet_device_mask``: a device too weak for any expert still
  exposes one);
* its own route-aware plan, computed against its *share* of the cloud
  (``cloud_servers / n_devices``), so a weak or badly connected device
  plans a more cloud-heavy split than a strong one;
* its own ``BandwidthEstimator`` and ``LinkStats``: a drift replans only
  that device, at its own drained safe point.

The cloud is one shared resource: every lane's cloud stages queue on one
multi-server ``"cloud"`` entry of one fleet-wide ``StageTimeline``
(capacity ``cloud_servers``), and every lane's cloud KV draws pages from
one ``PagePool`` (each lane registers its slot block), so cloud admission
is fleet-wide while each lane keeps a private end pool.  One storage
backs that pool (``kvcache.SharedPagedBlocks``, indexed by fleet-global
page ids, the blocks from the lowest lane split on), and one copy of the
compute-type weights serves every lane: one process stands in for the
cloud and each end device at once.

Pooled MoE lanes share one ``expertpool.FleetExpertRegistry``: de-duplicated
residency, peer-versus-cloud slab sourcing over the modeled end<->end link
(``expert_peer_gbps``), and the placement cost the frontend reads.

Requests wait at the fleet frontend and are placed late, each tick, in a
stable (priority class, arrival) order onto the device with the least eq. 9
marginal cost (``core.pipeline.place_fleet``) over measured bandwidth,
in-flight load and free capacity (a full lane counts the slots a waiting
request of the best class could preempt).

Faults (``serving.faults``; a bound ``ChaosInjector`` fires them at the top
of each tick) go through the recovery entry points.  ``fail_lane``
evacuates a dead device: its decoding slots spill for migration and wait in
a park until the frontend places the request again, and the survivor
restores the spill at its own split from the shared cloud storage;
prefill jobs restart; the lane's slab residency is dropped and the
registry stops naming it as a peer.  ``recover_lane`` brings it back cold.
``set_link_rate`` declares a rate (a blackout pins the lane to split 0),
``inject_peer_faults`` and ``inject_transfer_faults`` arm failed slab
fetches and boundary uploads, and ``fail_cloud_server`` shrinks the shared
cloud.  A health monitor beats every live lane each tick.  The reference's
tuning options that no caller sets
(``end_states``, ``alpha``, ``selection_eps``, ``replan_threshold``,
``scheduler``, ``kv_pages``, ``cloud_kv_pages``, ``expert_pool``,
``expert_slabs``, ``expert_resident_slots``, ``expert_mem_frac``,
``expert_prefetch_per_tick``, ``expert_dedup_min_freq``) are fixed at the
reference's defaults: every MoE lane pools its experts.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import expertpool
from repro_torch.core.hardware import DeviceProfile, DeviceState
from repro_torch.core.pipeline import SchedulerConfig, Task, place_fleet
from repro_torch.core.selection import fleet_device_mask
from repro_torch.distributed.sharding import fleet_expert_shards
from repro_torch.models import kvcache
from repro_torch.models.kvcache import PagePool
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.serving.common import Request, StageTimeline
from repro_torch.serving.faults import HealthMonitor, StallGuard
from repro_torch.serving.stream import EndCloudServingEngine, _SpillState

__all__ = ["FleetLane", "FleetServingEngine"]


class FleetLane(EndCloudServingEngine):
    """One end device's streaming engine inside a fleet: the stage machinery
    is the engine's, the mask derivation goes through
    ``selection.fleet_device_mask`` so replans keep the never-empty rule."""

    def _derive_end_mask(self, end_state: DeviceState):
        cfg = self.cfg
        if cfg.moe is None:
            return None
        return fleet_device_mask(
            self.end_profile, end_state, cfg.d_model, cfg.moe.d_ff_expert,
            cfg.moe.num_experts, cfg.moe.num_groups, gated=cfg.ffn_gated,
            selection_cap=cfg.moe.local_selection_cap,
            group_priority=self._group_priority(),
        )


class FleetServingEngine:
    """N heterogeneous end devices and one shared cloud tier."""

    def __init__(
        self,
        model: Model,
        params: Dict,
        *,
        end_profiles: Sequence[DeviceProfile],
        cloud_profile: DeviceProfile,
        cloud_servers: int = 1,
        codec_params: Optional[Dict] = None,
        compression_rank: int = 0,
        max_batch: int = 4,  # decode slots a device
        max_len: int = 512,
        n_groups: int = 2,
        force_splits: Optional[Sequence[Optional[int]]] = None,
        max_spill: float = 1.5,
        clock: Optional[Callable[[], float]] = None,
        timing: str = "measured",
        page_size: int = 16,
        prefill_chunk: int = 16,
        expert_fleet: bool = True,  # the fleet-wide registry (vs isolated pools)
        expert_peer_gbps: Optional[float] = None,  # modeled end<->end LAN rate
        admission: str = "priority",  # "priority" | "fifo" (frontend and lanes)
        preemption: bool = True,
        quantize_kv: bool = False,
        quantize_experts: bool = False,
        quantize_boundary: bool = False,
        spec_k: int = 1,  # each lane's draft-length budget (1 = off)
        link_rtt_s: float = 0.0,
    ):
        n = len(end_profiles)
        if n < 1:
            raise ValueError("fleet needs at least one end device")
        if admission not in ("priority", "fifo"):
            raise ValueError(f"admission={admission!r}")
        self.model = model
        self.cfg = model.cfg
        self.n_devices = n
        self.cloud_servers = cloud_servers
        self.clock = clock or time.monotonic
        self.scheduler = SchedulerConfig()
        self.max_spill = max_spill
        self.admission = admission
        self.waiting: List[Request] = []  # the frontend queue, before placement
        self.placed: List[Dict] = []  # placement log: request -> device
        self._submit_seq = 0
        # the fault machinery: one health monitor for every lane, the chaos
        # injector (ChaosInjector.bind), liveness, and the migration park:
        # spill states off dead lanes, waiting for the lane each request is
        # placed on next
        self.health = HealthMonitor()
        self.chaos = None
        self.stall_limit = 256
        self.lane_alive: List[bool] = [True] * n
        self._migrating: Dict[int, _SpillState] = {}
        self.lane_failures = 0
        self.lane_recoveries = 0
        self.migrations = 0
        self.migration_spill_bytes = 0
        self.cloud_server_failures = 0

        # one fleet-wide occupancy clock: each lane's end and link, and one
        # shared multi-server cloud every lane's boundaries drain into
        self.timeline = StageTimeline(resources=["cloud"], capacity={"cloud": cloud_servers})
        # one fleet-wide cloud page pool (lanes register their slot blocks)
        # and the one storage behind it
        cfg = model.cfg
        pps, _ = kvcache.page_geometry(cfg, max_len, page_size, chunk_headroom=prefill_chunk)
        padded = EndCloudServingEngine.padded_batch(max_batch, n_groups)
        self.cloud_pool = PagePool(n * padded * pps, page_size, pps, n_slots=0)
        self.cloud_kv = kvcache.SharedPagedBlocks(cfg, self.cloud_pool.num_pages, page_size,
                                                  cfg.torch_dtype, model.device,
                                                  quantized=quantize_kv)
        # the fleet expert store: lanes register in device order, so
        # registry lane ids are device ids; it prices wire costs at the
        # stored slab size (int8 slabs under quantize_experts)
        self.expert_registry: Optional[expertpool.FleetExpertRegistry] = None
        if expert_fleet and cfg.moe is not None and any(spec.moe for spec in cfg.layer_pattern):
            n_moe = sum(1 for spec in cfg.layer_pattern if spec.moe)
            self.expert_registry = expertpool.FleetExpertRegistry(
                n_moe * cfg.block_repeat,
                cfg.moe.num_experts,
                expertpool.expert_slab_bytes(cfg, quantized=quantize_experts),
                lan_gbps=expert_peer_gbps,
            )
        cparams = transformer.compute_params(params, cfg)  # one copy for every lane
        self.lanes: List[FleetLane] = [
            FleetLane(
                model, params,
                end_profile=end_profiles[i], cloud_profile=cloud_profile,
                codec_params=codec_params, compression_rank=compression_rank,
                max_batch=max_batch, max_len=max_len, n_groups=n_groups,
                force_split=force_splits[i] if force_splits is not None else None,
                clock=self.clock, timeline=self.timeline,
                resources=(f"end{i}", f"link{i}", "cloud"), cloud_share=cloud_servers / n,
                timing=timing, page_size=page_size, prefill_chunk=prefill_chunk,
                cloud_pool=self.cloud_pool, cloud_kv=self.cloud_kv, cparams=cparams,
                expert_registry=self.expert_registry, admission=admission,
                preemption=preemption, health=self.health, quantize_kv=quantize_kv,
                quantize_experts=quantize_experts, quantize_boundary=quantize_boundary,
                spec_k=spec_k, link_rtt_s=link_rtt_s,
            )
            for i in range(n)
        ]

    # -- request lifecycle ----------------------------------------------------

    def submit(self, req: Request):
        self.lanes[0].validate(req)  # every lane has the same max_len and pools
        req.submit_time = self.clock()
        req.seq = self._submit_seq  # fleet-global: the lanes never re-stamp
        self._submit_seq += 1
        self.waiting.append(req)

    def _request_gflops(self, req: Request) -> float:
        """C(t): the request's forward GFLOPs on a device that keeps
        everything local (prefill and decode)."""
        tokens = len(req.prompt) + req.max_new_tokens
        return 2.0 * self.cfg.active_param_count() * tokens * 1e-9

    def _lane_load(self, lane: FleetLane) -> float:
        """In-flight GFLOPs on a device: queued and slotted requests."""
        live = list(lane.waiting) + [r for r in lane.slots if r is not None]
        return sum(self._request_gflops(r) for r in live)

    def _place(self):
        """Place frontend requests onto devices with free admission capacity:
        the eq. 9 marginal-cost choice over measured bandwidth and load, in
        stable (priority class, arrival) order (``admission="fifo"``: arrival
        order), dispatched in that order so a one-device fleet admits like
        a standalone engine.  A full lane still offers the slots the best
        waiting class could preempt; a dead lane offers none."""
        if not self.waiting:
            return
        p_best = min(r.priority for r in self.waiting)
        alive = self.lane_alive
        capacity = [0 if not alive[i] else
                    max(0, lane.free_slots() + lane.preemptible_slots(p_best) - len(lane.waiting))
                    for i, lane in enumerate(self.lanes)]
        if not any(capacity):
            return
        tasks = [
            Task(task_id=i, gflops=self._request_gflops(r),
                 comm_bytes=4.0 * len(r.prompt),  # token ids to the device
                 request_id=r.request_id, stage="request", priority_class=r.priority)
            for i, r in enumerate(self.waiting)
        ]
        if self.admission == "priority":
            order = sorted(range(len(self.waiting)),
                           key=lambda i: (self.waiting[i].priority, self.waiting[i].seq))
        else:
            order = list(range(len(self.waiting)))
        # a dead lane is priced at infinite load, not only zero capacity:
        # place_fleet's max_spill baseline is the fleet-wide best device,
        # and an idle corpse with a healthy link would anchor it, so that
        # no survivor ever looks good enough and the clock never reaches
        # the corpse's recovery
        assignment, _ = place_fleet(
            tasks,
            [lane.tiers.end_cap for lane in self.lanes],
            self.scheduler,
            loads=[self._lane_load(lane) if alive[i] else float("inf")
                   for i, lane in enumerate(self.lanes)],
            measured_gbps=[lane.bw.gbps for lane in self.lanes],
            capacity=capacity,
            max_spill=self.max_spill,
            order=order,
            expert_cost=self._expert_placement_cost(),
        )
        for i in order:
            d = assignment[i]
            if d < 0:
                continue
            req = self.waiting[i]
            if req.request_id in self._migrating:
                # off a dead lane: its parked spill state goes with it, and
                # the destination restores it through the preemption path
                # at its own split
                self.lanes[d]._spilled[req.request_id] = self._migrating.pop(req.request_id)
                self.migrations += 1
            # direct dispatch: validated and stamped at the fleet's submit
            self.lanes[d].waiting.append(req)
            self.placed.append({"request_id": req.request_id, "device": d,
                                "gflops": tasks[i].gflops, "priority": req.priority})
        # the frontend queue itself stays in submission order
        self.waiting = [r for i, r in enumerate(self.waiting) if assignment[i] < 0]

    def _expert_placement_cost(self) -> Optional[List[float]]:
        """Each device's residency surcharge for ``place_fleet`` (seconds a
        task GFLOP): the registry's expected miss wire time a routed token
        over the per-token compute.  Zero once every lane's target set is
        resident."""
        if self.expert_registry is None:
            return None
        gpt = 2.0 * self.cfg.active_param_count() * 1e-9  # GFLOPs a token
        return [
            self.expert_registry.lane_miss_cost_s(i, lane._active_lids(),
                                                  lane._end_mask_np) / max(gpt, 1e-12)
            for i, lane in enumerate(self.lanes)
        ]

    # -- stepping -------------------------------------------------------------

    def step(self) -> int:
        """One fleet tick: fire the due faults, beat every live lane, push
        each live lane's measured route frequencies into the registry, place
        frontend requests, then advance the live lanes in device order."""
        if self.chaos is not None:
            self.chaos.tick()
        now = self.clock()
        live = [i for i in range(self.n_devices) if self.lane_alive[i]]
        for i in live:
            self.health.beat(f"lane{i}", now)
        if self.expert_registry is not None:
            for i in live:
                self.expert_registry.note_freq(i, self.lanes[i]._route_freq)
        self._place()
        return sum(self.lanes[i].step() for i in live)

    def busy(self) -> bool:
        """Anything left anywhere: the frontend queue, a parked migration, a
        lane's queue, a prefill in flight or a decoding slot."""
        return (bool(self.waiting) or bool(self._migrating)
                or any(lane.busy() for lane in self.lanes))

    def _progress_sig(self) -> tuple:
        # every lane contributes (dead ones too: a stable tuple shape);
        # placements, migrations and fault transitions count as progress
        sig = (len(self.placed), len(self.waiting), len(self._migrating), self.lane_failures,
               self.lane_recoveries)
        for lane in self.lanes:
            sig += lane._progress_sig()
        return sig

    def stall_diagnostic(self) -> str:
        lanes = "; ".join(f"lane{i}[{'up' if self.lane_alive[i] else 'DOWN'}] "
                          + lane.stall_diagnostic() for i, lane in enumerate(self.lanes))
        return (f"frontend={len(self.waiting)} migrating={len(self._migrating)} "
                f"cloud_servers={self.cloud_servers} :: {lanes}")

    def run(self, max_steps: int = 10_000) -> List[Request]:
        guard = StallGuard(self.stall_limit)
        for _ in range(max_steps):
            if not self.busy():
                break
            self.step()
            guard.note(self._progress_sig(), self.stall_diagnostic)
        return self.finished

    # -- dynamic conditions (a device's drift replans that lane only) ---------

    def observe_bandwidth(self, device: int, gbps: float):
        """Feed one device's link measurement; that lane replans at its own
        drained safe point."""
        self.lanes[device].observe_bandwidth(gbps)

    def update_device_state(self, device: int, state: DeviceState):
        """Feed one device's state (eq. 2): re-derives that lane's mask and
        re-checks its plan."""
        self.lanes[device].update_device_state(state)

    # -- fault injection and recovery -----------------------------------------

    def fail_lane(self, device: int):
        """Kill one end device: evacuate its work (decoding slots spill for
        migration, prefill jobs restart), park the spill states, hand every
        request back to the frontend, mark the lane dead so nothing is
        placed on it, and drop its expert residency: the registry stops
        seeing it (a peer fetch that named it re-prices and takes the
        cloud), and a recovered lane fetches cold.  A dead lane's pages of
        the shared cloud pool went back with the spill.  Killing a dead
        lane is a no-op."""
        if not self.lane_alive[device]:
            return
        lane = self.lanes[device]
        reqs, spilled, nbytes = lane.evacuate()
        self._migrating.update(spilled)
        self.migration_spill_bytes += nbytes
        self.waiting.extend(reqs)
        self.waiting.sort(key=lambda r: r.seq)
        self.lane_alive[device] = False
        self.lane_failures += 1
        if self.expert_registry is not None:
            self.expert_registry.set_lane_alive(device, False)
        if lane._expert_pooled:
            for lid in range(lane.expert_pool.table.shape[0]):
                lane.expert_pool.free_layer(lid)
            lane._prefetch_queue = []
            lane._expert_dirty = True

    def recover_lane(self, device: int):
        """Bring a dead end device back, placeable, in the registry again,
        its expert pool cold (its first safe point plans and fetches); its
        modeled cursors move up to "now": a rebooted device did no work
        while it was down.  Recovering a live lane is a no-op."""
        if self.lane_alive[device]:
            return
        lane = self.lanes[device]
        now = self.clock()
        self.lane_alive[device] = True
        self.lane_recoveries += 1
        self.health.beat(f"lane{device}", now)
        if self.expert_registry is not None:
            self.expert_registry.set_lane_alive(device, True)
        if lane._virtual_time:
            for g in range(lane.n_groups):
                lane._group_ready_s[g] = max(lane._group_ready_s[g], now)
        if lane._expert_pooled:
            lane._expert_ready_s = max(lane._expert_ready_s, now)
            lane._expert_sync()

    def set_link_rate(self, device: int, gbps: float):
        """Declare one device's link rate (a chaos event or a recovery): a
        hard estimator assignment, entering or leaving the lane's blackout
        rung at its next safe point."""
        self.lanes[device].observe_bandwidth(gbps, hard=True)

    def inject_peer_faults(self, count: int):
        """Arm ``count`` peer slab-fetch failures fleet-wide: the next peer
        fetches back off once and take the cloud."""
        if self.expert_registry is None:
            raise RuntimeError("peer faults need the fleet expert registry")
        self.expert_registry.inject_peer_faults(count)

    def inject_transfer_faults(self, device: int, count: int):
        """Arm ``count`` boundary-upload failures on one device's link."""
        self.lanes[device].inject_transfer_faults(count)

    def fail_cloud_server(self) -> Optional[List[List[int]]]:
        """Lose one cloud server: the shared resource loses a server, every
        lane's share of the cloud becomes ``cloud_servers / n_devices``
        (splits may move at each lane's next safe point), and the expert
        layout re-sharded over the survivors is returned
        (``cloud_expert_shards``).  The last server is refused: without a
        cloud no lane can serve its blocks from the split on."""
        if self.cloud_servers <= 1:
            raise RuntimeError("cannot fail the last cloud server: the cloud tier hosts "
                               "[split, R) + LM head for every lane — total outage, not "
                               "graceful degradation")
        self.cloud_servers -= 1
        self.cloud_server_failures += 1
        self.timeline.remove_server("cloud")
        share = self.cloud_servers / self.n_devices
        for lane in self.lanes:
            lane.set_cloud_share(share)
        return self.cloud_expert_shards()

    # -- introspection --------------------------------------------------------

    @property
    def finished(self) -> List[Request]:
        return [r for lane in self.lanes for r in lane.finished]

    @property
    def replan_events(self) -> List[Dict]:
        return [{"device": i, **ev} for i, lane in enumerate(self.lanes)
                for ev in lane.replan_events]

    @property
    def end_masks(self):
        return [lane.tiers.end_mask for lane in self.lanes]

    def defrag_kv(self):
        """Compact the shared cloud pool: one permutation, applied once to
        the one cloud storage every lane views (each lane's private end pool
        compacts at its own replans)."""
        perm = self.cloud_pool.defrag()
        self.cloud_kv.permute(torch.from_numpy(perm).to(self.cloud_kv.device))

    def metrics(self) -> Dict:
        per_device = [lane.metrics() for lane in self.lanes]
        tokens = sum(len(r.generated) for r in self.finished)
        makespan = self.timeline.makespan_s
        end_in_use = sum(lane.end_pool.pages_in_use for lane in self.lanes)
        end_cap = sum(lane.end_pool.num_pages for lane in self.lanes)
        end_peak_bytes = sum(lane.end_pool.peak_in_use * kvcache.paged_block_bytes(lane._end_pages)
                             for lane in self.lanes)
        cloud_page_bytes = max((kvcache.paged_block_bytes(lane._cloud_pages)
                                for lane in self.lanes), default=0)
        kv_in_use = end_in_use + self.cloud_pool.pages_in_use
        kv_cap = end_cap + self.cloud_pool.num_pages
        drafted = sum(m["spec_drafted"] for m in per_device)
        accepted = sum(m["spec_accepted"] for m in per_device)
        return {
            "n_devices": self.n_devices,
            "cloud_servers": self.cloud_servers,
            "splits": [lane.split for lane in self.lanes],
            "tokens": tokens,
            "fleet_makespan_s": makespan,
            # the modeled fleet rate on the one shared occupancy timeline
            "aggregate_tokens_per_s": tokens / max(makespan, 1e-12),
            "cloud_busy_s": self.timeline.busy_s.get("cloud", 0.0),
            "replan_events": len(self.replan_events),
            "n_placed": len(self.placed),
            "preemptions": sum(lane.n_preemptions for lane in self.lanes),
            "preempt_restores": sum(lane.n_preempt_restores for lane in self.lanes),
            "preempt_spill_bytes": sum(lane.preempt_spill_bytes for lane in self.lanes),
            # the fault counters: the fleet's own and the lanes' summed
            "lane_failures": self.lane_failures,
            "lane_recoveries": self.lane_recoveries,
            "migrations": self.migrations,
            "migration_restores": sum(m["migration_restores"] for m in per_device),
            "migration_spill_bytes": self.migration_spill_bytes,
            "transfer_retries": sum(lane.transfer_retries for lane in self.lanes),
            "degraded_ticks": sum(lane.degraded_ticks for lane in self.lanes),
            "link_blackout_s": sum(lane.blackout_seconds() for lane in self.lanes),
            "cloud_server_failures": self.cloud_server_failures,
            # speculative decode over the lanes (acceptance: accepted/drafted)
            "spec_rounds": sum(m["spec_rounds"] for m in per_device),
            "spec_drafted": drafted,
            "spec_accepted": accepted,
            "spec_acceptance_rate": round(accepted / max(drafted, 1), 4),
            "spec_rollbacks": sum(m["spec_rollbacks"] for m in per_device),
            "n_host_syncs": sum(m["n_host_syncs"] for m in per_device),
            # the lanes' end pools plus the one shared cloud pool
            "kv_pages_in_use": kv_in_use,
            "kv_pages_capacity": kv_cap,
            "kv_utilization": kv_in_use / max(kv_cap, 1),
            "kv_bytes_peak": end_peak_bytes + self.cloud_pool.peak_in_use * cloud_page_bytes,
            "attn_bytes_paged_step": sum(m["attn_bytes_paged_step"] for m in per_device),
            "attn_bytes_dense_step": sum(m["attn_bytes_dense_step"] for m in per_device),
            **self._expert_fleet_metrics(per_device),
            "per_device": per_device,
        }

    def _expert_fleet_metrics(self, per_device: List[Dict]) -> Dict:
        pooled = [m for m in per_device if "expert_resident_slabs" in m]
        if not pooled:
            return {}
        # the hit rate weighted by each lane's routed tokens (an idle lane's
        # 1.0 over no traffic must not inflate it); the plain mean before
        # anything was decoded
        weights = [m.get("expert_routed_tokens", 0) for m in pooled]
        total_w = sum(weights)
        if total_w > 0:
            hit = sum(m["expert_hit_rate"] * w for m, w in zip(pooled, weights)) / total_w
        else:
            hit = sum(m["expert_hit_rate"] for m in pooled) / len(pooled)
        out = {
            "expert_resident_slabs": sum(m["expert_resident_slabs"] for m in pooled),
            "expert_slab_capacity": sum(m["expert_slab_capacity"] for m in pooled),
            "expert_hit_rate": hit,
            "expert_bytes_down": sum(m["expert_bytes_down"] for m in pooled),
            "expert_bytes_peer": sum(m["expert_bytes_peer"] for m in pooled),
            "expert_bytes_up": sum(m["expert_bytes_up"] for m in pooled),
            "expert_prefetches": sum(m["expert_prefetches"] for m in pooled),
            "expert_peer_fetches": sum(m["expert_peer_fetches"] for m in pooled),
            "expert_evictions": sum(m["expert_evictions"] for m in pooled),
            "expert_routed_tokens": total_w,
        }
        if self.expert_registry is not None:
            # unique resident (layer, expert) pairs against the lanes' slabs
            out["expert_unique_residents"] = self.expert_registry.unique_residents()
            out["expert_fleet_dedup_ratio"] = self.expert_registry.dedup_ratio()
        return out

    def cloud_expert_shards(self) -> Optional[List[List[int]]]:
        """The cloud's dense expert stacks sharded over ``cloud_servers``,
        balanced by the registry's measured cloud-bound traffic
        (``distributed.sharding.fleet_expert_shards``; apply with
        ``shard_expert_stacks``).  None without the registry."""
        if self.expert_registry is None:
            return None
        return fleet_expert_shards(self.expert_registry.cloud_expert_load(), self.cloud_servers)
