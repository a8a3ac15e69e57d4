"""Streaming end-cloud decode engine (port of the reference's
``serving/stream.py``: the two-tier token pipeline with chunked prefill,
the end tier's expert slab pool, speculative decode, preemption with spill
and restore, and replanning at safe points).

``EndCloudServingEngine`` is the continuous-batching engine re-expressed as
a two-tier token pipeline: each decode step is split at the route-aware
plan's block boundary (eq. 9-11).  Blocks ``[0, split)`` and the embedding
run on the end tier with the hardware-aware expert mask (eq. 2-4), the
boundary activation is low-rank compressed (eq. 8) and metered through
``LinkStats``, and blocks ``[split, R)`` plus the LM head run on the cloud
tier.  Both tiers run in this process on one device.

* **Paged KV.**  Each tier owns a ``PagePool``; the stage functions take the
  device page table as an argument, so shapes depend on the group and
  chunk sizes only, never on a prompt's length.
* **Chunked prefill.**  An admitted prompt streams through the same
  end -> link -> cloud stages one fixed-size chunk per tick, writing
  straight into the slot's pages, while in-flight groups keep decoding.
* **Pipelining.**  The batch is cut into ``n_groups`` equal micro-batch
  groups, each with its own boundary buffer: group A's cloud step and
  group B's end step share a tick, and ``StageTimeline`` accounts the
  overlap from stage times (measured on this device, or modeled from the
  planner's capabilities) and modeled link times.
* **Paged expert weights.**  For MoE models the end tier holds no dense
  expert stacks: resident experts live in a slab store
  (``core.expertpool``), the eq. 2-4 mask is the target set, and a
  route-frequency / LRU policy decides residency.  The end stages take the
  mask and the per-layer resident tables as arguments and route through
  ``core.moe.moe_resident`` (the ``grouped_mlp_resident`` kernel on the
  card).  Slab prefetches are booked on the link resource of the timeline
  and the swapped tables apply only at safe points.
* **Int8 byte streams.**  ``quantize_kv`` stores both tiers' KV pages as
  int8 codes with one f16 scale per token, ``quantize_experts`` the end
  tier's slab store as int8 with one f32 scale per output column,
  ``quantize_boundary`` ships the boundary payload (after the eq. 8 codec)
  as int8 rows with one f16 scale each (``kernels.quant`` and the int8
  variants of the paged attention and resident FFN kernels on the card).
  Each flag works alone; wire costs, capacities and meters price the
  stored sizes, while the planner keeps the unquantized boundary.
* **Speculative decode.**  With ``spec_k > 1`` the planner
  (``core.pipeline.plan_spec_k``) picks a draft length k from the modeled
  stage and link times, the per-upload round trip ``link_rtt_s`` included;
  in the compute-bound regime it picks 1 and no speculative machinery runs.
  A round drafts k tokens on the end tier (the full stack under the end
  mask against a dense draft cache a group, built by ``Model.prefill``),
  ships one C = k boundary chunk and verifies all k in one cloud chunk off
  the paged pools (``serving.specdecode``: accept, rollback, acceptance
  feedback).  Rejected positions' pages are unmapped (table surgery).
* **Priority admission and preemption.**  Admission scans the queue in
  (priority, submission) order; a blocked head that outranks running work
  spills the youngest lowest-class decoding slot at the drained safe
  point: its mapped page rows of both pools (int8 scales included) are
  copied to the host merged across the tiers, and restored on
  re-admission at the split of that moment.
* **Replanning.**  ``observe_bandwidth`` and ``update_device_state`` re-run
  the split search against measured conditions; a changed plan or mask is
  applied at the next safe point (every boundary drained) by re-splitting
  the params and moving the affected blocks' pages between the tier pools
  on the device.  A declared link rate below 5% of the nominal uplink pins
  the plan to split 0 until the link recovers.

Stage times: ``timing="measured"`` takes each stage's host-clock time with
the device synchronized after it (``torch.cuda.synchronize``, where the
reference waits with ``block_until_ready``); ``"modeled"`` takes the
planner's capability cost model, so the schedule is deterministic.  Each
tick moves every drained group's token ids (a speculative round's drafts
and verify ids), and every finished prefill's first token, to the host in
one copy each.

* **Fleet sharing.**  A fleet lane (``serving.fleet``) shares one
  ``StageTimeline`` (its own ``resources`` for end and link, one
  multi-server cloud), one cloud ``PagePool`` (the lane's slots are a block
  of fleet-global slot ids from ``cloud_pool.add_slots``) with one storage
  behind it (``cloud_kv``, indexed by fleet-global page ids; the lane reads
  the blocks from its split on), one copy of the compute-type weights
  (``cparams``), and one ``FleetExpertRegistry`` that plans residency,
  picks peer or cloud as each slab's source and prices group admits;
  ``cloud_share`` scales the planner's view of the cloud.
* **Modeled clock.**  Handed a ``VirtualClock``, the engine stamps first
  tokens and finishes at the modeled completion of the stage that made
  them, and prefill starts no earlier than the request's arrival, so the
  load generator (``serving.loadgen.drive``) reads TTFT and TPOT on the
  schedule's own clock.

* **Faults.**  ``inject_transfer_faults`` arms failed boundary uploads:
  each is resent after the health monitor's backoff, another round trip
  and another metered upload (``transfer_retries``), and the attempt that
  exhausts ``max_transfer_attempts`` raises.  ``evacuate`` (a fleet lane's
  death) drops in-flight boundaries and unmaps an unverified speculative
  round's pages, spills every decoding slot through the preemption path
  for migration, restarts prefill jobs from scratch and hands the lane's
  parked spill states over; a surviving lane restores a migrated state at
  its own split (``n_migration_restores``).  ``set_cloud_share`` re-scales
  the planner's view of the cloud when a fleet loses a cloud server.

The reference's tuning options that no caller sets (``end_state``,
``alpha``, ``selection_eps``, ``replan_threshold``, ``kv_pages``,
``expert_slabs``, ``blackout_gbps``) are fixed at the reference's defaults.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.core import expertpool, gating
from repro_torch.core.hardware import DeviceProfile, DeviceState, capability
from repro_torch.core.pipeline import (
    BandwidthEstimator,
    PipelinePlan,
    plan_pipeline_split,
    plan_spec_k,
    replan_pipeline,
)
from repro_torch.core.selection import group_priority_from_freq, validate_expert_mask
from repro_torch.models import attention as attn
from repro_torch.models import kvcache, transformer
from repro_torch.models.kvcache import PagePool
from repro_torch.models.model import Model
from repro_torch.serving.common import (
    LinkStats,
    Request,
    ShapeSignatures,
    SlotEngineBase,
    StageTimeline,
    VirtualClock,
    element_bytes,
    payload_nbytes,
)
from repro_torch.serving.faults import HealthMonitor
from repro_torch.serving.endcloud import (
    TierPlan,
    end_mask_from_state,
    init_tier_pages,
    plan_tiers,
    split_block_params,
    strip_expert_weights,
)
from repro_torch.serving.specdecode import (
    SpecState,
    batched_accept,
    min_pow2_le,
    rollback_entries,
)

__all__ = ["EndCloudServingEngine"]

_KEEP = object()  # sentinel: "no pending mask change"
_RESOURCES = ("end", "link", "cloud")
# a declared link rate below this share of the nominal uplink is a blackout
_BLACKOUT_FRAC = 0.05


def _masks_equal(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return bool(np.array_equal(a, b))


def _row(z, *idx):
    """Index every tensor of a boundary payload (one tensor, or the
    quantized ``(codes, scales)``) alike."""
    return tuple(p[idx] for p in z) if isinstance(z, tuple) else z[idx]


class _PrefillJob:
    """An admitted request streaming its prompt through the pipeline in
    chunks.  The slot is reserved (pages and all) but not active until the
    final chunk lands and the group reaches a drained tick."""

    __slots__ = ("req", "slot", "group", "pos", "first_tok", "first_tok_dev", "ready_s")

    def __init__(self, req: Request, slot: int, group: int):
        self.req = req
        self.slot = slot
        self.group = group
        self.pos = 0  # prompt tokens prefilled so far
        self.first_tok: Optional[int] = None  # set once the tick resolves it
        self.first_tok_dev: Optional[torch.Tensor] = None  # device scalar
        self.ready_s = 0.0  # modeled completion time of the last chunk


class _SpillState:
    """A preempted request's KV, copied off the device pools.  ``blocks``
    holds the slot's mapped page rows of every pool leaf (int8 codes and
    their f16 scales on int8 pools) for all block repeats, the two tiers'
    rows merged in block order: a restore re-splits them at the split of
    that moment, and ring entries, not physical rows, are what attention
    reads, so a replan in between leaves the stream intact."""

    __slots__ = ("entries", "blocks", "length", "next_token", "n_pages", "migrated")

    def __init__(self, entries: np.ndarray, blocks: Dict, length: int, next_token: int,
                 n_pages: int):
        self.entries = entries  # mapped ring entries (the same in both pools)
        self.blocks = blocks  # {pos: {leaf: [R, n_entries, ...]}} on the host
        self.length = length  # the slot's length at the safe point
        self.next_token = next_token  # pending token (its KV not yet written)
        self.n_pages = n_pages  # the original reservation
        self.migrated = False  # off a dead lane (vs preempted in this one)

    @property
    def nbytes(self) -> int:
        """Spilled bytes at the stored type (an int8 pool's codes and
        scales, never the dense equivalent)."""
        return sum(leaf.numel() * leaf.element_size()
                   for entry in self.blocks.values() for leaf in entry.values())


class EndCloudServingEngine(SlotEngineBase):
    def __init__(
        self,
        model: Model,
        params: Dict,
        *,
        end_profile: DeviceProfile,
        cloud_profile: DeviceProfile,
        codec_params: Optional[Dict] = None,  # 1-D low-rank codec {"enc","dec"}
        compression_rank: int = 0,
        max_batch: int = 8,
        max_len: int = 512,
        n_groups: int = 2,
        force_split: Optional[int] = None,
        clock: Optional[Callable[[], float]] = None,
        timeline: Optional[StageTimeline] = None,  # a fleet's shared clock
        resources: Tuple[str, str, str] = _RESOURCES,  # (end, link, cloud) names
        cloud_share: float = 1.0,  # this lane's share of a fleet's cloud
        timing: str = "measured",
        page_size: int = 16,
        prefill_chunk: int = 16,
        cloud_pool: Optional[PagePool] = None,  # a fleet's shared cloud pages
        cloud_kv: Optional[kvcache.SharedPagedBlocks] = None,  # and their storage
        cparams: Optional[Dict] = None,  # a fleet's shared compute-type weights
        expert_pool: Optional[bool] = None,  # None = on for MoE models
        expert_resident_slots: Optional[int] = None,  # per-layer slot count
        expert_mem_frac: float = 0.5,  # end memory budget share for slabs
        expert_prefetch_per_tick: int = 2,
        expert_registry=None,  # a fleet's expertpool.FleetExpertRegistry
        admission: str = "priority",  # "priority" | "fifo" (see SlotEngineBase)
        preemption: bool = True,
        quantize_kv: bool = False,  # int8 KV pages + f16 per-token scales
        quantize_experts: bool = False,  # int8 slab store + f32 column scales
        quantize_boundary: bool = False,  # int8 boundary rows + f16 row scales
        health: Optional[HealthMonitor] = None,  # a fleet's shared retry policy
        spec_k: int = 1,  # speculative draft-length budget (1 = off)
        link_rtt_s: float = 0.0,  # modeled round trip of every upload
    ):
        cfg = model.cfg
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if not kvcache.pattern_is_pageable(cfg):
            raise NotImplementedError(
                "the streaming end-cloud engine serves attention-only layer "
                "patterns (paged KV + chunked prefill)"
            )
        # equal-sized micro-batch groups: the slot count is padded up to a
        # multiple of the group size; padding slots are never admitted
        self.n_groups = max(1, min(n_groups, max_batch))
        self._group_size = -(-max_batch // self.n_groups)
        padded_batch = self.padded_batch(max_batch, n_groups)
        super().__init__(padded_batch, clock, max_len=max_len, admission=admission)
        self.request_capacity = max_batch
        self.preemption = preemption and admission == "priority"
        self._spilled: Dict[int, _SpillState] = {}  # request_id -> spilled KV
        self.n_preemptions = 0
        self.n_preempt_restores = 0
        self.preempt_spill_bytes = 0
        # a VirtualClock moves request stamps onto the modeled timeline
        self._virtual_time = isinstance(self.clock, VirtualClock)
        self.quantize_kv = bool(quantize_kv)
        self.quantize_experts = bool(quantize_experts)
        self.quantize_boundary = bool(quantize_boundary)
        self.model = model
        self.cfg = cfg
        self.device = model.device
        # the expert pool copies slabs from the params as given (their type
        # is the store's); the tiers run on copies of the weights in the
        # activation type, as the reference casts them at every use
        self.params = params
        self._cparams = (cparams if cparams is not None
                         else transformer.compute_params(params, cfg))
        self.end_profile = end_profile
        self.cloud_profile = cloud_profile
        self.end_state = DeviceState()

        self._moe_pos = [i for i, spec in enumerate(cfg.layer_pattern) if spec.moe]
        self._expert_pooled = bool(
            (expert_pool if expert_pool is not None else True)
            and cfg.moe is not None and self._moe_pos
        )
        self._route_freq: Optional[np.ndarray] = None  # [E] EMA of expert_frac
        self._group_freq: Optional[np.ndarray] = None  # [K] EMA of group_frac
        self._freq_decay = 0.9
        # a fleet's expert registry plans residency once this lane registers
        # (after its pool exists); the mask derivation below may run first
        self.expert_registry = expert_registry if self._expert_pooled else None
        self._registry_lane: Optional[int] = None
        # any MoE end tier (pooled or dense-mask) measures routing stats
        self._route_stats_enabled = cfg.moe is not None and bool(self._moe_pos)

        mask = self._derive_end_mask(self.end_state)
        self.tiers: TierPlan = plan_tiers(
            model,
            end_profile=end_profile,
            cloud_profile=cloud_profile,
            end_state=self.end_state,
            end_mask=mask,
            codec_params=codec_params,
            compression_rank=compression_rank,
            force_split=force_split,
            cloud_share=cloud_share,
        )
        self._end_mask_np = None if mask is None else np.asarray(mask, bool)
        self._split_params()

        self.link = LinkStats()
        self.bw = BandwidthEstimator(self.tiers.end_cap.net_gbps)
        # a fleet shares one monitor (the backoff of a failed peer fetch)
        self.health = health or HealthMonitor()
        # below this declared rate the link is blacked out and the engine
        # degrades to a cloud-only plan at the next safe point
        self.blackout_gbps = _BLACKOUT_FRAC * self.tiers.end_cap.net_gbps
        self.link_degraded = False
        self._blackout_since = 0.0
        self.link_blackout_s = 0.0  # closed windows; see blackout_seconds()
        self.degraded_ticks = 0
        self.transfer_retries = 0  # resent uploads and peer fetches retried from the cloud
        self._transfer_faults = 0  # armed boundary-upload failures
        self.n_migration_restores = 0
        # a fleet shares one occupancy clock: each lane brings its own end
        # and link resources, every lane's cloud stage queues on one
        # (multi-server) cloud resource
        self._res_end, self._res_link, self._res_cloud = resources
        if timeline is None:
            timeline = StageTimeline(resources)
        else:
            for r in resources:
                timeline.add_resource(r)
        self.timeline = timeline
        if timing not in ("measured", "modeled"):
            raise ValueError(f"timing={timing!r}")
        self.timing = timing
        self._cloud_share = cloud_share
        self.replan_events: List[Dict] = []
        self._pending_plan: Optional[PipelinePlan] = None
        self._pending_mask = _KEEP

        # -- paged KV: one pool per tier, storage split by block range ------
        self.page_size = page_size
        self.pages_per_slot, ring = kvcache.page_geometry(
            cfg, max_len, page_size, chunk_headroom=prefill_chunk
        )
        if prefill_chunk > ring:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} exceeds the ring capacity {ring} "
                "(a chunk must fit the slot's page list)"
            )
        self.prefill_chunk = prefill_chunk
        n_pages = padded_batch * self.pages_per_slot
        self.end_pool = PagePool(n_pages, page_size, self.pages_per_slot, n_slots=padded_batch)
        self._cloud_kv: Optional[kvcache.SharedPagedBlocks] = None
        if cloud_pool is None:
            self.cloud_pool = PagePool(n_pages, page_size, self.pages_per_slot,
                                       n_slots=padded_batch)
            self._cloud_base = 0
            self._cloud_shared = False
            self._end_pages, self._cloud_pages = init_tier_pages(
                cfg, self.split, n_pages, n_pages, page_size, cfg.torch_dtype, self.device,
                quantized=self.quantize_kv,
            )
        else:
            # a fleet's pool: this lane's slots are a block of fleet-global
            # slot ids, and its cloud blocks are views of one storage
            # indexed by fleet-global pages (see _cloud_pages)
            if (cloud_pool.page_size != page_size
                    or cloud_pool.pages_per_slot != self.pages_per_slot):
                raise ValueError("shared cloud pool geometry mismatch")
            if cloud_kv is None:
                cloud_kv = kvcache.SharedPagedBlocks(cfg, cloud_pool.num_pages, page_size,
                                                     cfg.torch_dtype, self.device,
                                                     quantized=self.quantize_kv)
            if cloud_kv.num_pages != cloud_pool.num_pages or cloud_kv.quantized != self.quantize_kv:
                raise ValueError("shared cloud storage does not match the pool")
            self.cloud_pool = cloud_pool
            self._cloud_base = cloud_pool.add_slots(padded_batch)
            self._cloud_shared = True
            self._cloud_kv = cloud_kv
            cloud_kv.reserve(self.split)
            self._end_pages = kvcache.init_paged_blocks(
                cfg, self.split, n_pages, page_size, cfg.torch_dtype, self.device,
                quantized=self.quantize_kv,
            )
        self._slot_len = np.zeros((padded_batch,), np.int64)
        self._jobs: Dict[int, _PrefillJob] = {}  # slot -> in-flight prefill

        # micro-batch groups: contiguous slot ranges, one boundary buffer each
        gsz = self._group_size
        self._group_slices = [(g * gsz, (g + 1) * gsz) for g in range(self.n_groups)]
        self._phase = ["ready"] * self.n_groups  # "ready" | "boundary"
        # a boundary payload: one tensor, or (codes, scales) when quantized
        self._boundary: List = [None] * self.n_groups
        self._boundary_ready_s = [0.0] * self.n_groups  # modeled arrival time
        self._group_ready_s = [0.0] * self.n_groups  # modeled token-ready time
        # decode-only mirror of the occupancy clock for the pipelined-vs-
        # serial decode metric (prefill occupancy must not pollute it)
        self._metric_clock = StageTimeline(_RESOURCES)
        self._m_boundary_ready = [0.0] * self.n_groups
        self._m_group_ready = [0.0] * self.n_groups

        # -- paged expert weights: slab pool + device store/tables ----------
        self.expert_pool: Optional[expertpool.ExpertSlabPool] = None
        if self._expert_pooled:
            m = cfg.moe
            E = m.num_experts
            s_cap = expert_resident_slots or max(1, int(np.floor(m.local_selection_cap * E)))
            self._s_cap = min(s_cap, E)
            n_layers = len(self._moe_pos) * cfg.block_repeat
            # budgets, wire time and meters price the stored slab; the dense
            # size stays as the metrics' baseline
            self._slab_bytes = expertpool.expert_slab_bytes(
                cfg, quantized=self.quantize_experts)
            self._slab_bytes_dense = expertpool.expert_slab_bytes(cfg)
            self._expert_mem_frac = expert_mem_frac
            n_slabs = n_layers * self._s_cap
            self.expert_pool = expertpool.ExpertSlabPool(n_slabs, n_layers, E, self._s_cap)
            self._slab_store = expertpool.init_slab_store(
                cfg, n_slabs, quantized=self.quantize_experts, device=self.device)
            self._expert_prefetch_per_tick = max(1, expert_prefetch_per_tick)
            self._prefetch_queue: List[Tuple[int, int]] = []
            self._expert_ready_s = 0.0  # link-resource cursor for transfers
            self.expert_bytes_down = 0  # runtime slab prefetch traffic (cloud)
            self.expert_bytes_peer = 0  # slab traffic served by peer lanes
            self.expert_bytes_up = 0  # evictions are drops: the cloud keeps all
            self.n_expert_prefetches = 0
            self.n_expert_peer_fetches = 0
            self.n_expert_evictions = 0
            self.expert_routed_tokens = 0  # decoded tokens through the pool
            self.expert_wire_s = 0.0  # slab wire time booked on own link
            self._expert_dirty = False
            if self.expert_registry is not None:
                self._registry_lane = self.expert_registry.register_lane(
                    self.expert_pool,
                    link_gbps=lambda: self.bw.gbps,
                    book_link=lambda ready_s, t: self.timeline.occupy(self._res_link, ready_s, t),
                )
            # the initial residency ships with the deployment: filled at
            # once, unmetered; only runtime changes ride the link
            self._expert_sync(instant_lids=set(self._active_lids()))

        # -- speculative decode: draft caches, acceptance state, planned k --
        # ``spec_k`` is the budget; plan_spec_k picks k from the modeled
        # stage and link times and gives 1 in the compute-bound regime,
        # where no speculative machinery runs at all
        self.spec_k_max = min(int(spec_k), self.prefill_chunk)
        self.link_rtt_s = float(link_rtt_s)
        self._spec_state: Optional[SpecState] = None
        self._spec_plan_k = 1
        self._spec_fns: Dict[int, Tuple] = {}  # k -> (draft, end, cloud) stage fns
        self._spec_prefill = None  # the draft cache's prefill, [1, max_len]
        # a dense draft cache a group ({pos: {k, v: [R, gsz, W, KV, hd]}}),
        # and a slot's draft length and whether its cache is current
        self._draft_cache: List[Optional[Dict]] = [None] * self.n_groups
        self._draft_len = np.zeros((padded_batch,), np.int64)
        self._draft_ready = np.zeros((padded_batch,), bool)
        # a group's round in flight: set by its end stage, read at the drain
        self._spec_pending: List[Optional[Dict]] = [None] * self.n_groups

        self.n_host_syncs = 0  # batched device->host copies of token ids
        self.n_stage_steps = 0  # decode end steps (== drained cloud steps)
        self.n_prefill_chunks = 0
        self._stage_busy = {r: 0.0 for r in _RESOURCES}
        self._prefill_busy = {r: 0.0 for r in _RESOURCES}
        self._traces: Dict[str, set] = {}
        self._build_gen = 0
        self._build_stage_fns()

    @staticmethod
    def padded_batch(max_batch: int, n_groups: int) -> int:
        """Slot count after rounding up to equal-sized micro-batch groups
        (the fleet sizes its shared cloud pool with it)."""
        g = max(1, min(n_groups, max_batch))
        return -(-max_batch // g) * g

    # -- the active plan lives on self.tiers ---------------------------------

    @property
    def plan(self) -> PipelinePlan:
        return self.tiers.plan

    @property
    def split(self) -> int:
        return self.tiers.plan.split_layer

    def _cslot(self, slot: int) -> int:
        """A slot's row in the (possibly fleet-shared) cloud pool."""
        return self._cloud_base + slot

    @property
    def _cloud_pages(self) -> Dict:
        """The cloud tier's paged storage: the engine's own, or in a fleet
        views from this lane's split on of the one shared storage."""
        if self._cloud_kv is not None:
            return self._cloud_kv.view(self.split)
        return self._own_cloud_pages

    @_cloud_pages.setter
    def _cloud_pages(self, pages: Dict):
        # the stage functions write their pages in place and hand them back:
        # a shared storage already holds what they wrote
        if self._cloud_kv is None:
            self._own_cloud_pages = pages

    def _split_params(self):
        self.end_params, self.cloud_params = split_block_params(self._cparams, self.split)
        if self._expert_pooled:
            self.end_params = strip_expert_weights(self.end_params, self.cfg)

    def _derive_end_mask(self, end_state: DeviceState):
        """Hardware-aware expert mask for the end device (eq. 2-4), its
        greedy group admit ordered by the *measured* stage-1 routing
        frequency (EMA of the gate's ``group_frac``) and, in a fleet, the
        registry's placement cost.  A fleet lane overrides it with the
        fleet's never-empty mask."""
        return end_mask_from_state(
            self.cfg, self.end_profile, end_state, group_priority=self._group_priority(),
        )

    def _group_priority(self):
        if self.cfg.moe is None:
            return None
        return group_priority_from_freq(self._group_freq, self.cfg.moe.num_groups,
                                        group_cost=self._group_placement_cost())

    def _group_placement_cost(self):
        """Per-group modeled fetch cost from the fleet registry (None
        standalone, or before this lane registered): the eq. 4 admit then
        prefers groups already fleet-resident or cheap to fetch."""
        if self.expert_registry is None or self._registry_lane is None:
            return None
        return self.expert_registry.group_fetch_costs(
            self._registry_lane, self._active_lids(), self.cfg.moe.num_groups)

    # -- paged expert weights (slab pool; see core.expertpool) ---------------

    def _active_lids(self) -> List[int]:
        """Pool layer ids of the end tier's MoE layers at the current split:
        block ``b`` of MoE position ``self._moe_pos[pi]`` is layer
        ``pi * block_repeat + b``."""
        R = self.cfg.block_repeat
        return [pi * R + b for pi in range(len(self._moe_pos)) for b in range(self.split)]

    def _expert_capacity(self) -> int:
        """Slab budget from the end capability's memory term (eq. 3):
        ``expert_mem_frac`` of it buys slabs, and every active end layer
        keeps at least one."""
        budget = self.tiers.end_cap.mem_budget_gb * 1e9 * self._expert_mem_frac
        n = int(budget // self._slab_bytes)
        floor_n = max(1, len(self._active_lids()))
        return max(floor_n, min(n, self.expert_pool.num_slabs))

    def _plan_residency(self, active, target):
        """This lane's residency plan: through the fleet registry when
        attached (the pool's policy plus the fleet's de-duplication rule),
        the pool's own policy otherwise."""
        if self.expert_registry is not None and self._registry_lane is not None:
            return self.expert_registry.plan_lane(self._registry_lane, active, target,
                                                  self._route_freq)
        return self.expert_pool.plan(active, target, self._route_freq)

    def _write_slabs(self, assignments: List[Tuple[int, int, int, int]]):
        """(slab, pos index, block, expert) -> copy the weights into the
        store, one batched copy per MoE pattern position."""
        by_pos: Dict[int, List[Tuple[int, int, int]]] = {}
        for slab, pi, b, e in assignments:
            by_pos.setdefault(pi, []).append((slab, b, e))
        for pi, asg in by_pos.items():
            full = self.params["blocks"][f"pos{self._moe_pos[pi]}"]["moe"]
            expertpool.write_slabs(self._slab_store, full, asg)

    def _lid_to_pos_block(self, lid: int) -> Tuple[int, int]:
        R = self.cfg.block_repeat
        return lid // R, lid % R

    def _expert_sync(self, instant_lids=()):
        """Reconcile residency with the current target mask, split and
        memory budget; called at safe points only, so the swapped tables
        and mask never change mid-boundary.  Layers in ``instant_lids``
        (the initial fill, blocks entering the end tier at a split change)
        fill at once; everything else joins the prefetch queue."""
        pool = self.expert_pool
        target = self._end_mask_np
        active = self._active_lids()
        pool.set_capacity(self._expert_capacity())
        wanted, evictions = self._plan_residency(active, target)
        for lid, e in evictions:
            pool.evict(lid, e)
            self.n_expert_evictions += 1
        instant_lids = set(instant_lids)
        queue: List[Tuple[int, int]] = []
        writes: List[Tuple[int, int, int, int]] = []
        for lid, e in wanted:
            if lid in instant_lids and pool.can_alloc():
                slab = pool.alloc(lid, e)
                pi, b = self._lid_to_pos_block(lid)
                writes.append((slab, pi, b, e))
            else:
                queue.append((lid, e))
        self._write_slabs(writes)
        self._prefetch_queue = queue
        self._expert_tables = self._build_expert_tables()
        self._emask_dev = torch.from_numpy(target.copy()).to(self.device)
        pool.touch(active, target)
        self._expert_dirty = False

    def _build_expert_tables(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per MoE position, the resident tables of the end tier's blocks,
        moved to the device once per safe point."""
        R = self.cfg.block_repeat
        return {
            f"pos{pos}": expertpool.device_resident_tables(
                self.expert_pool, [pi * R + b for b in range(self.split)], self._s_cap,
                self.device,
            )
            for pi, pos in enumerate(self._moe_pos)
        }

    def _eres(self) -> Dict:
        """The pooled end stages' operand: slab store + resident tables."""
        return {"store": self._slab_store, "tables": self._expert_tables}

    def _advance_expert_prefetch(self):
        """Transfer up to ``expert_prefetch_per_tick`` queued slabs: write
        them into the store (no applied table references them until the
        next safe point) and book their wire time on the link resource,
        where prefetch overlaps decode as boundary traffic does.  A queue
        head blocked on capacity waits for safe-point evictions."""
        if not self._expert_pooled or not self._prefetch_queue:
            return
        pool = self.expert_pool
        n = i = 0
        writes: List[Tuple[int, int, int, int]] = []
        while i < len(self._prefetch_queue) and n < self._expert_prefetch_per_tick:
            lid, e = self._prefetch_queue[i]
            if pool.table[lid, e] >= 0:
                self._prefetch_queue.pop(i)
                continue
            if not pool.can_alloc():
                break  # global budget: nothing can transfer this tick
            if pool.resident_count(lid) >= pool.max_per_layer:
                i += 1  # this layer waits for safe-point evictions
                continue
            self._prefetch_queue.pop(i)
            slab = pool.alloc(lid, e)
            pi, b = self._lid_to_pos_block(lid)
            writes.append((slab, pi, b, e))
            # the source is picked at transfer time against the live fleet
            # map: a peer holding the slab serves it over the end<->end
            # link when strictly cheaper (one that evicted meanwhile is not
            # a holder any more, and the cloud serves)
            src = None
            reg = self.expert_registry
            if reg is not None and self._registry_lane is not None:
                src, t_wire = reg.pick_source(self._registry_lane, lid, e)
            if src is not None and reg.take_peer_fault():
                # an armed peer failure: back off once, then the cloud
                self.transfer_retries += 1
                self._expert_ready_s += self.health.backoff_s(0)
                src = None
            if src is None:
                t_wire = self.link.transfer_time(self._slab_bytes, self.bw.gbps)
                self.expert_bytes_down += self._slab_bytes
            else:
                # both ends of a peer transfer ride the fleet timeline: this
                # lane's link here, the source's through the registry
                reg.book_peer(src, self._registry_lane, self._expert_ready_s, t_wire)
                self.link.record_peer(self._slab_bytes, t_wire)
                self.expert_bytes_peer += self._slab_bytes
                self.n_expert_peer_fetches += 1
            self._expert_ready_s = self.timeline.occupy(self._res_link, self._expert_ready_s,
                                                        t_wire)
            self.expert_wire_s += t_wire
            self.n_expert_prefetches += 1
            self._expert_dirty = True  # tables swap at the next safe point
            n += 1
        self._write_slabs(writes)

    def _observe_route_stats(self, stats: torch.Tensor):
        """EMA of the gate's measured routing statistics (``expert_frac``
        then ``group_frac``, summed over the end tier's MoE layers, in one
        host copy): they order the eq. 4 group admit and the pool's
        prefetch and eviction priorities."""
        n_layers = max(len(self._active_lids()), 1)
        v = stats.double().cpu().numpy() / n_layers
        ef, gf = v[: self.cfg.moe.num_experts], v[self.cfg.moe.num_experts :]
        if not (np.isfinite(ef).all() and np.isfinite(gf).all()):
            return
        d = self._freq_decay
        if self._route_freq is None:
            self._route_freq, self._group_freq = ef, gf
        else:
            self._route_freq = d * self._route_freq + (1 - d) * ef
            self._group_freq = d * self._group_freq + (1 - d) * gf

    # -- stage functions (rebuilt on every replan that changes the split or
    # -- the codec flag, so nothing captured can go stale) --------------------

    def _build_stage_fns(self):
        cfg = self.cfg
        tiers = self.tiers
        codec, compress = tiers.codec, tiers.compress
        end_mask = tiers.end_mask
        act = cfg.torch_dtype
        ps = self.page_size
        m = cfg.moe
        qb = self.quantize_boundary

        def wire_encode(x):
            """The end tier's boundary payload: the codec's Z (eq. 8), then
            int8 rows and f16 scales, the two in one launch when both are on."""
            if compress:
                return comp.encode_quantized_1d(codec, x) if qb else comp.encode_1d(codec, x)
            return comp.quantize_boundary(x) if qb else x

        def wire_decode(z):
            """The cloud tier's input from a boundary payload, in ``act``."""
            if compress:
                x = comp.decode_quantized_1d(codec, *z, act) if qb else comp.decode_1d(codec, z)
            else:
                x = comp.dequantize_boundary(*z, dtype=act) if qb else z
            return x.to(act)

        def angles(positions):  # [B, S]; M-RoPE: the same position on all three axes
            return attn.model_angles(cfg, positions)

        def chunk_positions(start, C):
            return start[:, None] + torch.arange(C, dtype=torch.int32, device=start.device)[None]

        def end_step(end_params, tokens, pages, table, lengths, emask=end_mask, eres=None):
            x = transformer.embed_inputs(end_params, cfg, tokens)
            x, pages, layer_aux = transformer.apply_stack_decode(
                end_params, x, cfg, angles(lengths[:, None]), pages, lengths,
                expert_mask=emask, page_table=table, page_size=ps, expert_resident=eres,
            )
            z = wire_encode(x)
            if self._route_stats_enabled:
                # expert_frac ++ group_frac summed over the end tier's MoE
                # layers; an end tier without blocks (split 0) gives zeros
                stats = gating.summed_routing_stats(
                    [a["topk_idx"] for a in layer_aux], m.num_experts, m.num_groups, x.device
                )
                return z, pages, stats
            return z, pages

        def cloud_step(cloud_params, z, pages, table, lengths):
            x = wire_decode(z)
            x, pages, _ = transformer.apply_stack_decode(
                cloud_params, x, cfg, angles(lengths[:, None]), pages, lengths,
                expert_mask=None, page_table=table, page_size=ps,
            )
            logits = transformer.lm_logits(cloud_params, cfg, x)[:, 0]
            # greedy ids on the device: one int32 per row crosses to the host
            return torch.argmax(logits, dim=-1).to(torch.int32), pages

        def end_prefill_chunk(end_params, tokens, pages, table, start, n_valid,
                              emask=end_mask, eres=None):
            positions = chunk_positions(start, tokens.shape[1])
            x = transformer.embed_inputs(end_params, cfg, tokens)
            x, pages = transformer.apply_stack_prefill_chunk(
                end_params, x, cfg, angles(positions), pages, table, positions,
                n_valid, ps, expert_mask=emask, expert_resident=eres,
            )
            return wire_encode(x), pages

        def cloud_prefill_chunk(cloud_params, z, pages, table, start, n_valid):
            x = wire_decode(z)
            B, C = x.shape[:2]
            positions = chunk_positions(start, C)
            x, pages = transformer.apply_stack_prefill_chunk(
                cloud_params, x, cfg, angles(positions), pages, table, positions,
                n_valid, ps, expert_mask=None,
            )
            last = (n_valid.long() - 1).clamp_min(0)
            x_last = x[torch.arange(B, device=x.device), last][:, None]
            logits = transformer.lm_logits(cloud_params, cfg, x_last)[:, 0]
            return torch.argmax(logits, dim=-1).to(torch.int32), pages

        def cloud_verify_chunk(cloud_params, z, pages, table, start, n_valid):
            """The speculative verify: the cloud chunk's forward with the
            greedy id of every position (k int32 a row cross the link)."""
            x = wire_decode(z)
            positions = chunk_positions(start, x.shape[1])
            x, pages = transformer.apply_stack_prefill_chunk(
                cloud_params, x, cfg, angles(positions), pages, table, positions,
                n_valid, ps, expert_mask=None,
            )
            logits = transformer.lm_logits(cloud_params, cfg, x)
            return torch.argmax(logits, dim=-1).to(torch.int32), pages

        self._build_gen += 1
        gen = self._build_gen

        def counted(name, fn):
            return ShapeSignatures(fn, self._traces.setdefault(name, set()), gen)

        self._end_step = counted("end_step", end_step)
        self._cloud_step = counted("cloud_step", cloud_step)
        self._end_prefill_chunk = counted("end_prefill_chunk", end_prefill_chunk)
        self._cloud_prefill_chunk = counted("cloud_prefill_chunk", cloud_prefill_chunk)
        # a speculative round's end chunk is the prefill chunk's forward at
        # C = k; the speculative stage functions close over this build's
        # codec, mask and split, so they are made again lazily
        self._spec_bodies = (end_prefill_chunk, cloud_verify_chunk)
        self._spec_fns = {}
        self._spec_prefill = None
        self._recompute_spec_plan()
        self._warmup_stage_fns()

    def _eargs(self) -> Tuple:
        """The pooled end stages' runtime operands (mask, resident view)."""
        return (self._emask_dev, self._eres()) if self._expert_pooled else ()

    def _ints(self, values) -> torch.Tensor:
        return torch.from_numpy(np.asarray(values, np.int32)).to(self.device)

    def _warmup_stage_fns(self):
        """Run each stage function once at the group shape and the chunk
        shape (first launches: the gate's JIT compile, library handles), so
        measured stage times are steady-state.  Writes go to the garbage
        page (all-garbage tables), which no read ever sees."""
        gsz = self._group_size
        inactive = np.zeros((gsz,), bool)
        tokens = self._ints(np.zeros((gsz, 1)))
        lengths = self._ints(np.zeros((gsz,)))
        te = self.end_pool.device_rows(range(gsz), active=inactive, device=self.device)
        tc = self.cloud_pool.device_rows([self._cslot(s) for s in range(gsz)], active=inactive,
                                         device=self.device)
        z = self._end_step(self.end_params, tokens, self._end_pages, te, lengths,
                           *self._eargs())[0]
        self._cloud_step(self.cloud_params, z, self._cloud_pages, tc, lengths)

        ctok = self._ints(np.zeros((1, self.prefill_chunk)))
        start, valid = self._ints([0]), self._ints([1])
        te1 = self.end_pool.device_rows([0], active=np.zeros((1,), bool), device=self.device)
        tc1 = self.cloud_pool.device_rows([self._cslot(0)], active=np.zeros((1,), bool),
                                          device=self.device)
        z, _ = self._end_prefill_chunk(self.end_params, ctok, self._end_pages, te1,
                                       start, valid, *self._eargs())
        self._cloud_prefill_chunk(self.cloud_params, z, self._cloud_pages, tc1, start, valid)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _measure(self, fn, *args):
        """(result, host seconds); in measured timing the device is
        synchronized after the call, so the seconds cover its work."""
        t0 = time.perf_counter()
        out = fn(*args)
        if self.timing == "measured":
            self._sync()
        return out, time.perf_counter() - t0

    # -- speculative decode: draft on the end tier, verify in one C = k chunk -
    #
    # A round replaces one plain pipeline round of a group: the end tier
    # drafts k tokens with the full stack under its expert mask against a
    # dense draft cache, runs its blocks over the chunk [pending, y_1 ..
    # y_{k-1}] and ships one boundary payload; the cloud verifies the k
    # positions in one chunk off the paged pools.  The accepted prefix
    # commits, the pages mapped past it roll back (table surgery), and the
    # verify id at the first rejection is the corrected token.

    def _recompute_spec_plan(self):
        """Re-plan the draft length against the measured link (at every
        stage rebuild, bandwidth observation and replan); k = 1 turns every
        piece of speculative machinery off."""
        if self.spec_k_max <= 1:
            self._spec_plan_k = 1
            return
        st = self._spec_state
        acc = st.acceptance if st is not None and st.acceptance is not None else 0.7
        k = plan_spec_k(
            self.tiers.layer_gflops,
            self.tiers.boundary_bytes,
            self.tiers.end_cap,
            self.tiers.cloud_cap,
            split=self.split,
            link_rtt_s=self.link_rtt_s,
            measured_gbps=self.bw.gbps,
            compression_ratio=self.tiers.compression_ratio if self.tiers.compress else 1.0,
            acceptance=acc,
            k_max=self.spec_k_max,
        )
        self._spec_plan_k = k
        if k > 1:
            if st is None:
                self._spec_state = SpecState(k)
            else:
                st.k_plan = k
                st.k_eff = max(2, min(st.k_eff, min_pow2_le(k)))

    def _init_draft_cache(self) -> Dict:
        return kvcache.init_cache(self.cfg, self._group_size, self.max_len,
                                  self.cfg.torch_dtype, self.device)["blocks"]

    def _draft_prefill_fn(self):
        """The draft cache of one slot: ``Model.prefill`` of its committed
        stream on [1, max_len] (the full stack under the end mask: flash
        attention, the gate and the expert FFN on the card)."""
        if self._spec_prefill is None:
            model, max_len = self.model, self.max_len

            def spec_draft_prefill(params, tokens, emask):
                _, cache = model.prefill(params, {"tokens": tokens}, max_len=max_len,
                                         expert_mask=emask)
                return cache["blocks"]

            self._spec_prefill = ShapeSignatures(
                spec_draft_prefill, self._traces.setdefault("spec_draft_prefill", set()),
                self._build_gen)
        return self._spec_prefill

    def _spec_fns_for_k(self, k: int):
        """The three speculative stage functions at chunk size k (made
        lazily, kept until the next stage rebuild): the draft scan, the end
        tier's C = k chunk and the cloud's C = k verify."""
        if k in self._spec_fns:
            return self._spec_fns[k]
        cfg = self.cfg

        def spec_draft(params, tokens, blocks, lengths, emask):
            # k greedy steps off the dense draft cache: step 0 consumes the
            # pending token, step i its predecessor's argmax; the k-th draft
            # is not verified, but its write keeps the cache contiguous
            # through base + k - 1 for a full accept
            drafts = []
            for _ in range(k):
                x = transformer.embed_inputs(params, cfg, tokens)
                x, blocks, _ = transformer.apply_stack_decode(
                    params, x, cfg,
                    attn.model_angles(cfg, lengths[:, None]),
                    blocks, lengths, emask,
                )
                logits = transformer.lm_logits(params, cfg, x)[:, 0]
                tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                drafts.append(tokens[:, 0])
                lengths = lengths + 1
            return torch.stack(drafts, dim=1), blocks

        end_chunk, cloud_verify = self._spec_bodies
        gen = self._build_gen

        def counted(name, fn):
            return ShapeSignatures(fn, self._traces.setdefault(name, set()), gen)

        fns = (counted(f"spec_draft_k{k}", spec_draft), counted(f"spec_end_k{k}", end_chunk),
               counted(f"spec_cloud_k{k}", cloud_verify))
        self._spec_fns[k] = fns
        self._warmup_spec_fns(k, fns)
        return fns

    def _warmup_spec_fns(self, k: int, fns):
        """First launches at the group and chunk shapes, writes to the
        garbage page and a fresh draft cache, so measured rounds are warm."""
        draft_fn, end_fn, cloud_fn = fns
        gsz = self._group_size
        inactive = np.zeros((gsz,), bool)
        zeros = self._ints(np.zeros((gsz,)))
        draft_fn(self._cparams, self._ints(np.zeros((gsz, 1))), self._init_draft_cache(),
                 zeros, self.tiers.end_mask)
        te = self.end_pool.device_rows(range(gsz), active=inactive, device=self.device)
        tc = self.cloud_pool.device_rows([self._cslot(s) for s in range(gsz)], active=inactive,
                                         device=self.device)
        valid = self._ints(np.ones((gsz,)))
        z, _ = end_fn(self.end_params, self._ints(np.zeros((gsz, k))), self._end_pages, te,
                      zeros, valid, *self._eargs())
        cloud_fn(self.cloud_params, z, self._cloud_pages, tc, zeros, valid)
        self._sync()

    def _draft_seconds(self, n_tokens: int, measured_s: float) -> float:
        """End-tier seconds of ``n_tokens`` through the FULL stack (the draft
        runs every block on the end device): ``measured_s`` in measured
        timing, else the capability model's."""
        if self.timing != "modeled":
            return measured_s
        rate = self.tiers.end_cap.gflop_budget * 1e3
        return n_tokens * sum(self.tiers.layer_gflops) / max(rate, 1e-9)

    def _install_draft(self, slot: int):
        """(Re)build one slot's draft cache from its committed stream, at
        activation, after a restore, and when the plan turns speculation on
        mid-run; the end tier pays the forward on the timeline."""
        req = self.slots[slot]
        L = int(self._slot_len[slot])
        stream = list(req.prompt) + list(req.generated)
        padded = np.zeros((1, self.max_len), np.int32)
        padded[0, :L] = np.asarray(stream[:L], np.int32)
        blocks, t = self._measure(self._draft_prefill_fn(), self._cparams, self._ints(padded),
                                  self.tiers.end_mask)
        td = self._draft_seconds(L, t)
        g = self._group_of(slot)
        r = slot - g * self._group_size
        if self._draft_cache[g] is None:
            self._draft_cache[g] = self._init_draft_cache()
        for pos, entry in self._draft_cache[g].items():
            for n, big in entry.items():
                big[:, r] = blocks[pos][n][:, 0].to(big.dtype)
        self._draft_len[slot] = L
        self._draft_ready[slot] = True
        done = self.timeline.occupy(self._res_end, self._group_ready_s[g], td)
        self._prefill_busy["end"] += td
        self._group_ready_s[g] = max(self._group_ready_s[g], done)

    def _spec_refresh_drafts(self):
        """Build draft caches for active slots that lack one, while their
        group is drained (a pending round's commit cannot clobber them)."""
        for slot in range(self.max_batch):
            if (self._active[slot] and not self._draft_ready[slot]
                    and self.slots[slot] is not None
                    and self._phase[self._group_of(slot)] == "ready"):
                self._install_draft(slot)

    def _spec_round_k(self, g: int) -> int:
        """The group's draft length for its next round: the adaptive k while
        speculation is planned and some active row has a current draft
        cache and two tokens of budget left; 1 (a plain round) otherwise."""
        if self._spec_plan_k <= 1 or self._spec_state is None:
            return 1
        gs, ge = self._group_slices[g]
        for s in range(gs, ge):
            req = self.slots[s]
            if (self._active[s] and self._draft_ready[s] and req is not None
                    and req.max_new_tokens - len(req.generated) >= 2):
                return max(2, self._spec_state.k_eff)
        return 1

    def _run_end_stage_spec(self, g: int, k: int):
        """Speculative end stage: the draft scan, then the C = k boundary
        chunk.  The chunk's pages past the committed length are mapped
        provisionally (``map_tokens`` returns exactly the new entries); the
        commit or rollback comes when the verify ids drain."""
        gs, ge = self._group_slices[g]
        gsz = ge - gs
        active = self._active[gs:ge]
        base_len = self._slot_len[gs:ge].copy()
        draft_fn, end_fn, _ = self._spec_fns_for_k(k)
        # positions a row verifies: k with a current draft cache and the
        # budget, the bare pending token otherwise; inactive rows verify one
        # padding position that writes to the garbage page
        n_valid = np.ones((gsz,), np.int64)
        for i, slot in enumerate(range(gs, ge)):
            req = self.slots[slot]
            if req is not None and self._active[slot] and self._draft_ready[slot]:
                n_valid[i] = max(1, min(k, req.max_new_tokens - len(req.generated)))

        tokens = self._ints(self._next_token[gs:ge])
        dcache = self._draft_cache[g]
        if dcache is None:
            dcache = self._init_draft_cache()
        (drafts, dcache), td = self._measure(
            draft_fn, self._cparams, tokens, dcache, self._ints(self._draft_len[gs:ge]),
            self.tiers.end_mask)
        td = self._draft_seconds(gsz * k, td)
        self._draft_cache[g] = dcache

        # provisional pages in both pools, in lockstep
        new_entries: Dict[int, List[int]] = {}
        for i, slot in enumerate(range(gs, ge)):
            if not self._active[slot]:
                continue
            L = int(base_len[i])
            ents = self.end_pool.map_tokens(slot, L, L + int(n_valid[i]))
            ents_c = self.cloud_pool.map_tokens(self._cslot(slot), L, L + int(n_valid[i]))
            if ents != ents_c:
                raise RuntimeError(f"tier pools out of lockstep for slot {slot}: "
                                   f"{ents} vs {ents_c}")
            new_entries[slot] = ents

        chunk = torch.cat([tokens, drafts[:, : k - 1]], dim=1)
        table = self.end_pool.device_rows(range(gs, ge), active=active, device=self.device)
        start, nv = self._ints(base_len), self._ints(n_valid)
        (z, self._end_pages), te = self._measure(
            end_fn, self.end_params, chunk, self._end_pages, table, start, nv, *self._eargs())
        te = self._stage_seconds("end", gsz * k, te)

        # meter the valid positions of active rows only
        n_tok_active = int(n_valid[active].sum())
        t_comm = self._link_transfer(payload_nbytes(_row(z, 0, 0)) * n_tok_active)
        if self._expert_pooled:
            self.expert_routed_tokens += n_tok_active

        self._book_end_stage(g, td + te, t_comm, z)
        self._spec_pending[g] = {"k": k, "drafts": drafts, "base_len": base_len,
                                 "n_valid": n_valid, "new_entries": new_entries}

    def _drain_cloud_stage_spec(self, g: int) -> Dict:
        """Cloud half of a round: one C = k verify chunk off the paged
        pools.  The drafts and verify ids stay on the device until the
        tick's one batched copy (``_harvest_drained``)."""
        pend = self._spec_pending[g]
        gs, ge = self._group_slices[g]
        k = pend["k"]
        _, _, cloud_fn = self._spec_fns_for_k(k)
        active = self._active[gs:ge]
        table = self.cloud_pool.device_rows([self._cslot(s) for s in range(gs, ge)],
                                            active=active, device=self.device)
        (ids, self._cloud_pages), tc = self._measure(
            cloud_fn, self.cloud_params, self._boundary[g], self._cloud_pages, table,
            self._ints(pend["base_len"]), self._ints(pend["n_valid"]))
        tc = self._stage_seconds("cloud", (ge - gs) * k, tc)

        # one verify id back a valid position of each active row
        done_c = self._book_cloud_stage(g, tc, int(pend["n_valid"][active].sum()))
        self._spec_pending[g] = None
        return {"g": g, "done_c": done_c, "dev": (pend["drafts"], ids), "pend": pend}

    def _spec_commit(self, rec: Dict, drafts: np.ndarray, verify: np.ndarray) -> int:
        """Host side of a round: greedy accept a row, roll the provisional
        pages past the committed prefix back in both pools, commit the
        accepted tokens, feed the acceptance EMA."""
        g, pend = rec["g"], rec["pend"]
        gs, ge = self._group_slices[g]
        active = self._active[gs:ge]
        nv_eff = np.where(active, pend["n_valid"], 0)
        committed, _ = batched_accept(drafts, verify, nv_eff)
        emitted = n_drafted = n_accepted = 0
        rolled = False
        for i, slot in enumerate(range(gs, ge)):
            if not active[i]:
                continue
            toks = committed[i]
            L = int(pend["base_len"][i])
            rb = rollback_entries(pend["new_entries"].get(slot, []), base_len=L,
                                  n_commit=len(toks), page_size=self.page_size,
                                  pages_per_slot=self.pages_per_slot)
            if rb:
                self.end_pool.rollback(slot, rb)
                self.cloud_pool.rollback(self._cslot(slot), rb)
                rolled = True
            self._slot_len[slot] = L + len(toks)
            if self._draft_ready[slot]:
                # the accepted prefix is what the draft scan wrote
                self._draft_len[slot] = L + len(toks)
            n_drafted += int(nv_eff[i]) - 1
            n_accepted += len(toks) - 1
            emitted += self._harvest_tokens(slot, toks)
        if self._spec_state is not None:
            self._spec_state.observe_round(n_drafted, n_accepted,
                                           rolled_back=rolled or n_accepted < n_drafted)
        return emitted

    # -- admission: chunked prefill as a pipeline stage -----------------------

    def _group_of(self, slot: int) -> int:
        return slot // self._group_size

    def _slot_usable(self, slot: int) -> bool:
        # padding slots never admit; slots mid-prefill are spoken for
        return slot < self.request_capacity and slot not in self._jobs

    def _pages_for(self, req: Request) -> int:
        return kvcache.pages_needed(
            len(req.prompt) + req.max_new_tokens, self.page_size, self.pages_per_slot
        )

    def _page_capacity(self):
        return min(self.end_pool.num_pages, self.cloud_pool.num_pages)

    def _admit(self):
        """Admit waiting requests in ``_admission_order``: reserve the
        request's worst-case pages in BOTH tier pools, then start a chunked
        prefill job or, for a preempted request, restore its spilled KV and
        resume decode.  The order head blocks its order; when it outranks
        running work and preemption is on, a lower-priority slot is spilled
        and admission retries."""
        while True:
            self._admit_pass()
            if not (self.preemption and self._try_preempt()):
                break

    def _admit_pass(self) -> int:
        admitted = 0
        free = [s for s in range(self.max_batch)
                if self.slots[s] is None and self._slot_usable(s)]
        for req in self._admission_order():
            spilled = req.request_id in self._spilled
            # a restore activates its slot at once: only where the slot's
            # group has no boundary in flight
            usable = [s for s in free
                      if not spilled or self._phase[self._group_of(s)] == "ready"]
            if not usable:
                break
            need = self._pages_for(req)
            if not (self.end_pool.can_reserve(need) and self.cloud_pool.can_reserve(need)):
                break
            slot = usable[0]
            free.remove(slot)
            self.waiting.remove(req)
            if spilled:
                self._restore_into_slot(slot, req)  # restore_slot reserves
            else:
                self.end_pool.reserve(slot, need)
                self.cloud_pool.reserve(self._cslot(slot), need)
                job = _PrefillJob(req, slot, self._group_of(slot))
                if self._virtual_time:
                    job.ready_s = req.submit_time  # no prefill before arrival
                self._jobs[slot] = job
            admitted += 1
        return admitted

    # -- preemption: spill a lower-priority slot at the drained safe point ----

    def preemptible_slots(self, priority: int) -> int:
        """Running slots of a strictly lower class than ``priority`` (the
        victims a request of that class could evict); 0 with preemption
        off."""
        if not self.preemption:
            return 0
        return sum(1 for s in range(self.max_batch)
                   if self.slots[s] is not None and self.slots[s].priority > priority)

    def _try_preempt(self) -> bool:
        """If the admission head outranks running work and cannot be
        admitted, spill one victim: the youngest decoding slot of the lowest
        class below the head's.  Prefill jobs are never victims.  Nothing is
        spilled unless evicting every candidate would free the head's pages
        in both pools.  Returns True iff a victim was spilled."""
        queue = self._admission_order()
        if not queue:
            return False
        head = queue[0]
        victims = [s for s in range(self.max_batch)
                   if self.slots[s] is not None and self.slots[s].priority > head.priority]
        if not victims:
            return False
        need = self._pages_for(head)
        e_avail = self.end_pool.pages_available + sum(
            self.end_pool.reserved_pages(s) for s in victims)
        c_avail = self.cloud_pool.pages_available + sum(
            self.cloud_pool.reserved_pages(self._cslot(s)) for s in victims)
        if e_avail < need or c_avail < need:
            return False
        _, _, victim = max((self.slots[s].priority, self.slots[s].seq, s) for s in victims)
        self._preempt_slot(victim)
        return True

    def _spill_slot_state(self, slot: int) -> _SpillState:
        """Copy the slot's mapped page rows of every leaf of both pools to
        the host (copies: the freed pages are mapped again before the
        restore), the tiers merged in block order, and free the slot.  Its
        group is drained, so the slot is at a token boundary: the pending
        token's KV is not written yet."""
        entries, phys_e, n_pages = self.end_pool.spill_slot(slot)
        entries_c, phys_c, _ = self.cloud_pool.spill_slot(self._cslot(slot))
        if not np.array_equal(entries, entries_c):
            raise RuntimeError(f"tier pools out of lockstep for slot {slot}: "
                               f"{entries.tolist()} vs {entries_c.tolist()}")
        ie = torch.from_numpy(phys_e).to(self.device)
        ic = torch.from_numpy(phys_c).to(self.device)
        blocks = {pos: {n: torch.cat([leaf[:, ie], self._cloud_pages[pos][n][:, ic]]).cpu()
                        for n, leaf in entry.items()}
                  for pos, entry in self._end_pages.items()}
        st = _SpillState(entries, blocks, int(self._slot_len[slot]),
                         int(self._next_token[slot, 0]), n_pages)
        self.slots[slot] = None
        self._active[slot] = False
        self._slot_len[slot] = 0
        self._draft_ready[slot] = False
        return st

    def _preempt_slot(self, slot: int):
        """Spill a decoding slot and queue its request again, the spilled KV
        kept under its request id."""
        req = self.slots[slot]
        st = self._spill_slot_state(slot)
        self._spilled[req.request_id] = st
        self.preempt_spill_bytes += st.nbytes
        req.n_preemptions += 1
        self.n_preemptions += 1
        self.waiting.append(req)

    def _restore_into_slot(self, slot: int, req: Request):
        """Re-admit a preempted request: both pools re-reserve its pages and
        map its spilled entries, the saved rows are scattered into the new
        physical rows split at the current split, and decode resumes where
        it stopped.  Its draft cache is rebuilt at the next drained tick."""
        st = self._spilled.pop(req.request_id)
        ie = torch.from_numpy(self.end_pool.restore_slot(slot, st.entries, st.n_pages))
        ic = torch.from_numpy(self.cloud_pool.restore_slot(self._cslot(slot), st.entries,
                                                           st.n_pages))
        ie, ic, s = ie.to(self.device), ic.to(self.device), self.split
        for pos, entry in st.blocks.items():
            for n, saved in entry.items():
                saved = saved.to(self.device)
                self._end_pages[pos][n][:, ie] = saved[:s]
                self._cloud_pages[pos][n][:, ic] = saved[s:]
        self._slot_len[slot] = st.length
        self.slots[slot] = req
        self._next_token[slot, 0] = st.next_token
        self._active[slot] = True
        self._draft_ready[slot] = False
        if st.migrated:
            self.n_migration_restores += 1
            req.n_migrations += 1
        else:
            self.n_preempt_restores += 1
        if self._virtual_time:
            # the resumed stream cannot decode before "now"
            g = self._group_of(slot)
            self._group_ready_s[g] = max(self._group_ready_s[g], self.clock.now)

    def _advance_prefill(self, job: _PrefillJob):
        """Stream one prompt chunk through end -> link -> cloud, booking the
        same timeline resources as decode."""
        req, slot = job.req, job.slot
        S = len(req.prompt)
        C = self.prefill_chunk
        p0 = job.pos
        v = min(C, S - p0)
        self.end_pool.map_range(slot, p0, p0 + v)
        self.cloud_pool.map_range(self._cslot(slot), p0, p0 + v)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :v] = req.prompt[p0 : p0 + v]
        tokens, start, valid = self._ints(chunk), self._ints([p0]), self._ints([v])

        (z, self._end_pages), te = self._measure(
            self._end_prefill_chunk, self.end_params, tokens, self._end_pages,
            self.end_pool.device_rows([slot], device=self.device), start, valid,
            *self._eargs(),
        )
        te = self._stage_seconds("end", v, te)
        # meter only the valid rows: padding never crosses the wire
        t_comm = self._link_transfer(payload_nbytes(_row(z, 0, 0)) * v)
        (ids, self._cloud_pages), tc = self._measure(
            self._cloud_prefill_chunk, self.cloud_params, z, self._cloud_pages,
            self.cloud_pool.device_rows([self._cslot(slot)], device=self.device), start, valid,
        )
        tc = self._stage_seconds("cloud", v, tc)

        done_e = self.timeline.occupy(self._res_end, job.ready_s, te)
        done_l = self.timeline.occupy(self._res_link, done_e, t_comm)
        job.ready_s = self.timeline.occupy(self._res_cloud, done_l, tc)
        self._prefill_busy["end"] += te
        self._prefill_busy["link"] += t_comm
        self._prefill_busy["cloud"] += tc
        self.n_prefill_chunks += 1

        job.pos += v
        if job.pos >= S:
            # the tick's one batched copy resolves it (_resolve_prefill_tokens)
            job.first_tok_dev = ids[0]
            self.link.record_down(element_bytes(torch.int32))  # first token id

    def _resolve_prefill_tokens(self):
        """Every finished prefill's first token in ONE device->host copy."""
        pend = [job for _, job in sorted(self._jobs.items()) if job.first_tok_dev is not None]
        if not pend:
            return
        host = torch.stack([job.first_tok_dev for job in pend]).cpu().tolist()
        self.n_host_syncs += 1
        for job, tok in zip(pend, host):
            job.first_tok = int(tok)
            job.first_tok_dev = None

    def _activate_ready_jobs(self):
        """Finished prefill jobs claim their slot at the group's next drained
        tick (never while the group's boundary is in flight)."""
        for slot in sorted(self._jobs):
            job = self._jobs[slot]
            if job.first_tok is None or self._phase[job.group] != "ready":
                continue
            req, tok = job.req, job.first_tok
            req.generated.append(tok)
            if self._virtual_time:
                # the first token exists when the last chunk leaves the cloud
                self.clock.now = job.ready_s
            if req.first_token_time is None:
                req.first_token_time = self.clock()
            del self._jobs[slot]
            if tok == req.eos_id or len(req.generated) >= req.max_new_tokens:
                req.finish_time = self.clock()
                self.finished.append(req)
                self._release_slot(slot)
                continue
            self._slot_len[slot] = len(req.prompt)
            self.slots[slot] = req
            self._next_token[slot, 0] = tok
            self._active[slot] = True
            if self._spec_plan_k > 1:
                self._install_draft(slot)
            if self._virtual_time:
                # the group's next step cannot start before this prefill fed it
                self._group_ready_s[job.group] = max(self._group_ready_s[job.group], job.ready_s)

    def _release_slot(self, slot: int):
        self.end_pool.free(slot)
        self.cloud_pool.free(self._cslot(slot))
        self._slot_len[slot] = 0
        self._draft_ready[slot] = False

    def busy(self) -> bool:
        return super().busy() or bool(self._jobs)

    def _progress_sig(self) -> tuple:
        # pipeline stages, prefill chunks, spills and restores, slab
        # transfers and speculative rounds count as progress
        st = self._spec_state
        return super()._progress_sig() + (
            self.n_stage_steps, self.n_prefill_chunks,
            self.n_preemptions, self.n_preempt_restores, self.n_migration_restores,
            self.transfer_retries,
            self.n_expert_prefetches if self._expert_pooled else 0,
            st.rounds if st else 0, st.rollbacks if st else 0,
        )

    def stall_diagnostic(self) -> str:
        return (super().stall_diagnostic()
                + f" jobs={sorted(self._jobs)} spilled={len(self._spilled)}"
                + f" phases={list(self._phase)}"
                + f" pages_end={self.end_pool.pages_available}"
                + f" pages_cloud={self.cloud_pool.pages_available}"
                + f" link_degraded={self.link_degraded}")

    # -- pipelined stepping ---------------------------------------------------

    def _group_active(self, g: int) -> bool:
        gs, ge = self._group_slices[g]
        return bool(self._active[gs:ge].any())

    def _stage_seconds(self, stage: str, batch: int, measured_s: float) -> float:
        """The stage's service time: ``measured_s`` in measured timing, else
        ``batch`` tokens through this tier's block range at the device's
        modeled capability rate.  The cloud rate is one server's: a fleet's
        cloud contention is the timeline's multi-server queue, so the
        lane's share is divided back out."""
        if self.timing != "modeled":
            return measured_s
        lg = self.tiers.layer_gflops
        s = self.split
        if stage == "end":
            gflops = batch * sum(lg[:s])
            rate = self.tiers.end_cap.gflop_budget * 1e3
        else:
            gflops = batch * sum(lg[s:])
            rate = self.tiers.cloud_cap.gflop_budget / max(self._cloud_share, 1e-12) * 1e3
        return gflops / max(rate, 1e-9)

    def _link_transfer(self, nbytes: int) -> float:
        """Meter one boundary upload; returns its modeled time: the wire
        time plus the round trip every attempt pays (``link_rtt_s``, what
        speculative decode spreads over k tokens).  An armed transfer fault
        fails the attempt: the resend waits the health monitor's backoff
        and crosses the wire again, metered.  The attempt that exhausts
        ``max_transfer_attempts`` raises: a link that eats every retry is a
        blackout, and the blackout rung handles those."""
        total = self.link_rtt_s + self.link.record_up(nbytes, self.bw.gbps)
        attempt = 0
        while self._transfer_faults > 0:
            self._transfer_faults -= 1
            if attempt + 1 >= self.health.max_transfer_attempts:
                raise RuntimeError(
                    f"boundary transfer failed {attempt + 1} times (max_transfer_attempts="
                    f"{self.health.max_transfer_attempts}); link presumed dead")
            # the reference's order of additions: the modeled stamps match
            total += self.health.backoff_s(attempt)
            total += self.link_rtt_s + self.link.record_up(nbytes, self.bw.gbps)
            self.transfer_retries += 1
            attempt += 1
        return total

    def inject_transfer_faults(self, count: int):
        """Arm ``count`` boundary-upload failures: the next uploads consume
        them one an attempt, each resent after a backoff."""
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        self._transfer_faults += count

    def _spec_abort(self, g: int):
        """Drop a group's in-flight speculative round: its provisional pages
        unmap in both pools and nothing commits; the slots stay at the
        token boundary before the round, as with a dropped plain
        boundary."""
        pend = self._spec_pending[g]
        if pend is None:
            return
        for slot, ents in pend["new_entries"].items():
            if ents:
                self.end_pool.rollback(slot, ents)
                self.cloud_pool.rollback(self._cslot(slot), ents)
        self._spec_pending[g] = None
        gs, ge = self._group_slices[g]
        self._draft_ready[gs:ge] = False
        if self._spec_state is not None:
            self._spec_state.rollbacks += 1

    def evacuate(self) -> Tuple[List[Request], Dict[int, _SpillState], int]:
        """The lane's device died: hand all its work back to the fleet.
        In-flight boundaries are dropped (the slots are still at the token
        boundary before the step, so the next lane recomputes it), and an
        in-flight speculative round unmaps its provisional pages first, so
        no unverified KV rides along.  Every decoding slot is spilled
        through the preemption path, marked migrated (its rows merged
        across the tiers, so a lane at another split restores them
        exactly); prefill jobs restart from scratch (their first token was
        never appended, so nothing repeats); the lane's parked spill states
        migrate too.  Returns (the requests in submission order, request id
        -> spill state, the spilled bytes at the stored type)."""
        for g in range(self.n_groups):
            self._spec_abort(g)
            self._boundary[g] = None
            self._phase[g] = "ready"
        spilled: Dict[int, _SpillState] = {}
        nbytes = 0
        for slot in range(self.max_batch):
            req = self.slots[slot]
            if req is None:
                continue
            st = self._spill_slot_state(slot)
            st.migrated = True
            spilled[req.request_id] = st
            nbytes += st.nbytes
            self.waiting.append(req)
        for slot in sorted(self._jobs):
            job = self._jobs.pop(slot)
            self._release_slot(slot)
            self.waiting.append(job.req)
        for rid, st in self._spilled.items():
            st.migrated = True  # preempted here earlier: its KV moves too
            spilled[rid] = st
            nbytes += st.nbytes
        self._spilled = {}
        reqs = sorted(self.waiting, key=lambda r: r.seq)
        self.waiting = []
        return reqs, spilled, nbytes

    def set_cloud_share(self, share: float):
        """Re-scale this lane's share of the fleet's cloud (a cloud server
        died): one server's service time in ``_stage_seconds`` stays, as the
        budget and the share scale together, but the planner sees less
        aggregate cloud, so the split may move at the next safe point."""
        old = max(self._cloud_share, 1e-12)
        self.tiers = dataclasses.replace(self.tiers, cloud_cap=dataclasses.replace(
            self.tiers.cloud_cap, gflop_budget=self.tiers.cloud_cap.gflop_budget * share / old))
        self._cloud_share = share
        if not self.link_degraded:
            self._check_replan()

    def _run_end_stage(self, g: int):
        k = self._spec_round_k(g)
        if k > 1:
            self._run_end_stage_spec(g, k)
            return
        gs, ge = self._group_slices[g]
        for slot in range(gs, ge):
            if self._active[slot]:
                self.end_pool.append(slot, int(self._slot_len[slot]))
                self.cloud_pool.append(self._cslot(slot), int(self._slot_len[slot]))
        active = self._active[gs:ge]
        tokens = self._ints(self._next_token[gs:ge])
        table = self.end_pool.device_rows(range(gs, ge), active=active, device=self.device)
        lengths = self._ints(self._slot_len[gs:ge])
        out, te = self._measure(self._end_step, self.end_params, tokens, self._end_pages,
                                table, lengths, *self._eargs())
        te = self._stage_seconds("end", ge - gs, te)
        z, self._end_pages = out[:2]
        if self._route_stats_enabled:
            self._observe_route_stats(out[2])

        # meter only active slots' boundary rows: inactive and padding
        # slots' activations never cross the wire
        n_active = int(active.sum())
        t_comm = self._link_transfer(payload_nbytes(_row(z, 0)) * n_active)
        if self._expert_pooled:
            self.expert_routed_tokens += n_active

        self._book_end_stage(g, te, t_comm, z)

    def _book_end_stage(self, g: int, t_end: float, t_comm: float, z):
        """Book a group's end stage and its upload on the timeline and the
        decode-only clock; its boundary payload ``z`` is now in flight."""
        done_e = self.timeline.occupy(self._res_end, self._group_ready_s[g], t_end)
        done_l = self.timeline.occupy(self._res_link, done_e, t_comm)
        m_e = self._metric_clock.occupy("end", self._m_group_ready[g], t_end)
        self._m_boundary_ready[g] = self._metric_clock.occupy("link", m_e, t_comm)
        self._stage_busy["end"] += t_end
        self._stage_busy["link"] += t_comm
        self.n_stage_steps += 1
        self._boundary[g] = z
        self._boundary_ready_s[g] = done_l
        self._phase[g] = "boundary"

    def _book_cloud_stage(self, g: int, t_cloud: float, n_ids: int) -> float:
        """Book a group's cloud stage after its boundary arrived, and the
        ``n_ids`` token ids sent back down; the group is drained.  Returns
        the stage's modeled completion."""
        self._group_ready_s[g] = self.timeline.occupy(self._res_cloud, self._boundary_ready_s[g],
                                                      t_cloud)
        self._m_group_ready[g] = self._metric_clock.occupy(
            "cloud", self._m_boundary_ready[g], t_cloud)
        self._stage_busy["cloud"] += t_cloud
        self.link.record_down(n_ids * element_bytes(torch.int32))
        self._boundary[g] = None
        self._phase[g] = "ready"
        return self._group_ready_s[g]

    def _drain_cloud_stage(self, g: int) -> Dict:
        """Run the cloud half of an in-flight boundary; the token ids stay
        on the device until ``_harvest_drained`` moves every group's at
        once."""
        if self._spec_pending[g] is not None:
            return self._drain_cloud_stage_spec(g)
        gs, ge = self._group_slices[g]
        active = self._active[gs:ge]
        table = self.cloud_pool.device_rows([self._cslot(s) for s in range(gs, ge)],
                                            active=active, device=self.device)
        lengths = self._ints(self._slot_len[gs:ge])
        (ids_dev, self._cloud_pages), tc = self._measure(
            self._cloud_step, self.cloud_params, self._boundary[g], self._cloud_pages,
            table, lengths,
        )
        tc = self._stage_seconds("cloud", ge - gs, tc)

        # token ids back to the end tier, for the slots that decoded
        done_c = self._book_cloud_stage(g, tc, int(active.sum()))
        self._slot_len[np.nonzero(active)[0] + gs] += 1
        return {"g": g, "done_c": done_c, "dev": (ids_dev,)}

    def _harvest_drained(self, records: List[Dict]) -> int:
        """ONE device->host copy of every drained group's token ids (and a
        speculative round's drafts), then the per-group harvest in drain
        order: plain groups directly, speculative ones through accept and
        rollback (``_spec_commit``)."""
        devs = [t for rec in records for t in rec["dev"]]
        host = torch.cat([t.reshape(-1) for t in devs]).cpu().numpy()
        self.n_host_syncs += 1
        parts = iter(np.split(host, np.cumsum([t.numel() for t in devs])[:-1]))
        emitted = 0
        for rec in records:
            gs, ge = self._group_slices[rec["g"]]
            if self._virtual_time:
                # this group's finish stamps land at its cloud completion
                self.clock.now = rec["done_c"]
            if "pend" in rec:
                drafts, verify = (next(parts).reshape(t.shape) for t in rec["dev"])
                emitted += self._spec_commit(rec, drafts, verify)
            else:
                ids = np.zeros((self.max_batch,), np.int64)
                ids[gs:ge] = next(parts)
                emitted += self._harvest(ids, slot_range=range(gs, ge))
        return emitted

    def step(self) -> int:
        """One engine tick: drain in-flight boundaries on the cloud tier,
        advance slab prefetches, apply a pending replan at the safe point,
        admit, stream one prefill chunk per job, activate finished jobs, and
        refill the end tier, so group A's cloud step overlaps group B's end
        step and a long prompt's prefill never stalls other groups."""
        emitted = 0
        if self.link_degraded:
            self.degraded_ticks += 1
        drained = [self._drain_cloud_stage(g) for g in range(self.n_groups)
                   if self._phase[g] == "boundary"]
        if drained:
            emitted += self._harvest_drained(drained)
        self._advance_expert_prefetch()
        self._apply_pending_replan()
        self._admit()
        for slot in sorted(self._jobs):
            job = self._jobs[slot]
            if job.first_tok is None and job.first_tok_dev is None:
                self._advance_prefill(job)
        self._resolve_prefill_tokens()
        if self._spec_plan_k > 1:
            self._spec_refresh_drafts()
        self._activate_ready_jobs()
        for g in range(self.n_groups):
            if self._phase[g] == "ready" and self._group_active(g):
                self._run_end_stage(g)
        return emitted

    # -- dynamic replanning ---------------------------------------------------

    def observe_bandwidth(self, gbps: float, *, hard: bool = False):
        """Feed a link measurement; triggers a replan check.  ``hard=True``
        bypasses the EWMA: a *declared* link event (a blackout beginning or
        ending) takes effect at the next safe point."""
        if hard:
            self.bw.set_rate(gbps)
            # the blackout ladder keys on declared rates only
            self._update_link_health()
        else:
            self.bw.observe_rate(gbps)
        if not self.link_degraded:
            self._check_replan()
        # the draft length tracks the same link: a faster one turns
        # speculation off (compute-bound), a slower one on or longer
        self._recompute_spec_plan()

    def _update_link_health(self):
        """Bottom rung of the degradation ladder: below ``blackout_gbps``
        pin the plan to split 0 (cloud-only), which the planner would not
        choose itself (boundary bytes do not depend on the split); on
        recovery the ordinary replan path unwinds the pin."""
        blacked = self.bw.gbps < self.blackout_gbps
        if blacked and not self.link_degraded:
            self.link_degraded = True
            self._blackout_since = self.clock()
            self._pending_plan = plan_pipeline_split(
                self.tiers.layer_gflops,
                self.tiers.boundary_bytes,
                dataclasses.replace(self.tiers.end_cap, net_gbps=self.bw.gbps),
                self.tiers.cloud_cap,
                compression_ratio=self.tiers.compression_ratio,
                alpha=self.tiers.alpha,
                edge_boundary=True,
                pin_split=0,
            )
        elif not blacked and self.link_degraded:
            self.link_degraded = False
            self.link_blackout_s += max(0.0, self.clock() - self._blackout_since)
            self._check_replan(force=True)

    def blackout_seconds(self) -> float:
        """Wall-clock spent under a blacked-out link, an open window too."""
        open_s = max(0.0, self.clock() - self._blackout_since) if self.link_degraded else 0.0
        return self.link_blackout_s + open_s

    def update_device_state(self, end_state: DeviceState):
        """Feed a new end-device state (eq. 2): re-derive the end capability
        AND the expert mask (eq. 2-4), then re-check the plan; mask changes
        apply at the same safe point as split changes."""
        new_mask = self._derive_end_mask(end_state)
        # rejected before any engine state moves
        validate_expert_mask(
            new_mask, self.cfg.moe.num_experts if self.cfg.moe is not None else None,
            where="update_device_state(end_mask)",
        )
        self.end_state = end_state
        self.tiers = dataclasses.replace(self.tiers, end_cap=capability(self.end_profile, end_state))
        mask_changed = not _masks_equal(new_mask, self._end_mask_np)
        # an unchanged mask cancels a pending change of an earlier state
        self._pending_mask = new_mask if mask_changed else _KEEP
        if self._expert_pooled:
            # the memory budget may have moved even where the mask did not:
            # reconcile at the next safe point, and start the transfers now
            # (set_capacity never evicts)
            self._expert_dirty = True
            self.expert_pool.set_capacity(self._expert_capacity())
            target = np.asarray(new_mask if mask_changed else self._end_mask_np, bool)
            wanted, _ = self._plan_residency(self._active_lids(), target)
            self._prefetch_queue = list(wanted)
        # a default bandwidth_free of 1.0 means "not measured"
        if end_state.bandwidth_free != 1.0:
            self.bw.observe_rate(self.tiers.end_cap.net_gbps)
        self._check_replan(force=mask_changed)

    def _check_replan(self, force: bool = False):
        if self.link_degraded:
            return  # the degradation ladder owns the plan while the link is dark
        plan, changed = replan_pipeline(
            self.plan,
            self.tiers.layer_gflops,
            self.tiers.boundary_bytes,
            self.tiers.end_cap,
            self.tiers.cloud_cap,
            measured_gbps=self.bw.gbps,
            compression_ratio=self.tiers.compression_ratio,
            alpha=self.tiers.alpha,
            edge_boundary=True,
        )
        moved = (plan.split_layer != self.plan.split_layer
                 or plan.compress_boundary != self.plan.compress_boundary)
        if changed or moved or force:
            self._pending_plan = plan  # needs the drained safe point
        else:
            # the split and codec stand: adopt the refreshed estimates
            self._pending_plan = None
            self.tiers = dataclasses.replace(self.tiers, plan=plan)

    def _defrag_pools(self):
        """Compact the engine's own pools and permute their storage rows to
        match.  A fleet's shared cloud pool is never compacted here: its
        permutation applies to every lane's storage
        (``FleetServingEngine.defrag_kv``)."""
        pools = [(self.end_pool, "_end_pages")]
        if not self._cloud_shared:
            pools.append((self.cloud_pool, "_cloud_pages"))
        for pool, attr in pools:
            perm = torch.from_numpy(pool.defrag()).to(self.device)
            pages = getattr(self, attr)
            setattr(self, attr, {pos: {k: leaf[:, perm] for k, leaf in entry.items()}
                                 for pos, entry in pages.items()})

    def _resplit_shared(self, old_split: int, cloud_rows: np.ndarray, e2c: np.ndarray,
                        c2e: np.ndarray):
        """:func:`kvcache.resplit_paged_blocks` against a fleet's shared cloud
        storage: blocks entering the cloud tier are written at this lane's
        own pages only (the other rows are other lanes' KV), blocks leaving
        it are gathered into the end pool, and the storage keeps them."""
        new, kv = self.split, self._cloud_kv
        if new < old_split:  # blocks [new, old) end -> cloud
            kv.reserve(new)
            dst = cloud_rows[cloud_rows >= 0].astype(np.int64)
            src = torch.from_numpy(e2c[dst]).to(self.device)
            dst = torch.from_numpy(dst).to(self.device)
            lo, hi = new - kv.base, old_split - kv.base
            for pos, entry in self._end_pages.items():
                for n, leaf in entry.items():
                    kv.blocks[pos][n][lo:hi, dst] = leaf[new:old_split][:, src]
            self._end_pages = {pos: {n: leaf[:new] for n, leaf in entry.items()}
                               for pos, entry in self._end_pages.items()}
        else:  # blocks [old, new) cloud -> end
            perm = torch.from_numpy(c2e).to(self.device)
            cloud = kv.view(old_split)
            self._end_pages = {
                pos: {n: torch.cat([leaf, cloud[pos][n][:new - old_split][:, perm]])
                      for n, leaf in entry.items()}
                for pos, entry in self._end_pages.items()}

    def _apply_pending_replan(self):
        """Adopt a pending plan or mask once no boundary is in flight: re-split
        the params at the new block boundary, move the affected blocks'
        pages between the tier pools (a table-aware row permutation on the
        device), defrag the pools, reconcile the expert pool, and rebuild
        the stage functions when the split or the codec flag changed."""
        if (self._pending_plan is None and self._pending_mask is _KEEP
                and not (self._expert_pooled and self._expert_dirty)):
            return
        if any(p == "boundary" for p in self._phase):
            return
        had_pending = self._pending_plan is not None or self._pending_mask is not _KEEP
        plan = self._pending_plan or self.plan
        self._pending_plan = None
        old_split = self.split
        old_compress = self.tiers.compress
        mask_changed = self._pending_mask is not _KEEP
        updates: Dict = {"plan": plan}
        if mask_changed:
            self._end_mask_np = np.asarray(self._pending_mask, bool)
            updates["end_mask"] = torch.from_numpy(self._end_mask_np.copy()).to(self.device)
            self._pending_mask = _KEEP
            # the draft model speculates under the end mask: every draft
            # cache holds the old mask's KV
            self._draft_ready[:] = False
        self.tiers = dataclasses.replace(self.tiers, **updates)
        if self.split != old_split:
            self._split_params()
            cloud_rows = self.cloud_pool.table[self._cloud_base:self._cloud_base + self.max_batch]
            e2c = kvcache.page_perm(self.end_pool.table, cloud_rows,
                                    self.end_pool.num_pages, self.cloud_pool.num_pages)
            c2e = kvcache.page_perm(cloud_rows, self.end_pool.table,
                                    self.cloud_pool.num_pages, self.end_pool.num_pages)
            if self._cloud_kv is None:
                self._end_pages, self._cloud_pages = kvcache.resplit_paged_blocks(
                    self._end_pages, self._cloud_pages, old_split, self.split, e2c, c2e,
                )
            else:
                self._resplit_shared(old_split, cloud_rows, e2c, c2e)
            self._defrag_pools()
        if self._expert_pooled:
            # blocks entering the end tier fill their target residents with
            # the (unmetered) block re-split; every other change rides the
            # prefetch queue and the eviction plan
            instant = set()
            if self.split > old_split:
                R = self.cfg.block_repeat
                instant = {pi * R + b for pi in range(len(self._moe_pos))
                           for b in range(old_split, self.split)}
            self._expert_sync(instant_lids=instant)
        if (self.split != old_split or self.tiers.compress != old_compress
                or (mask_changed and not self._expert_pooled)):
            # pooled engines take the mask and tables as arguments: a
            # mask-only change needs no rebuild
            self._build_stage_fns()
        else:
            self._recompute_spec_plan()
        if had_pending:
            self.replan_events.append({
                "old_split": old_split,
                "new_split": self.split,
                "measured_gbps": self.bw.gbps,
                "compress": self.tiers.compress,
                "mask_changed": mask_changed,
            })

    # -- metrics --------------------------------------------------------------

    def stage_trace_counts(self) -> Dict[str, int]:
        """Distinct argument signatures per stage function, summed across
        rebuilds: bounded by the group and chunk shapes, not by prompt
        lengths."""
        return {k: len(v) for k, v in self._traces.items()}

    def _own_cloud(self) -> range:
        """This engine's slot rows of the (possibly shared) cloud pool."""
        return range(self._cloud_base, self._cloud_base + self.max_batch)

    def attn_bytes_step(self) -> Dict[str, int]:
        """KV bytes the paged attention sweep reads per decode step (both
        tiers, all layers, this engine's own rows of a shared cloud pool)
        at the current occupancy, beside a dense ``slots x ring`` sweep at
        the activation type."""
        return {
            "attn_bytes_paged_step": (
                self.end_pool.pages_in_use * kvcache.paged_block_bytes(self._end_pages)
                + self.cloud_pool.mapped_for(self._own_cloud())
                * kvcache.paged_block_bytes(self._cloud_pages)
            ),
            "attn_bytes_dense_step": (
                self.request_capacity * self.pages_per_slot * self._dense_page_bytes()
            ),
        }

    def _dense_page_bytes(self) -> int:
        R, s, ps = self.cfg.block_repeat, self.split, self.page_size
        return kvcache.dense_page_bytes(self.cfg, s, ps) + kvcache.dense_page_bytes(
            self.cfg, R - s, ps)

    def _expert_hit_rate(self) -> float:
        """Route-frequency-weighted residency coverage of the target set
        (measured EMA plus a uniform 1/E prior): 1.0 once every target
        expert of every active end layer is resident."""
        if not self._expert_pooled:
            return 1.0
        E = self.cfg.moe.num_experts
        f = (self._route_freq if self._route_freq is not None else np.zeros((E,))) + 1.0 / E
        t = self._end_mask_np
        num = den = 0.0
        for lid in self._active_lids():
            r = self.expert_pool.resident_mask(lid)
            num += float(f[t & r].sum())
            den += float(f[t].sum())
        return 1.0 if den == 0.0 else num / den

    def expert_metrics(self) -> Dict[str, float]:
        """Paged expert-weight accounting: residency, hit rate, transfer
        traffic, and the per-step expert bytes of the resident path (at the
        stored slab size) beside the dense ``[E, d, f]`` sweep (at the
        params' type, whatever the store holds)."""
        if not self._expert_pooled:
            return {}
        pool = self.expert_pool
        active = self._active_lids()
        sb, sbd = self._slab_bytes, self._slab_bytes_dense
        n_res_active = sum(pool.resident_count(lid) for lid in active)
        return {
            "expert_resident_slabs": pool.slabs_in_use,
            "expert_slab_capacity": pool.capacity,
            "expert_hit_rate": self._expert_hit_rate(),
            "expert_bytes_down": self.expert_bytes_down,
            "expert_bytes_peer": self.expert_bytes_peer,
            "expert_bytes_up": self.expert_bytes_up,
            "expert_bytes_resident": pool.slabs_in_use * sb,
            "expert_bytes_step_resident": n_res_active * sb,
            "expert_bytes_step_dense": len(active) * self.cfg.moe.num_experts * sbd,
            "expert_slab_bytes": sb,
            "expert_slab_bytes_dense": sbd,
            "expert_capacity_ratio": sbd / sb,
            "expert_quantized": float(self.quantize_experts),
            "expert_prefetches": self.n_expert_prefetches,
            "expert_peer_fetches": self.n_expert_peer_fetches,
            "expert_evictions": self.n_expert_evictions,
            "expert_routed_tokens": self.expert_routed_tokens,
        }

    def kv_metrics(self) -> Dict[str, float]:
        """Paged-KV memory accounting over both tiers.  With a fleet-shared
        cloud pool the in-use pages count this engine's rows only, while the
        peak is the pool's fleet-wide one (what admission gates on)."""
        end_pb = kvcache.paged_block_bytes(self._end_pages)
        cloud_pb = kvcache.paged_block_bytes(self._cloud_pages)
        dense_pb = self._dense_page_bytes()
        in_use = self.end_pool.pages_in_use + self.cloud_pool.mapped_for(self._own_cloud())
        cap = self.end_pool.num_pages + self.cloud_pool.num_pages
        return {
            **self.attn_bytes_step(),
            "kv_pages_in_use": in_use,
            "kv_pages_capacity": cap,
            "kv_utilization": in_use / cap,
            "kv_bytes_peak": (self.end_pool.peak_in_use * end_pb
                              + self.cloud_pool.peak_in_use * cloud_pb),
            "kv_bytes_dense_equiv": self.request_capacity * self.pages_per_slot * dense_pb,
            "kv_page_bytes": end_pb + cloud_pb,
            "kv_page_bytes_dense": dense_pb,
            "kv_capacity_ratio": dense_pb / (end_pb + cloud_pb),
            "kv_quantized": float(self.quantize_kv),
        }

    def metrics(self) -> Dict[str, float]:
        """The reference's metrics."""
        n = max(self.n_stage_steps, 1)
        mean = {r: t / n for r, t in self._stage_busy.items()}
        # the engine's own pipelined DECODE span (the decode-only clock)
        pipelined_total = max(self._m_group_ready)
        return {
            "split": self.split,
            "compressed": self.tiers.compress,
            "boundary_quantized": float(self.quantize_boundary),
            "n_groups": self.n_groups,
            "bytes_up": self.link.bytes_up,
            "transfers": self.link.transfers,
            "n_stage_steps": self.n_stage_steps,
            "mean_t_end_s": mean["end"],
            "mean_t_comm_s": mean["link"],
            "mean_t_cloud_s": mean["cloud"],
            # serial layout vs the pipelined resource-occupancy schedule
            "serial_step_s": mean["end"] + mean["link"] + mean["cloud"],
            "pipelined_step_s": pipelined_total / n,
            "plan_est_step_s": self.plan.est_step_time_s,
            "pipelined_total_s": pipelined_total,
            "serial_total_s": sum(self._stage_busy.values()),
            "prefill_s": sum(self._prefill_busy.values()),
            "prefill_chunks": self.n_prefill_chunks,
            "preemptions": self.n_preemptions,
            "preempt_restores": self.n_preempt_restores,
            "preempt_spill_bytes": self.preempt_spill_bytes,
            "migration_restores": self.n_migration_restores,
            "transfer_retries": self.transfer_retries,
            "degraded_ticks": self.degraded_ticks,
            "link_blackout_s": self.blackout_seconds(),
            "replan_events": len(self.replan_events),
            "measured_gbps": self.bw.gbps,
            "n_host_syncs": self.n_host_syncs,
            "spec_plan_k": self._spec_plan_k,
            "spec_k_eff": self._spec_state.k_eff if self._spec_state is not None else 1,
            **(self._spec_state.metrics() if self._spec_state is not None else {
                "spec_rounds": 0, "spec_drafted": 0, "spec_accepted": 0,
                "spec_acceptance_rate": 0.0, "spec_rollbacks": 0}),
            **self.kv_metrics(),
            **self.expert_metrics(),
        }
