"""Paged expert-weight pool for the end tier, the expert analogue of the KV
``PagePool`` (port of the reference's ``core/expertpool.py``: the slab
store, the host allocator and its residency policy, and the device view of
the resident tables).

End-tier expert weights live in a fixed-capacity pool of **slabs**: one
slab is one expert's ``wi``/``wg``/``wo`` rows for one layer.  Device
storage is ``[num_slabs + 1, ...]`` per weight matrix in the params' type;
the extra last row is the all-zero **garbage slab**, never allocated, to
which tokens whose expert is not resident dispatch.  :class:`ExpertSlabPool`
is the host-side allocator: a per-layer resident table ``[n_layers, E] ->
physical slab | -1`` plus a free list, with the eq. 4 mask as the *target
set* and a route-frequency / LRU policy (:meth:`ExpertSlabPool.plan`)
deciding what to prefetch and what to evict.  The serving engine hands
``core.moe.moe_resident`` the store and the per-layer tables built by
:func:`device_resident_tables`, so expert compute and HBM traffic scale
with residents, not ``E``.

A quantized store (``quantized=True``) holds int8 codes with one f32 scale
per output column (``wi_scale``/``wg_scale [N+1, f]``, ``wo_scale [N+1,
d]``), quantized on write (``quantize_slab``, ``kernels.quant`` on the card:
the column mode of the row quantizer, so no transposed copy); its size is
what the budget, the byte meters and the wire see.

In a fleet, :class:`FleetExpertRegistry` plans residency across every
lane's slab pool: de-duplicated placement, peer-versus-cloud slab sourcing
over the modeled end<->end link, and the placement costs the fleet
frontend and the eq. 4 group admit read.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.pipeline import peer_comm_time
from repro_torch.kernels.quant import SCALE_FLOOR, quantize_rows

SLAB_SCALE_DTYPE = torch.float32  # one scale per output column
SLAB_SCALE_FLOOR = SCALE_FLOOR  # all-zero columns: a finite divide, codes 0


def expert_slab_bytes(cfg, *, quantized: bool = False) -> int:
    """Bytes one expert's ``wi``/``wg``/``wo`` rows occupy for one layer as
    stored (the unit of the pool's budget, byte meters and wire time): the
    params' type, or int8 plus one f32 scale per output column."""
    mats = 3 if cfg.ffn_gated else 2
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    if quantized:
        scales = (2 * f if cfg.ffn_gated else f) + d
        return mats * d * f + scales * SLAB_SCALE_DTYPE.itemsize
    itemsize = torch.empty((), dtype=cfg.torch_param_dtype).element_size()
    return mats * d * f * itemsize


def init_slab_store(cfg, num_slabs: int, *, quantized: bool = False,
                    device=DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """Slab storage per weight matrix, ``[num_slabs + 1, ...]``, last row
    the all-zero garbage slab: in the params' type, or int8 with ``*_scale``
    leaves of one f32 scale per output column."""
    dtype = torch.int8 if quantized else cfg.torch_param_dtype
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    shapes = {"wi": (d, f), "wo": (f, d)}
    if cfg.ffn_gated:
        shapes["wg"] = (d, f)
    store = {k: torch.zeros((num_slabs + 1, *shp), dtype=dtype, device=device)
             for k, shp in shapes.items()}
    if quantized:
        for k, shp in shapes.items():
            store[f"{k}_scale"] = torch.zeros((num_slabs + 1, shp[1]),
                                              dtype=SLAB_SCALE_DTYPE, device=device)
    return store


def quantize_slab(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., c, n] -> (q int8, scale f32 [..., n])``: symmetric int8 with
    one scale per output column (over the contraction axis ``c``)."""
    q, scale = quantize_rows(w.contiguous(), scale_dtype=SLAB_SCALE_DTYPE, axis=-2)
    return q, scale.squeeze(-2)


def write_slabs(
    store: Dict[str, torch.Tensor],
    full_moe_params: Dict[str, torch.Tensor],  # {"wi": [R, E, d, f], ...}
    assignments: Sequence[Tuple[int, int, int]],  # (slab, block, expert)
) -> Dict[str, torch.Tensor]:
    """Copy expert weights ``(block, expert)`` from the full stacked params
    into physical slab rows, one batched copy per weight matrix, in place
    (the reference returns a new store; the old one would be garbage at
    once); a quantized store quantizes on write.  Returns the store."""
    if not assignments:
        return store
    dev = store["wi"].device
    slabs, bs, es = (torch.tensor([a[i] for a in assignments], device=dev)
                     for i in range(3))
    for k in ("wi", "wg", "wo"):
        if k not in store:
            continue
        src = full_moe_params[k].to(dev)[bs, es]
        if f"{k}_scale" in store:
            q, scale = quantize_slab(src)
            store[k].index_copy_(0, slabs, q)
            store[f"{k}_scale"].index_copy_(0, slabs, scale)
        else:
            store[k].index_copy_(0, slabs, src.to(store[k].dtype))
    return store


class ExpertSlabPool:
    """Host-side slab allocator for one end tier's expert-weight pool.

    Physical slabs ``0..num_slabs-1`` index the first axis of the slab
    store; row ``num_slabs`` is the garbage slab and is never allocated.
    ``table[layer, e]`` maps each (layer, expert) to its slab (``-1`` =
    non-resident).  ``capacity`` is a soft limit (lowered when the device's
    memory budget shrinks; the engine evicts down to it at the next safe
    point); the store never reallocates.  At most ``max_per_layer`` experts
    are resident per layer: the resident-slot count of the dispatch."""

    def __init__(self, num_slabs: int, n_layers: int, num_experts: int,
                 max_per_layer: int):
        if num_slabs < 1:
            raise ValueError(f"num_slabs={num_slabs}")
        if max_per_layer < 1:
            raise ValueError(f"max_per_layer={max_per_layer}")
        self.num_slabs = num_slabs
        self.n_layers = n_layers
        self.num_experts = num_experts
        self.max_per_layer = min(max_per_layer, num_experts)
        self.capacity = num_slabs
        self.table = np.full((n_layers, num_experts), -1, np.int64)
        # LIFO free list seeded so pops hand out low indices first
        self._free: List[int] = list(range(num_slabs - 1, -1, -1))
        self.last_used = np.zeros((n_layers, num_experts), np.int64)
        self._tick = 0

    # -- accounting -----------------------------------------------------------

    @property
    def garbage_slab(self) -> int:
        return self.num_slabs

    @property
    def slabs_in_use(self) -> int:
        return self.num_slabs - len(self._free)

    def resident_mask(self, layer: int) -> np.ndarray:
        return self.table[layer] >= 0

    def resident_count(self, layer: int) -> int:
        return int((self.table[layer] >= 0).sum())

    def set_capacity(self, capacity: int):
        """Lower or raise the soft slab budget (never above the store)."""
        self.capacity = max(1, min(capacity, self.num_slabs))

    # -- slab lifecycle -------------------------------------------------------

    def can_alloc(self) -> bool:
        return bool(self._free) and self.slabs_in_use < self.capacity

    def alloc(self, layer: int, expert: int) -> int:
        if self.table[layer, expert] >= 0:
            raise ValueError(f"({layer}, {expert}) already resident")
        if self.resident_count(layer) >= self.max_per_layer:
            raise ValueError(
                f"layer {layer} already holds max_per_layer="
                f"{self.max_per_layer} residents"
            )
        if not self.can_alloc():
            raise ValueError(
                f"pool exhausted: in_use={self.slabs_in_use} capacity={self.capacity}"
            )
        slab = self._free.pop()
        self.table[layer, expert] = slab
        self.last_used[layer, expert] = self._tick
        return slab

    def evict(self, layer: int, expert: int) -> int:
        slab = int(self.table[layer, expert])
        if slab < 0:
            raise ValueError(f"({layer}, {expert}) not resident")
        self.table[layer, expert] = -1
        self._free.append(slab)
        return slab

    def free_layer(self, layer: int) -> List[int]:
        """Release every slab a layer holds (the layer left the end tier, or
        the device died); returns the freed physical slabs."""
        return [self.evict(layer, int(e)) for e in np.nonzero(self.table[layer] >= 0)[0]]

    def touch(self, layers: Sequence[int], target: np.ndarray):
        """LRU stamp: residents inside the applied routing set count as
        used this tick (non-target residents age out)."""
        self._tick += 1
        for layer in layers:
            used = (self.table[layer] >= 0) & target
            self.last_used[layer, used] = self._tick

    # -- residency policy -----------------------------------------------------

    def plan(
        self,
        active_layers: Sequence[int],
        target: np.ndarray,  # bool [E]: the eq. 4 mask (shared across layers)
        freq: Optional[np.ndarray] = None,  # [E] measured routing frequency
    ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        """Residency updates toward ``target`` on ``active_layers``:
        ``(wanted, evictions)`` as (layer, expert) lists.

        ``evictions``: residents of inactive layers, then residents the
        budget can no longer carry, least valuable first (non-target before
        target, then lowest route frequency, then least recently used); a
        layer's last target resident goes only when a capacity overflow
        leaves no other choice.  ``wanted``: target experts not yet
        resident, every active layer's most-routed expert before any
        layer's second, then by route frequency.  Non-target residents stay
        as a warm cache while the budget has room."""
        E = self.num_experts
        freq = np.zeros((E,)) if freq is None else np.asarray(freq, np.float64)
        active = set(int(x) for x in active_layers)

        evictions: List[Tuple[int, int]] = []
        for layer in range(self.n_layers):
            if layer not in active:
                for e in np.nonzero(self.table[layer] >= 0)[0]:
                    evictions.append((layer, int(e)))

        # wanted: round-robin by per-layer rank, frequency-desc within a rank
        per_layer: List[List[Tuple[int, int]]] = []
        for layer in sorted(active):
            missing = [
                int(e) for e in np.argsort(-freq, kind="stable")
                if target[e] and self.table[layer, e] < 0
            ]
            # slot room counts target residents only: non-target residents
            # are evictable to make space
            n_target_res = int((self.table[layer][target] >= 0).sum())
            room = self.max_per_layer - n_target_res
            per_layer.append([(layer, e) for e in missing[:max(room, 0)]])
        wanted: List[Tuple[int, int]] = []
        rank = 0
        while any(rank < len(lst) for lst in per_layer):
            for lst in per_layer:
                if rank < len(lst):
                    wanted.append(lst[rank])
            rank += 1

        # per-layer slot pressure: stale non-target residents make way for
        # the layer's wanted target experts (lowest frequency, LRU first)
        wanted_per_layer: Dict[int, int] = {}
        for layer, e in wanted:
            wanted_per_layer[layer] = wanted_per_layer.get(layer, 0) + 1
        for layer in sorted(active):
            over = (self.resident_count(layer)
                    + wanted_per_layer.get(layer, 0) - self.max_per_layer)
            if over <= 0:
                continue
            stale = sorted(
                (int(e) for e in np.nonzero(self.table[layer] >= 0)[0] if not target[e]),
                key=lambda e: (freq[e], self.last_used[layer, e], e),
            )
            evictions.extend((layer, e) for e in stale[:over])

        # beyond that: fit the global capacity and make room
        in_use_after = self.slabs_in_use - len(evictions)
        overflow = max(0, in_use_after - self.capacity)
        room = max(0, self.capacity - in_use_after)
        need = overflow + max(0, len(wanted) - room)
        if need > 0:
            already = set(evictions)
            n_target_res = {
                layer: int((self.table[layer][target] >= 0).sum())
                for layer in sorted(active)
            }
            cands: List[Tuple[Tuple, Tuple[int, int]]] = []
            for layer in sorted(active):
                for e in np.nonzero(self.table[layer] >= 0)[0]:
                    e = int(e)
                    if (layer, e) in already:
                        continue
                    cands.append((
                        (1 if target[e] else 0, freq[e], self.last_used[layer, e], e),
                        (layer, e),
                    ))
            cands.sort(key=lambda c: c[0])
            taken = set()
            # pass 1: non-target residents serve any need; target residents
            # go only under a capacity overflow (never to make room for
            # another layer's wanted expert: that would thrash), and never a
            # layer's last one
            for key, (layer, e) in cands:
                if need <= 0:
                    break
                if key[0] == 1:
                    if overflow <= 0 or n_target_res[layer] <= 1:
                        continue
                    n_target_res[layer] -= 1
                evictions.append((layer, e))
                taken.add((layer, e))
                need -= 1
                overflow = max(0, overflow - 1)
            # pass 2: an overflow that cannot be met otherwise may empty
            # layers (a shrinking budget beats a starving pool); growth never
            if need > 0 and overflow > 0:
                for key, (layer, e) in cands:
                    if need <= 0 or overflow <= 0:
                        break
                    if (layer, e) in taken:
                        continue
                    evictions.append((layer, e))
                    need -= 1
                    overflow -= 1
        return wanted, evictions


class FleetExpertRegistry:
    """Location-aware fleet-wide expert store: residency *planning* split
    from each lane's slab pool, which stays the storage.  The registry
    reads the fleet-wide map ``(layer, expert) -> {lane: slab}`` and adds
    three policies:

    * **De-duplication** (:meth:`plan_lane`): a lane fetches its own copy of
      an expert a peer already holds only when its measured route frequency
      clears ``dedup_min_freq`` (default ``1/E``); unmeasured lanes always
      replicate, so a cold fleet behaves like isolated pools.
    * **Source choice** (:meth:`pick_source`): each slab transfer picks a
      peer lane or the cloud by modeled wire time at transfer time; a peer
      must be strictly cheaper (without a declared fleet LAN it never is).
    * **Placement costs** (:meth:`lane_miss_cost_s`,
      :meth:`group_fetch_costs`): expected wire seconds to repair a lane's
      misses, read by ``place_fleet`` and the eq. 4 group admit.

    Pure host bookkeeping: peer wire time is booked through per-lane
    callbacks on the fleet's shared timeline (both ends of a transfer)."""

    def __init__(self, n_layers: int, num_experts: int, slab_bytes: int, *,
                 lan_gbps: Optional[float] = None, dedup_min_freq: Optional[float] = None):
        self.n_layers = n_layers
        self.num_experts = num_experts
        self.slab_bytes = slab_bytes
        self.lan_gbps = lan_gbps
        self.dedup_min_freq = 1.0 / num_experts if dedup_min_freq is None else dedup_min_freq
        self._pools: List[ExpertSlabPool] = []
        self._link_gbps: List[Callable[[], float]] = []
        self._book_link: List[Callable[[float, float], float]] = []
        self._freq: List[Optional[np.ndarray]] = []
        self._alive: List[bool] = []
        self.peer_fetches = 0
        self.peer_bytes = 0
        # (src_lane, dst_lane, wire_seconds) a peer transfer booked
        self.peer_bookings: List[Tuple[int, int, float]] = []
        # armed peer-fetch failures, and how many fell back to the cloud
        self._peer_faults = 0
        self.peer_fault_fallbacks = 0

    # -- lanes ----------------------------------------------------------------

    @property
    def n_lanes(self) -> int:
        return len(self._pools)

    def register_lane(self, pool: ExpertSlabPool, *, link_gbps: Callable[[], float],
                      book_link: Callable[[float, float], float]) -> int:
        """Attach one lane's slab pool.  ``link_gbps`` reports the lane's
        measured uplink, ``book_link(ready_s, seconds) -> end_s`` occupies
        its link resource on the fleet timeline.  Returns the lane id
        (registration order)."""
        if pool.n_layers != self.n_layers or pool.num_experts != self.num_experts:
            raise ValueError(
                f"pool geometry ({pool.n_layers}, {pool.num_experts}) != "
                f"registry ({self.n_layers}, {self.num_experts})"
            )
        self._pools.append(pool)
        self._link_gbps.append(link_gbps)
        self._book_link.append(book_link)
        self._freq.append(None)
        self._alive.append(True)
        return len(self._pools) - 1

    def set_lane_alive(self, lane: int, alive: bool):
        """A dead lane's residency is invisible to every view of the map."""
        self._alive[lane] = bool(alive)

    def lane_alive(self, lane: int) -> bool:
        return self._alive[lane]

    def _live_pools(self):
        return ((i, p) for i, p in enumerate(self._pools) if self._alive[i])

    def inject_peer_faults(self, count: int):
        """Arm ``count`` peer slab-fetch failures (the next peer fetches
        fail and fall back to the cloud after one backoff)."""
        if count < 1:
            raise ValueError(f"count={count} must be >= 1")
        self._peer_faults += count

    def take_peer_fault(self) -> bool:
        """Consume one armed peer-fetch failure: True means this fetch fails
        and the caller re-sources from the cloud."""
        if self._peer_faults > 0:
            self._peer_faults -= 1
            self.peer_fault_fallbacks += 1
            return True
        return False

    def note_freq(self, lane: int, freq: Optional[np.ndarray]):
        """Record a lane's measured route-frequency EMA."""
        if freq is not None:
            self._freq[lane] = np.asarray(freq, np.float64).copy()

    # -- the fleet-wide map ---------------------------------------------------

    def holders(self, lid: int, e: int, *, exclude: Optional[int] = None) -> List[int]:
        """Live lanes whose pool holds ``(layer, expert)``."""
        return [i for i, p in self._live_pools() if i != exclude and p.table[lid, e] >= 0]

    def fleet_map(self) -> Dict[Tuple[int, int], Dict]:
        """Every fleet-resident ``(layer, expert)``: its holders' slabs, the
        largest measured frequency among them and the freshest LRU stamp."""
        out: Dict[Tuple[int, int], Dict] = {}
        for i, p in self._live_pools():
            for lid, e in zip(*np.nonzero(p.table >= 0)):
                lid, e = int(lid), int(e)
                ent = out.setdefault((lid, e), {"holders": {}, "freq": 0.0, "last_use": 0})
                ent["holders"][i] = int(p.table[lid, e])
                if self._freq[i] is not None:
                    ent["freq"] = max(ent["freq"], float(self._freq[i][e]))
                ent["last_use"] = max(ent["last_use"], int(p.last_used[lid, e]))
        return out

    def unique_residents(self) -> int:
        """Distinct fleet-resident ``(layer, expert)`` pairs."""
        if not self._pools:
            return 0
        held = np.zeros((self.n_layers, self.num_experts), bool)
        for _, p in self._live_pools():
            held |= p.table >= 0
        return int(held.sum())

    def total_residents(self) -> int:
        return sum(p.slabs_in_use for _, p in self._live_pools())

    def dedup_ratio(self) -> float:
        """Resident slabs over unique resident pairs: 1.0 fully de-duplicated,
        ``n_lanes`` every resident everywhere."""
        return self.total_residents() / max(self.unique_residents(), 1)

    # -- link cost model ------------------------------------------------------

    def cloud_fetch_s(self, lane: int) -> float:
        """Modeled wire time of one slab over the lane's cloud uplink."""
        gbps = self._link_gbps[lane]()
        return self.slab_bytes * 8.0 / max(gbps * 1e9, 1e-9)

    def peer_fetch_s(self, lane: int, src: int) -> float:
        """Modeled wire time of one slab over the end<->end link."""
        return peer_comm_time(self.slab_bytes, self._link_gbps[src](), self._link_gbps[lane](),
                              lan_gbps=self.lan_gbps)

    def pick_source(self, lane: int, lid: int, e: int) -> Tuple[Optional[int], float]:
        """Cheapest source of a slab fetch onto ``lane``: ``(peer lane, or
        None for the cloud; wire seconds)``.  Ties keep the cloud."""
        best_src: Optional[int] = None
        best_t = self.cloud_fetch_s(lane)
        for j in self.holders(lid, e, exclude=lane):
            t = self.peer_fetch_s(lane, j)
            if t < best_t:
                best_src, best_t = j, t
        return best_src, best_t

    def book_peer(self, src: int, dst: int, ready_s: float, seconds: float) -> float:
        """Occupy the *source* lane's link for a peer transfer (the
        destination books its own link)."""
        done = self._book_link[src](ready_s, seconds)
        self.peer_fetches += 1
        self.peer_bytes += self.slab_bytes
        self.peer_bookings.append((src, dst, seconds))
        return done

    # -- residency planning ---------------------------------------------------

    def _replicate_justified(self, lane: int, lid: int, e: int,
                             freq: Optional[np.ndarray]) -> bool:
        if not self.holders(lid, e, exclude=lane):
            return True  # the fleet's only copy: always place it
        if freq is None:
            return True  # unmeasured lane: no evidence to de-duplicate on
        return float(freq[e]) >= self.dedup_min_freq

    def plan_lane(self, lane: int, active_layers: Sequence[int], target: np.ndarray,
                  freq: Optional[np.ndarray] = None
                  ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        """The lane pool's :meth:`ExpertSlabPool.plan` with the
        de-duplication rule applied to its want list; the evictions are the
        pool's own (de-duplication never forces one)."""
        self.note_freq(lane, freq)
        wanted, evictions = self._pools[lane].plan(active_layers, target, freq)
        wanted = [(lid, e) for lid, e in wanted
                  if self._replicate_justified(lane, lid, e, freq)]
        return wanted, evictions

    # -- placement cost feeds -------------------------------------------------

    def _f_eff(self, lane: int) -> np.ndarray:
        """Measured frequency EMA plus the uniform ``1/E`` prior."""
        E = self.num_experts
        f = self._freq[lane]
        return (np.zeros((E,)) if f is None else f) + 1.0 / E

    def expert_fetch_costs(self, lane: int, active_layers: Sequence[int]) -> np.ndarray:
        """Per expert, the modeled wire seconds to make it resident on the
        lane's active end layers (0 where it is), averaged over layers."""
        E = self.num_experts
        cost = np.zeros((E,))
        active = list(active_layers)
        if not active:
            return cost
        pool = self._pools[lane]
        for e in range(E):
            c = 0.0
            for lid in active:
                if pool.table[lid, e] < 0:
                    c += self.pick_source(lane, lid, e)[1]
            cost[e] = c / len(active)
        return cost

    def group_fetch_costs(self, lane: int, active_layers: Sequence[int],
                          num_groups: int) -> np.ndarray:
        """Expert fetch costs folded to HL-GGN groups (mean a group)."""
        return self.expert_fetch_costs(lane, active_layers).reshape(num_groups, -1).mean(-1)

    def lane_miss_cost_s(self, lane: int, active_layers: Sequence[int],
                         target: np.ndarray) -> float:
        """Expected extra wire seconds a routed token on this lane: each
        active layer's non-resident target experts, weighted by measured
        routing frequency, times their cheapest fetch time."""
        f = self._f_eff(lane)
        target = np.asarray(target, bool)
        pool = self._pools[lane]
        cost = 0.0
        for lid in active_layers:
            for e in np.nonzero(target & (pool.table[lid] < 0))[0]:
                e = int(e)
                cost += float(f[e]) * self.pick_source(lane, lid, e)[1]
        return cost

    # -- cloud-side view ------------------------------------------------------

    def cloud_expert_load(self) -> np.ndarray:
        """Per expert, the share of fleet traffic that drains to the cloud
        tier: each lane's effective frequency where it holds no layer's copy
        (the weight ``distributed.sharding.fleet_expert_shards`` balances)."""
        load = np.zeros((self.num_experts,))
        for i, p in self._live_pools():
            any_resident = (p.table >= 0).any(axis=0)
            load += self._f_eff(i) * (~any_resident)
        return load


def device_resident_tables(
    pool: ExpertSlabPool,
    layer_ids: Sequence[int],  # pool layer id per end-tier block, in order
    s_cap: int,
    device=DEFAULT_DEVICE,
) -> Dict[str, torch.Tensor]:
    """Device view of the resident tables of one MoE pattern position:

    * ``ids [n_blocks, s_cap + 1]`` int32: the slab row of each resident
      slot (ascending expert id; unused slots and the last, sentinel slot
      name the garbage slab);
    * ``slot [n_blocks, E]`` int32: expert id -> resident slot, with
      non-resident experts on the garbage slot ``s_cap`` (from which the
      effective routing mask ``slot < s_cap`` follows).

    Built on the host and moved to ``device`` in one copy each."""
    n = len(layer_ids)
    ids = np.full((n, s_cap + 1), pool.garbage_slab, np.int32)
    slot = np.full((n, pool.num_experts), s_cap, np.int32)
    for b, lid in enumerate(layer_ids):
        res = np.nonzero(pool.table[lid] >= 0)[0]
        for s_i, e in enumerate(res[:s_cap]):
            ids[b, s_i] = pool.table[lid, e]
            slot[b, e] = s_i
    return {
        "ids": torch.from_numpy(ids).to(device),
        "slot": torch.from_numpy(slot).to(device),
    }
