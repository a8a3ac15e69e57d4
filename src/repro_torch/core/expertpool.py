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
what the budget, the byte meters and the wire see.  Not ported: the
fleet-wide ``FleetExpertRegistry``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
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
