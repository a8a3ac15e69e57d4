"""KV caches: the paged pools (the host page allocator, the device-side
paged writes, the page moves of a tier re-split, speculative rollback and
preemption spill) and the dense caches of ``Model.prefill`` /
``decode_step`` (speculative decode's draft rings; the SSM states and conv
tails of the dense-ring ``ServingEngine``; an encoder-decoder's cross
caches), port of the reference's
``models/kvcache.py``.

A tier owns one shared :class:`PagePool` of ``num_pages`` fixed-size pages;
storage leaves are ``[R, P+1, page_size, KV, hd]`` (the last row is the
*garbage page* that absorbs writes routed away from unmapped or inactive
slots), and each slot has a page table ``[pages_per_slot]``.  Position
``p`` lives at table entry ``(p // page_size) % pages_per_slot``, offset
``p % page_size``, so a slot's pages are a ring buffer of capacity
``pages_per_slot * page_size`` and :func:`ring_key_positions` applies.

Quantized pools (``init_paged_blocks(..., quantized=True)``) store int8
codes in the ``k``/``v`` leaves and one f16 scale per written token in
``k_scale``/``v_scale`` leaves ``[R, P+1, page_size]``, written by the
``*_quant`` writers (on the card one launch a layer write of
``kernels.quant.paged_write_quant``, held to :func:`paged_write_quant_plain`
here); every page move walks
all leaves, so the scales travel with their pages.

The writes update the pools in place (the reference's ``.at[].set`` returns
a new array; here the old one would be garbage at once, so the port saves
the copy) and also return them, to keep the reference's call shapes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.kernels.quant import (
    SCALE_FLOOR,
    paged_write_quant,
    quantize_rows,
    quantize_rows_plain,
)
from repro_torch.models.ssm import resident_heads, ssm_dims

KV_SCALE_DTYPE = torch.float16  # per-token scale: an int8 page stays <= 0.55x of bf16
KV_SCALE_FLOOR = SCALE_FLOOR  # all-zero tokens: a finite divide, codes 0


def attn_cache_len(cfg, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
               device=DEFAULT_DEVICE, topo=None) -> Dict:
    """An empty dense decode cache (zeros), each leaf stacked over the block
    repeats: per attention position ``k``/``v`` rings ``[R, batch, W, KV,
    hd]``, and with cross-attention the cross caches ``xk``/``xv`` ``[R,
    batch, encoder_seq_len, KV, hd]``; per SSM position the conv tails
    ``conv_x [R, batch, d_conv-1, d_in]`` and ``conv_bc [R, batch,
    d_conv-1, 2*G*N]`` in ``dtype`` and the state ``ssm [R, batch, H, P,
    N]`` in f32; and ``lengths`` [batch].  Where a rank of ``topo`` holds
    only its heads of the SSM weights (``ssm.resident_heads``) its state and
    ``conv_x`` hold only those heads' too."""
    R, KV, hd = cfg.block_repeat, cfg.num_kv_heads, cfg.head_dim
    blocks: Dict[str, Dict] = {}
    for i, spec in enumerate(cfg.layer_pattern):
        if spec.kind == "attn":
            ring = (R, batch, attn_cache_len(cfg, max_len), KV, hd)
            shapes = {"k": ring, "v": ring}
            if spec.cross_attn:
                cross = (R, batch, cfg.encoder_seq_len, KV, hd)
                shapes.update(xk=cross, xv=cross)
            blocks[f"pos{i}"] = {n: torch.zeros(shape, dtype=dtype, device=device)
                                 for n, shape in shapes.items()}
            continue
        s = cfg.ssm
        d_in, H, _ = ssm_dims(cfg)
        if resident_heads(cfg, topo):
            d_in, H = d_in // topo.ep_size, H // topo.ep_size
        gn = s.n_groups * s.d_state
        blocks[f"pos{i}"] = {
            "conv_x": torch.zeros((R, batch, s.d_conv - 1, d_in), dtype=dtype, device=device),
            "conv_bc": torch.zeros((R, batch, s.d_conv - 1, 2 * gn), dtype=dtype,
                                   device=device),
            "ssm": torch.zeros((R, batch, H, s.head_dim, s.d_state), dtype=torch.float32,
                               device=device),
        }
    return {"blocks": blocks,
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _map_blocks(fn, *trees: Dict) -> Dict:
    """``fn`` over the matching leaves of nested dicts of tensors."""
    return {k: _map_blocks(fn, *(t[k] for t in trees)) if isinstance(v, dict)
            else fn(*(t[k] for t in trees)) for k, v in trees[0].items()}


def split_cache(cache: Dict, split: int) -> Tuple[Dict, Dict]:
    """Split a stacked dense cache by block range: blocks ``[0, split)`` for
    the end tier, ``[split, R)`` for the cloud tier (views); both keep the
    ``lengths`` vector."""
    end = {"blocks": _map_blocks(lambda leaf: leaf[:split], cache["blocks"]),
           "lengths": cache["lengths"]}
    cloud = {"blocks": _map_blocks(lambda leaf: leaf[split:], cache["blocks"]),
             "lengths": cache["lengths"]}
    return end, cloud


def merge_cache(end_cache: Dict, cloud_cache: Dict) -> Dict:
    """Inverse of :func:`split_cache`: the tiers' block caches re-stacked
    along the block axis, with the end tier's ``lengths``."""
    blocks = _map_blocks(lambda a, b: torch.cat([a, b], dim=0), end_cache["blocks"],
                         cloud_cache["blocks"])
    return {"blocks": blocks, "lengths": end_cache["lengths"]}


def install_slot(batch_cache: Dict, slot: int, one_cache: Dict) -> Dict:
    """Copy a single-request cache (batch dim 1) into slot ``slot`` of a
    batched dense cache, in place.  Block leaves are ``[R, B, W, ...]``;
    axis 2 (a ring, or an SSM conv tail) is truncated to the destination's
    width, or filled with zeros at its end when the source is shorter (a
    prompt of fewer than ``d_conv - 1`` tokens), as the reference pads."""

    def copy_leaf(dst: torch.Tensor, src: torch.Tensor):
        n = min(dst.shape[2], src.shape[2])
        row = dst[:, slot]
        row[:, :n] = src[:, 0, :n]
        row[:, n:] = 0

    _map_blocks(copy_leaf, batch_cache["blocks"], one_cache["blocks"])
    batch_cache["lengths"][slot] = one_cache["lengths"][0]
    return batch_cache


def ring_write(kcache: torch.Tensor, vcache: torch.Tensor, k, v, lengths: torch.Tensor):
    """Write one new token's k/v ([B, 1, KV, hd]) at ring slot ``lengths %
    W`` of dense rings [B, W, KV, hd], in place."""
    b = torch.arange(kcache.shape[0], device=kcache.device)
    slot = torch.remainder(lengths.long(), kcache.shape[1])
    kcache[b, slot] = k[:, 0].to(kcache.dtype)
    vcache[b, slot] = v[:, 0].to(vcache.dtype)
    return kcache, vcache


def prefill_write(kcache: torch.Tensor, vcache: torch.Tensor, k, v):
    """Write a prefix [B, S, KV, hd] into fresh rings [B, W, KV, hd] in
    place: position p at slot ``p % W``, only the last W kept when S > W."""
    S, W = k.shape[1], kcache.shape[1]
    if S >= W:
        slot = torch.remainder(torch.arange(S - W, S, device=k.device), W)
        kcache[:, slot] = k[:, S - W:].to(kcache.dtype)
        vcache[:, slot] = v[:, S - W:].to(vcache.dtype)
    else:
        kcache[:, :S] = k.to(kcache.dtype)
        vcache[:, :S] = v.to(vcache.dtype)
    return kcache, vcache


def ring_key_positions(lengths: torch.Tensor, W: int) -> torch.Tensor:
    """Position held by each ring slot after the token at ``lengths`` has
    been written.  lengths [B] -> [B, W]."""
    s = torch.arange(W, device=lengths.device)[None, :]
    ln = lengths.long()[:, None]
    return ln - torch.remainder(ln - s, W)


def pattern_is_pageable(cfg) -> bool:
    """Paged caches cover self-attention KV only: every layer must be a
    non-cross attention layer."""
    return all(
        spec.kind == "attn" and not spec.cross_attn for spec in cfg.layer_pattern
    )


def page_geometry(cfg, max_len: int, page_size: int,
                  chunk_headroom: int = 0) -> Tuple[int, int]:
    """(pages_per_slot, ring_capacity_tokens).  With a sliding window that
    can wrap, the ring keeps ``chunk_headroom - 1`` extra tokens so a
    prefill chunk's own writes never evict keys still inside an earlier
    query's window."""
    W = attn_cache_len(cfg, max_len)
    if W < max_len and chunk_headroom > 1:
        W += chunk_headroom - 1
    pps = -(-W // page_size)
    return pps, pps * page_size


def pages_needed(n_tokens: int, page_size: int, pages_per_slot: int) -> int:
    """Distinct table entries positions ``[0, n_tokens)`` touch."""
    return min(pages_per_slot, -(-n_tokens // page_size))


class PagePool:
    """Host-side page allocator for one tier's shared KV page pool.

    Admission *reserves* a slot's worst-case page count up front (decode
    can never run out of pages mid-stream), then maps pages lazily as
    prefill chunks and decode steps first touch each ring entry; ``free``
    returns a finished slot's pages.  Tables hold ``-1`` for unmapped
    entries.  One pool can serve several fleet lanes' cloud tiers: each lane
    registers its slot block with :meth:`add_slots`."""

    def __init__(self, num_pages: int, page_size: int, pages_per_slot: int,
                 n_slots: int = 0):
        if num_pages < 1:
            raise ValueError(f"num_pages={num_pages}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.pages_per_slot = pages_per_slot
        self.table = np.full((n_slots, pages_per_slot), -1, np.int32)
        # LIFO free list, seeded so pops hand out low indices first
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._reserved = np.zeros((n_slots,), np.int64)
        self._mapped = np.zeros((n_slots,), np.int64)
        self.peak_in_use = 0

    @property
    def garbage_page(self) -> int:
        return self.num_pages

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def pages_reserved(self) -> int:
        """Pages promised to admitted slots but not yet mapped."""
        return int(self._reserved.sum() - self._mapped.sum())

    @property
    def pages_available(self) -> int:
        return len(self._free) - self.pages_reserved

    @property
    def utilization(self) -> float:
        return self.pages_in_use / self.num_pages

    def mapped_for(self, slots) -> int:
        """Pages mapped by a subset of slots (a lane's share of a shared
        pool)."""
        return int(self._mapped[np.asarray(slots)].sum())

    def add_slots(self, n: int) -> int:
        """Register ``n`` more slots (fleet lanes sharing one cloud pool, so
        page accounting and admission are fleet-wide); returns the first
        new slot's id."""
        base = self.table.shape[0]
        self.table = np.concatenate([self.table, np.full((n, self.pages_per_slot), -1, np.int32)])
        self._reserved = np.concatenate([self._reserved, np.zeros(n, np.int64)])
        self._mapped = np.concatenate([self._mapped, np.zeros(n, np.int64)])
        return base

    def can_reserve(self, n_pages: int) -> bool:
        return self.pages_available >= n_pages

    def reserve(self, slot: int, n_pages: int):
        if self._reserved[slot]:
            raise ValueError(f"slot {slot} already holds a reservation")
        if n_pages > self.pages_per_slot:
            raise ValueError(
                f"reservation {n_pages} exceeds pages_per_slot={self.pages_per_slot}"
            )
        if not self.can_reserve(n_pages):
            raise ValueError(
                f"pool exhausted: want {n_pages}, available {self.pages_available}"
            )
        self._reserved[slot] = n_pages

    def _map_entry(self, slot: int, entry: int):
        if self.table[slot, entry] >= 0:
            return  # ring reuse: the entry keeps its page across wraps
        if self._mapped[slot] >= self._reserved[slot]:
            raise ValueError(
                f"slot {slot}: mapping beyond its reservation "
                f"({self._reserved[slot]} pages)"
            )
        self.table[slot, entry] = self._free.pop()
        self._mapped[slot] += 1
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)

    def map_range(self, slot: int, start_pos: int, end_pos: int):
        """Map every ring entry positions ``[start_pos, end_pos)`` touch."""
        if end_pos <= start_pos:
            return
        for pi in range(start_pos // self.page_size,
                        (end_pos - 1) // self.page_size + 1):
            self._map_entry(slot, pi % self.pages_per_slot)

    def append(self, slot: int, pos: int):
        """Ensure the entry for position ``pos`` is mapped (decode write)."""
        self._map_entry(slot, (pos // self.page_size) % self.pages_per_slot)

    def reserved_pages(self, slot: int) -> int:
        """Pages this slot's reservation holds (0 = no reservation)."""
        return int(self._reserved[slot])

    # -- speculative decode: provisional maps and their rollback -------------

    def map_tokens(self, slot: int, start_pos: int, end_pos: int) -> List[int]:
        """:meth:`map_range`, returning the entries this call newly mapped
        (a draft chunk's provisional pages); entries mapped before (ring
        reuse) are not returned, so a rollback never touches them."""
        new_entries: List[int] = []
        if end_pos > start_pos:
            for pi in range(start_pos // self.page_size,
                            (end_pos - 1) // self.page_size + 1):
                entry = pi % self.pages_per_slot
                if self.table[slot, entry] < 0:
                    self._map_entry(slot, entry)
                    new_entries.append(entry)
        return new_entries

    def rollback(self, slot: int, entries) -> None:
        """Unmap provisionally mapped ``entries`` (from :meth:`map_tokens`),
        their pages back on the free list.  Table surgery only: rejected
        drafts' KV stays in pages no table maps, and is never read."""
        for e in entries:
            e = int(e)
            if self.table[slot, e] < 0:
                raise ValueError(f"slot {slot}: rollback of unmapped entry {e}")
            self._free.append(int(self.table[slot, e]))
            self.table[slot, e] = -1
            self._mapped[slot] -= 1

    # -- preemption: spill and restore ---------------------------------------

    def spill_slot(self, slot: int) -> Tuple[np.ndarray, np.ndarray, int]:
        """Evict a live slot: returns ``(entries, phys, n_reserved)``, its
        mapped table entries, the physical row of each, and its reservation,
        and frees the slot.  The caller copies the rows at ``phys`` before
        anything maps (and writes) those pages again."""
        entries = np.nonzero(self.table[slot] >= 0)[0].astype(np.int64)
        phys = self.table[slot, entries].astype(np.int64).copy()
        n_reserved = int(self._reserved[slot])
        self.free(slot)
        return entries, phys, n_reserved

    def restore_slot(self, slot: int, entries: np.ndarray, n_pages: int) -> np.ndarray:
        """Re-admit a spilled slot: reserve ``n_pages`` (its original
        reservation) and map exactly ``entries``; returns their new physical
        rows, where the caller scatters the saved page data.  Entries, not
        rows, are what attention reads, so the restored cache is the
        spilled one."""
        self.reserve(slot, n_pages)
        for e in entries:
            self._map_entry(slot, int(e))
        return self.table[slot, np.asarray(entries, np.int64)].astype(np.int64).copy()

    def free(self, slot: int):
        if not self._reserved[slot]:
            raise ValueError(f"double free of slot {slot}")
        for e in range(self.pages_per_slot):
            if self.table[slot, e] >= 0:
                self._free.append(int(self.table[slot, e]))
                self.table[slot, e] = -1
        self._reserved[slot] = 0
        self._mapped[slot] = 0

    def device_rows(self, slots, active=None, device=DEFAULT_DEVICE) -> torch.Tensor:
        """Device page table for ``slots``: unmapped entries, and every entry
        of a slot not ``active``, routed to the garbage page, so reads stay
        in bounds and writes for inactive slots never touch a live page."""
        rows = self.table[np.asarray(slots)]
        rows = np.where(rows < 0, self.garbage_page, rows)
        if active is not None:
            rows = np.where(np.asarray(active)[:, None], rows, self.garbage_page)
        return torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(device)

    def defrag(self) -> np.ndarray:
        """Compact mapped pages to the lowest physical indices.  Returns the
        storage-row permutation ``perm`` (length ``num_pages + 1``, garbage
        row fixed) such that the device update is ``leaf[:, perm]``; tables
        and the free list are updated in place."""
        perm = np.empty((self.num_pages + 1,), np.int64)
        nxt = 0
        for s in range(self.table.shape[0]):
            for e in range(self.pages_per_slot):
                old = self.table[s, e]
                if old >= 0:
                    perm[nxt] = old
                    self.table[s, e] = nxt
                    nxt += 1
        perm[nxt : self.num_pages] = sorted(
            set(range(self.num_pages)) - set(perm[:nxt].tolist())
        )
        perm[self.num_pages] = self.num_pages  # garbage stays put
        self._free = list(range(self.num_pages - 1, nxt - 1, -1))
        return perm


def init_paged_blocks(cfg, n_blocks: int, num_pages: int, page_size: int,
                      dtype: torch.dtype, device=DEFAULT_DEVICE, *,
                      quantized: bool = False) -> Dict:
    """Paged KV storage for ``n_blocks`` stacked block repeats of an
    attention-only pattern: per position, ``k``/``v`` leaves shaped
    ``[n_blocks, num_pages + 1, page_size, KV, hd]`` (last row = garbage).
    With ``quantized=True`` they hold int8 codes, and ``k_scale``/``v_scale``
    leaves ``[n_blocks, num_pages + 1, page_size]`` (f16) one scale per
    token, shared across kv heads and head dim."""
    if not pattern_is_pageable(cfg):
        raise ValueError(f"{cfg.name}: paged storage needs an attention-only pattern")
    shape = (n_blocks, num_pages + 1, page_size, cfg.num_kv_heads, cfg.head_dim)
    dtype = torch.int8 if quantized else dtype
    blocks = {}
    for i in range(len(cfg.layer_pattern)):
        entry = {n: torch.zeros(shape, dtype=dtype, device=device) for n in ("k", "v")}
        if quantized:
            for n in ("k_scale", "v_scale"):
                entry[n] = torch.zeros(shape[:3], dtype=KV_SCALE_DTYPE, device=device)
        blocks[f"pos{i}"] = entry
    return blocks


def paged_block_bytes(blocks: Dict) -> int:
    """Bytes one physical page occupies across all of a tier's leaves."""
    total = 0
    for entry in blocks.values():
        for leaf in entry.values():
            if leaf.dim() >= 2 and leaf.shape[0] > 0:
                total += leaf[:, 0].numel() * leaf.element_size()
    return total


class SharedPagedBlocks:
    """One paged storage of block repeats ``[base, R)`` over the page space
    of a pool that several engines share (a fleet's cloud ``PagePool``,
    indexed by fleet-global page ids).  Each engine reads and writes the
    blocks from its own split on through :meth:`view`, in place, at the
    pages the pool maps to its slots, so the storage grows with the pool
    and not with the number of engines.  A split below ``base`` extends it
    downward (:meth:`reserve`); blocks above every engine's split stay."""

    def __init__(self, cfg, num_pages: int, page_size: int, dtype: torch.dtype,
                 device=DEFAULT_DEVICE, *, quantized: bool = False):
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.dtype = dtype
        self.device = device
        self.quantized = quantized
        self.base = cfg.block_repeat
        self.blocks = init_paged_blocks(cfg, 0, num_pages, page_size, dtype, device,
                                        quantized=quantized)

    def reserve(self, split: int):
        """Make blocks ``[split, R)`` present (new blocks start zeroed)."""
        if split >= self.base:
            return
        new = init_paged_blocks(self.cfg, self.base - split, self.num_pages, self.page_size,
                                self.dtype, self.device, quantized=self.quantized)
        self.blocks = {pos: {n: torch.cat([new[pos][n], leaf]) for n, leaf in entry.items()}
                       for pos, entry in self.blocks.items()}
        self.base = split

    def view(self, split: int) -> Dict:
        """Blocks ``[split, R)`` as views of the storage (no copy)."""
        lo = split - self.base
        if lo < 0:
            raise ValueError(f"split {split} below the stored blocks (base {self.base})")
        return {pos: {n: leaf[lo:] for n, leaf in entry.items()}
                for pos, entry in self.blocks.items()}

    def permute(self, perm: torch.Tensor):
        """Re-index every page row (a pool defrag's ``perm``), once for all
        the engines that share the storage."""
        self.blocks = {pos: {n: leaf[:, perm] for n, leaf in entry.items()}
                       for pos, entry in self.blocks.items()}


def dense_page_bytes(cfg, n_blocks: int, page_size: int) -> int:
    """Bytes one physical page would occupy at the activation type across
    every pattern position of ``n_blocks`` blocks: the dense counterpart of
    :func:`paged_block_bytes`."""
    itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
    return (2 * len(cfg.layer_pattern) * n_blocks * page_size
            * cfg.num_kv_heads * cfg.head_dim * itemsize)


def quantize_kv_tokens(x: torch.Tensor, quantize=quantize_rows
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., KV, hd] -> (q int8 same shape, scale f16 [...])``: one scale
    per token over its contiguous ``KV * hd`` values, rounded to f16 before
    the divide (``kernels.quant.quantize_rows``, or ``quantize`` in its
    place)."""
    lead = x.shape[:-2]
    q, scale = quantize(x.reshape(*lead, -1).contiguous(), scale_dtype=KV_SCALE_DTYPE)
    return q.view(x.shape), scale.view(lead)


def dequantize_kv_pool(pool: torch.Tensor, scale: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``pool [..., ps, KV, hd] int8 + scale [..., ps] -> dense pool``: a
    test oracle (the attention consumers dequantize page by page)."""
    return (pool.float() * scale.float()[..., None, None]).to(dtype)


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool [P+1, ps, KV, hd], table [B, pps] -> dense ring view
    [B, pps*ps, KV, hd].  Test oracle only: the serving path attends straight
    off the pool."""
    B, pps = table.shape
    buf = pool[table.long()]
    return buf.reshape(B, pps * pool.shape[1], *pool.shape[2:])


def _token_slots(table: torch.Tensor, positions: torch.Tensor, page_size: int):
    """(physical page, offset) of each position, ``[B]`` or ``[B, C]``,
    through the page table."""
    pos = positions.long()
    entry = torch.remainder(pos // page_size, table.shape[1])
    if pos.dim() == 1:
        return table.long().gather(1, entry[:, None])[:, 0], torch.remainder(pos, page_size)
    return table.long().gather(1, entry), torch.remainder(pos, page_size)


def _chunk_slots(pool: torch.Tensor, table, positions, valid, page_size: int):
    """:func:`_token_slots` of a chunk, rows not ``valid`` (prompt padding)
    routed to the garbage page (the pool's last row)."""
    phys, off = _token_slots(table, positions, page_size)
    return torch.where(valid, phys, pool.shape[0] - 1), off


def paged_ring_write(pool_k: torch.Tensor, pool_v: torch.Tensor, k, v,
                     table: torch.Tensor, lengths: torch.Tensor, page_size: int):
    """Write one new token's k/v ([B, 1, KV, hd]) at ring position
    ``lengths`` through the page table, in place."""
    phys, off = _token_slots(table, lengths, page_size)
    pool_k[phys, off] = k[:, 0].to(pool_k.dtype)
    pool_v[phys, off] = v[:, 0].to(pool_v.dtype)
    return pool_k, pool_v


def paged_write_quant_plain(pool_k, pool_v, pool_ks, pool_vs, k, v, table, positions,
                            page_size: int, valid=None):
    """The int8 pools' layer write in plain PyTorch, on any device (the card
    kernel ``kernels.quant.paged_write_quant`` is held to it): k/v ``[B, C,
    KV, hd]`` as int8 codes and one f16 scale a token, written in place at
    ``positions`` (``[B]`` with C = 1, or ``[B, C]``) through the page
    table; rows not ``valid`` go to the garbage page."""
    phys, off = (_token_slots(table, positions, page_size) if valid is None
                 else _chunk_slots(pool_k, table, positions, valid, page_size))
    if positions.dim() == 1:
        k, v = k[:, 0], v[:, 0]
    (qk, sk), (qv, sv) = (quantize_kv_tokens(t, quantize_rows_plain) for t in (k, v))
    pool_k[phys, off], pool_v[phys, off] = qk, qv
    pool_ks[phys, off], pool_vs[phys, off] = sk, sv
    return pool_k, pool_v, pool_ks, pool_vs


def paged_ring_write_quant(pool_k, pool_v, pool_ks, pool_vs, k, v,
                           table: torch.Tensor, lengths: torch.Tensor, page_size: int):
    """Quantize-on-write :func:`paged_ring_write`: the token's k/v as int8
    codes and their f16 scales, written through the page table in place
    (the plain version for CPU tensors, one kernel launch otherwise)."""
    write = paged_write_quant_plain if k.device.type == "cpu" else paged_write_quant
    return write(pool_k, pool_v, pool_ks, pool_vs, k, v, table, lengths, page_size)


def paged_write_tokens(pool_k: torch.Tensor, pool_v: torch.Tensor, k, v,
                       table: torch.Tensor, positions: torch.Tensor,
                       valid: torch.Tensor, page_size: int):
    """Write a chunk of tokens ([B, C, KV, hd]) at ``positions`` [B, C]
    through the page table, in place; rows where ``valid`` is False (prompt
    padding) go to the garbage page."""
    phys, off = _chunk_slots(pool_k, table, positions, valid, page_size)
    pool_k[phys, off] = k.to(pool_k.dtype)
    pool_v[phys, off] = v.to(pool_v.dtype)
    return pool_k, pool_v


def paged_write_tokens_quant(pool_k, pool_v, pool_ks, pool_vs, k, v,
                             table: torch.Tensor, positions: torch.Tensor,
                             valid: torch.Tensor, page_size: int):
    """Quantize-on-write :func:`paged_write_tokens` (chunked prefill):
    int8 codes and f16 scales, padding rows to the garbage page (the plain
    version for CPU tensors, one kernel launch otherwise)."""
    write = paged_write_quant_plain if k.device.type == "cpu" else paged_write_quant
    return write(pool_k, pool_v, pool_ks, pool_vs, k, v, table, positions, page_size, valid)


# -- tier re-splits over pages ----------------------------------------------


def page_perm(src_tables: np.ndarray, dst_tables: np.ndarray,
              src_pages: int, dst_pages: int) -> np.ndarray:
    """Physical-row permutation carrying one engine's pages from a source
    pool's index space to a destination pool's (a replan moving blocks
    between tiers: the two pools map the same (slot, entry) set, since
    allocation is lockstep, but may use different physical rows).  Returns
    ``perm`` with ``len == dst_pages + 1`` such that ``src_leaf[:, perm]``
    places every mapped page at its destination row; unmapped destination
    rows read dead data."""
    perm = np.zeros((dst_pages + 1,), np.int64)
    perm[dst_pages] = src_pages  # garbage -> garbage
    for src_row, dst_row in zip(np.asarray(src_tables), np.asarray(dst_tables)):
        if not np.array_equal(src_row >= 0, dst_row >= 0):
            raise ValueError(
                f"tier pools out of lockstep ({src_row.tolist()} vs {dst_row.tolist()})"
            )
        for e in range(len(src_row)):
            if dst_row[e] >= 0:
                perm[dst_row[e]] = src_row[e]
    return perm


def resplit_paged_blocks(end_blocks: Dict, cloud_blocks: Dict, old_split: int,
                         new_split: int, end_to_cloud: np.ndarray,
                         cloud_to_end: np.ndarray) -> Tuple[Dict, Dict]:
    """Move block repeats between the tiers' paged storages at a replan
    safe point: the moved leaves' page rows are permuted from the source
    pool's index space into the destination pool's, on the device."""
    if new_split == old_split:
        return end_blocks, cloud_blocks
    end_new: Dict = {}
    cloud_new: Dict = {}
    for pos, e_entry in end_blocks.items():
        end_new[pos], cloud_new[pos] = {}, {}
        for name, e_leaf in e_entry.items():
            c_leaf = cloud_blocks[pos][name]
            if new_split < old_split:  # end -> cloud
                perm = torch.from_numpy(end_to_cloud).to(e_leaf.device)
                moved = e_leaf[new_split:][:, perm]
                end_new[pos][name] = e_leaf[:new_split]
                cloud_new[pos][name] = torch.cat([moved, c_leaf], dim=0)
            else:  # cloud -> end
                n = new_split - old_split
                perm = torch.from_numpy(cloud_to_end).to(c_leaf.device)
                moved = c_leaf[:n][:, perm]
                end_new[pos][name] = torch.cat([e_leaf, moved], dim=0)
                cloud_new[pos][name] = c_leaf[n:]
    return end_new, cloud_new
