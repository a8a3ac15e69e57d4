"""Batched serving engine with continuous batching (port of the
reference's ``ServingEngine``).

For attention-only patterns the engine is *paged*: a fixed decode batch of
``max_batch`` slots shares one :class:`~repro_torch.models.kvcache.PagePool`
of fixed-size KV pages; each slot owns a bounded page list (ring semantics
at page granularity), admission is gated on page availability (worst case
reserved up front, mapped lazily), and prompts are prefilled in fixed-size
chunks.  Patterns with SSM layers take the reference's dense branch: one
``kvcache.init_cache`` of ``max_batch`` slots, a whole-prompt
``Model.prefill`` per request copied into its slot (``install_slot``), and
a dense ``decode_step`` over every slot, inactive ones too (their recurrent
prefill state cannot stream through fixed-shape chunks).  Cross-attention
(encoder-decoder) patterns are refused, as the reference has no engine path
for them: its dense branch hands ``Model.prefill`` only the prompt's tokens,
never an encoder input (``frame_embeds``); such a model runs through
``Model.prefill`` and ``decode_step``.

On an expert-parallel :class:`~repro_torch.distributed.topology.Topology`
every rank runs one engine (SPMD) on the same requests: the engine's
decisions (admission, pages, harvest) read only the requests and the
logits, which every rank computes alike, never the clock, which only
stamps the requests' times, so the ranks meet in each MoE layer's
collectives.  :meth:`run` then gathers each rank's generated tokens and
raises if they differ.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.selection import validate_expert_mask
from repro_torch.distributed import collectives as coll
from repro_torch.models import kvcache, transformer
from repro_torch.models.model import Model
from repro_torch.serving.common import Request, ShapeSignatures, SlotEngineBase

__all__ = ["Request", "ServingEngine"]


class ServingEngine(SlotEngineBase):
    def __init__(
        self,
        model: Model,
        params,
        *,
        max_batch: int = 8,
        max_len: int = 512,
        expert_mask=None,
        clock: Optional[Callable[[], float]] = None,
        page_size: int = 16,
        kv_pages: Optional[int] = None,
        prefill_chunk: int = 32,
        admission: str = "priority",
    ):
        super().__init__(max_batch, clock, max_len=max_len, admission=admission)
        cfg = model.cfg
        if any(spec.cross_attn for spec in cfg.layer_pattern):
            raise NotImplementedError(
                f"{cfg.name}: cross-attention (encoder-decoder) patterns are not served: "
                "the reference ServingEngine hands Model.prefill only the prompt's tokens, "
                "no encoder input (frame_embeds); run Model.prefill / decode_step"
            )
        self.model = model
        self.device = model.device
        self.params = transformer.compute_params(params, cfg)
        validate_expert_mask(
            expert_mask, cfg.moe.num_experts if cfg.moe is not None else None,
            where="ServingEngine(expert_mask)",
        )
        self.expert_mask = (
            None if expert_mask is None
            else torch.as_tensor(np.asarray(expert_mask, bool), device=self.device)
        )
        self._traces: Dict[str, set] = {}
        self.paged = kvcache.pattern_is_pageable(cfg)
        if not self.paged:
            self.cache = kvcache.init_cache(cfg, max_batch, max_len, cfg.torch_dtype,
                                            self.device, model.topo)
            return
        self.page_size = page_size
        self.pages_per_slot, ring = kvcache.page_geometry(
            cfg, max_len, page_size, chunk_headroom=prefill_chunk
        )
        if prefill_chunk > ring:
            raise ValueError(
                f"prefill_chunk={prefill_chunk} exceeds the ring capacity {ring} "
                "(a chunk must fit the page list)"
            )
        self.prefill_chunk = prefill_chunk
        self.pool = kvcache.PagePool(
            kv_pages or max_batch * self.pages_per_slot,
            page_size, self.pages_per_slot, n_slots=max_batch,
        )
        self.pages = kvcache.init_paged_blocks(
            cfg, cfg.block_repeat, self.pool.num_pages, page_size,
            cfg.torch_dtype, self.device,
        )
        self._slot_len = np.zeros((max_batch,), np.int64)
        mask = self.expert_mask
        self._decode = ShapeSignatures(
            lambda p, t, pg, tab, ln: model.decode_step_paged(
                p, t, pg, tab, ln, page_size=page_size, expert_mask=mask,
            ),
            self._traces.setdefault("decode", set()),
        )
        self._prefill_chunk_fn = ShapeSignatures(
            lambda p, t, pg, tab, s, v: model.prefill_chunk_step(
                p, t, pg, tab, s, v, page_size=page_size, expert_mask=mask,
            ),
            self._traces.setdefault("prefill_chunk", set()),
        )

    def _ints(self, values) -> torch.Tensor:
        return torch.from_numpy(np.asarray(values, np.int32)).to(self.device)

    # -- request lifecycle ---------------------------------------------------

    def _pages_for(self, req: Request) -> int:
        return kvcache.pages_needed(
            len(req.prompt) + req.max_new_tokens, self.page_size, self.pages_per_slot
        )

    def _page_capacity(self):
        return self.pool.num_pages if self.paged else None

    def _admittable(self, slot: int, req: Request) -> bool:
        # a free slot is not enough: the request's worst-case page count must
        # be reservable now, because nothing preempts it once it decodes
        return not self.paged or self.pool.can_reserve(self._pages_for(req))

    def _prefill_into_slot(self, slot: int, req: Request):
        """Chunked prefill straight into the slot's pages; on the dense
        branch a whole-prompt prefill whose cache :meth:`_install_slot`
        copies into the slot."""
        if not self.paged:
            logits, one_cache = self.model.prefill(
                self.params, {"tokens": self._ints(req.prompt)[None]}, max_len=self.max_len,
                expert_mask=self.expert_mask)
            return int(torch.argmax(logits[0])), one_cache
        S = len(req.prompt)
        C = self.prefill_chunk
        self.pool.reserve(slot, self._pages_for(req))
        logits = None
        for p0 in range(0, S, C):
            v = min(C, S - p0)
            self.pool.map_range(slot, p0, p0 + v)
            chunk = np.zeros((1, C), np.int32)
            chunk[0, :v] = req.prompt[p0 : p0 + v]
            logits, self.pages = self._prefill_chunk_fn(
                self.params, self._ints(chunk), self.pages,
                self.pool.device_rows([slot], device=self.device),
                self._ints([p0]), self._ints([v]),
            )
        return int(torch.argmax(logits[0])), S

    def _install_slot(self, slot: int, payload):
        if not self.paged:
            self.cache = kvcache.install_slot(self.cache, slot, payload)
        else:
            self._slot_len[slot] = payload  # the pages already hold the prompt

    def _release_slot(self, slot: int):
        if self.paged:
            self.pool.free(slot)
            self._slot_len[slot] = 0

    # -- stepping -------------------------------------------------------------

    def step(self) -> int:
        """One engine iteration: admit waiting requests, then one decode step
        for all active slots."""
        self._admit()
        if not self._active.any():
            return 0
        if not self.paged:
            logits, self.cache = self.model.decode_step(
                self.params, self._ints(self._next_token), self.cache,
                expert_mask=self.expert_mask)
            return self._harvest(torch.argmax(logits, dim=-1).cpu().numpy())
        for slot in range(self.max_batch):
            if self._active[slot]:
                self.pool.append(slot, int(self._slot_len[slot]))
        table = self.pool.device_rows(
            range(self.max_batch), active=self._active, device=self.device
        )
        logits, self.pages = self._decode(
            self.params, self._ints(self._next_token), self.pages, table,
            self._ints(self._slot_len),
        )
        self._slot_len[self._active] += 1
        next_ids = torch.argmax(logits, dim=-1).cpu().numpy()
        return self._harvest(next_ids)

    def run(self, max_steps: int = 10_000):
        finished = super().run(max_steps)
        topo = self.model.topo
        if topo.num_devices > 1:
            mine = sorted((r.request_id, tuple(r.generated)) for r in finished)
            ranks = coll.gather_objects(mine, topo.world_group)
            if any(other != mine for other in ranks):
                raise RuntimeError(
                    "ServingEngine: the ranks generated different tokens: "
                    + "; ".join(f"rank {i}: {r}" for i, r in enumerate(ranks)))
        return finished

    # -- introspection --------------------------------------------------------

    def stage_trace_counts(self) -> Dict[str, int]:
        """Distinct argument shape signatures per stage function (bounded by
        the chunk shape, not by distinct prompt lengths)."""
        return {k: len(v) for k, v in self._traces.items()}

    def attn_bytes_step(self) -> Dict[str, int]:
        """KV bytes the paged attention sweep reads per decode step across
        all layers at the current occupancy, beside what a dense
        ``max_batch x ring`` sweep would read.  The dense branch has no
        paged sweep: both read zero."""
        if not self.paged:
            return {"attn_bytes_paged_step": 0, "attn_bytes_dense_step": 0}
        page_bytes = kvcache.paged_block_bytes(self.pages)
        return {
            "attn_bytes_paged_step": self.pool.pages_in_use * page_bytes,
            "attn_bytes_dense_step": self.max_batch * self.pages_per_slot * page_bytes,
        }

    def metrics(self) -> Dict[str, float]:
        if not self.paged:
            return {"requests_finished": len(self.finished), "paged": False}
        page_bytes = kvcache.paged_block_bytes(self.pages)
        return {
            "requests_finished": len(self.finished),
            "paged": True,
            "kv_pages_in_use": self.pool.pages_in_use,
            "kv_pages_capacity": self.pool.num_pages,
            "kv_utilization": self.pool.utilization,
            "kv_bytes_peak": self.pool.peak_in_use * page_bytes,
            "kv_bytes_dense_equiv": self.max_batch * self.pages_per_slot * page_bytes,
            **self.attn_bytes_step(),
        }
