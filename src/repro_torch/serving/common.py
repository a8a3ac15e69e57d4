"""Serving infrastructure shared by the port's engines: requests, slot
bookkeeping, a shape-signature counter, the end<->cloud link meter and the
pipeline's resource-occupancy clock (port of the reference's
``serving/common.py``, the parts the paged ``ServingEngine``, the one-shot
``EndCloudPipeline`` and the streaming ``EndCloudServingEngine`` use).

``SlotEngineBase`` is a slot machine: a fixed decode batch of ``max_batch``
slots; finished requests free their slot and waiting requests are prefilled
into it.  Subclasses provide the prefill and decode compute.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def element_bytes(dtype: torch.dtype) -> int:
    """Bytes per element of ``dtype``: the one place byte metering
    resolves element widths."""
    return torch.empty((), dtype=dtype).element_size()


def payload_nbytes(z) -> int:
    """Bytes of a boundary payload: one tensor, or a tuple of tensors (the
    quantized boundary ships ``(codes, scales)``, and both cross the wire)."""
    parts = z if isinstance(z, (tuple, list)) else (z,)
    return sum(p.numel() * p.element_size() for p in parts)


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 16
    eos_id: int = -1  # -1 = never
    # SLO class: lower ``priority`` admits first (0 = interactive)
    priority: int = 1
    # filled by the engine
    generated: List[int] = field(default_factory=list)
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    seq: int = -1  # submission order stamp (ties within a priority class)
    n_preemptions: int = 0  # times this request was spilled and requeued

    @property
    def done(self) -> bool:
        return self.finish_time is not None


@dataclass
class LinkStats:
    """Meter for the end<->cloud link: bytes on the wire in each direction
    plus modeled uplink seconds (bytes over the planner's link rate: a
    model of the link, not a measurement).  The reference's peer meter
    comes with the fleet engine that records it."""

    bytes_up: int = 0
    bytes_down: int = 0
    transfers: int = 0
    seconds_up: float = 0.0

    def transfer_time(self, nbytes: int, gbps: float) -> float:
        return nbytes * 8.0 / max(gbps * 1e9, 1e-9)

    def record_up(self, nbytes: int, gbps: float) -> float:
        """Meter an end->cloud transfer; returns its modeled wire time."""
        t = self.transfer_time(nbytes, gbps)
        self.bytes_up += nbytes
        self.transfers += 1
        self.seconds_up += t
        return t

    def record_down(self, nbytes: int) -> None:
        """Meter a cloud->end transfer (token-id feedback: bytes only)."""
        self.bytes_down += nbytes


class StageTimeline:
    """Resource-occupancy clock of the decode pipeline: a stage starts at
    max(input ready, resource free), each resource books jobs into busy
    intervals and a job starts in the earliest gap at or after its ready
    time.  The streaming engine feeds it stage times (measured or modeled)
    and modeled link times; each booking's end is when its stage's output
    is ready, and ``busy_s`` sums each resource's booked seconds.  (The
    reference's multi-server resources serve the fleet engine, which is not
    ported.)"""

    def __init__(self, resources: Sequence[str] = ("end", "link", "cloud")):
        self._intervals: Dict[str, List[Tuple[float, float]]] = {r: [] for r in resources}
        self.busy_s: Dict[str, float] = {r: 0.0 for r in resources}

    @staticmethod
    def _earliest_start(intervals: List[Tuple[float, float]], ready_s: float,
                        service_s: float) -> float:
        start = ready_s
        for s, e in intervals:
            if start + service_s <= s:
                break  # fits in the gap before this interval
            if e > start:
                start = e
        return start

    def occupy(self, resource: str, ready_s: float, service_s: float) -> float:
        """Book ``service_s`` on ``resource`` no earlier than ``ready_s``;
        returns the job's end time."""
        ivals = self._intervals[resource]
        start = self._earliest_start(ivals, ready_s, service_s)
        end = start + service_s
        if service_s > 0:
            j = bisect.bisect_left(ivals, (start, end))
            # coalesce with touching neighbours, so the lists stay short
            s, e = start, end
            if j < len(ivals) and ivals[j][0] <= e:
                e = max(e, ivals[j][1])
                del ivals[j]
            if j > 0 and ivals[j - 1][1] >= s:
                s = ivals[j - 1][0]
                e = max(e, ivals[j - 1][1])
                del ivals[j - 1]
                j -= 1
            ivals.insert(j, (s, e))
        self.busy_s[resource] += service_s
        return end


def _signature(tree) -> Tuple:
    """(shape, dtype) of every tensor in a nested args structure."""
    if isinstance(tree, torch.Tensor):
        return ((tuple(tree.shape), str(tree.dtype)),)
    if isinstance(tree, dict):
        return tuple(s for k in sorted(tree) for s in _signature(tree[k]))
    if isinstance(tree, (tuple, list)):
        return tuple(s for t in tree for s in _signature(t))
    return ((type(tree).__name__,),)


class ShapeSignatures:
    """Records the distinct argument shape/dtype signatures a stage function
    is called with, in place of the reference's ``TraceCounter``: eager
    PyTorch compiles no trace, but each signature is what a captured CUDA
    graph would have to be keyed on, so the engine's bound (one per chunk
    shape, never one per prompt length) stays testable.  ``sig_from`` skips
    leading arguments whose shapes cannot change (the params);
    ``generation`` tags a rebuild of the stage functions, which the
    reference's rebuilt ``jit`` traces anew even for shapes it has seen."""

    def __init__(self, fn: Callable, log: set, generation: int = 0, sig_from: int = 1):
        self._fn = fn
        self._log = log
        self._gen = generation
        self._sig_from = sig_from

    def __call__(self, *args):
        self._log.add((self._gen, _signature(args[self._sig_from:])))
        return self._fn(*args)


class SlotEngineBase:
    """Slot lifecycle shared by the serving engines.

    Subclasses implement ``_prefill_into_slot(slot, req) -> (token,
    payload)``, ``_install_slot(slot, payload)`` (called only when the
    request continues past prefill) and ``step``; ``_release_slot`` runs
    whenever a request leaves its slot so paged engines can free its
    pages.  The base provides submit-time checks, admission in stable
    ``(priority, seq)`` order, token harvesting and the run loop."""

    def __init__(self, max_batch: int, clock: Optional[Callable[[], float]] = None,
                 max_len: Optional[int] = None, admission: str = "priority"):
        if admission not in ("priority", "fifo"):
            raise ValueError(f"admission={admission!r}")
        self.max_batch = max_batch
        self.max_len = max_len
        self.clock = clock or time.monotonic
        self.admission = admission
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self._next_token = np.zeros((max_batch, 1), np.int32)
        self._active = np.zeros((max_batch,), bool)
        self._submit_seq = 0
        # busy ticks tolerated with no progress before ``run`` raises
        self.stall_limit = 256

    def validate(self, req: Request):
        """Reject at submit time a request that could never be served: an
        empty prompt, no tokens to generate, more positions than
        ``max_len`` (the KV ring would wrap), or more KV pages than the
        whole pool holds (it would block the queue forever)."""
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.request_id}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.request_id}: max_new_tokens={req.max_new_tokens} "
                "(prefill always emits one token)"
            )
        if self.max_len is not None:
            need = len(req.prompt) + req.max_new_tokens
            if need > self.max_len:
                raise ValueError(
                    f"request {req.request_id}: prompt ({len(req.prompt)}) + "
                    f"max_new_tokens ({req.max_new_tokens}) = {need} exceeds "
                    f"max_len={self.max_len}; the KV ring buffer would wrap"
                )
        cap = self._page_capacity()
        if cap is not None:
            pages = self._pages_for(req)
            if pages > cap:
                raise ValueError(
                    f"request {req.request_id}: needs {pages} KV pages but the "
                    f"page pool holds only {cap}; it could never be admitted "
                    "and would block the queue forever"
                )

    def _page_capacity(self) -> Optional[int]:
        return None

    def _pages_for(self, req: Request) -> int:
        raise NotImplementedError

    def submit(self, req: Request):
        self.validate(req)
        req.submit_time = self.clock()
        req.seq = self._submit_seq
        self._submit_seq += 1
        self.waiting.append(req)

    def _admittable(self, slot: int, req: Request) -> bool:
        return True

    def busy(self) -> bool:
        return bool(self.waiting) or bool(self._active.any())

    def _admission_order(self) -> List[Request]:
        """``"priority"``: stable sort on (priority, submission seq);
        ``"fifo"``: submission order.  Either way the head of the order
        blocks the rest, so a page-blocked head is never starved."""
        if self.admission == "priority":
            return sorted(self.waiting, key=lambda r: (r.priority, r.seq))
        return list(self.waiting)

    def _admit(self):
        """Prefill waiting requests into free slots.  A request that
        finishes at its prefill token leaves the slot free, so the same slot
        is offered to the next waiter at once."""
        for slot in range(self.max_batch):
            while self.slots[slot] is None:
                queue = self._admission_order()
                if not queue or not self._admittable(slot, queue[0]):
                    break
                req = queue[0]
                self.waiting.remove(req)
                tok, payload = self._prefill_into_slot(slot, req)
                req.generated.append(tok)
                if req.first_token_time is None:
                    req.first_token_time = self.clock()
                if tok == req.eos_id or len(req.generated) >= req.max_new_tokens:
                    req.finish_time = self.clock()
                    self.finished.append(req)
                    self._release_slot(slot)
                    continue
                self._install_slot(slot, payload)
                self.slots[slot] = req
                self._next_token[slot, 0] = tok
                self._active[slot] = True

    def _prefill_into_slot(self, slot: int, req: Request):
        raise NotImplementedError

    def _install_slot(self, slot: int, payload):
        raise NotImplementedError

    def _release_slot(self, slot: int):
        """Hook: a request left this slot."""

    def _harvest(self, next_ids: np.ndarray, slot_range=None) -> int:
        """Record one decoded token per active slot of ``slot_range`` (all
        slots by default); retire finished ones.  ``next_ids`` is indexed by
        absolute slot id."""
        n_emitted = 0
        for slot in slot_range if slot_range is not None else range(self.max_batch):
            req = self.slots[slot]
            if req is None:
                continue
            tok = int(next_ids[slot])
            req.generated.append(tok)
            n_emitted += 1
            self._next_token[slot, 0] = tok
            if tok == req.eos_id or len(req.generated) >= req.max_new_tokens:
                req.finish_time = self.clock()
                self.finished.append(req)
                self.slots[slot] = None
                self._active[slot] = False
                self._release_slot(slot)
        return n_emitted

    def _harvest_tokens(self, slot: int, tokens) -> int:
        """:meth:`_harvest` of several tokens for one slot (a speculative
        round's accepted ones), in order; EOS or the budget mid-way retires
        the slot and drops the rest, which plain decode never produced."""
        req = self.slots[slot]
        if req is None or not tokens:
            return 0
        n_emitted = 0
        for tok in tokens:
            tok = int(tok)
            req.generated.append(tok)
            n_emitted += 1
            self._next_token[slot, 0] = tok
            if tok == req.eos_id or len(req.generated) >= req.max_new_tokens:
                req.finish_time = self.clock()
                self.finished.append(req)
                self.slots[slot] = None
                self._active[slot] = False
                self._release_slot(slot)
                break
        return n_emitted

    def step(self) -> int:
        raise NotImplementedError

    def _progress_sig(self) -> tuple:
        gen = sum(len(r.generated) for r in self.slots if r is not None)
        return (len(self.finished), len(self.waiting), int(self._active.sum()), gen)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Run until every submitted request finishes.  ``stall_limit``
        consecutive busy ticks without progress raise (livelock) instead of
        spinning to ``max_steps``."""
        last, stalled = None, 0
        for _ in range(max_steps):
            if not self.busy():
                break
            self.step()
            sig = self._progress_sig()
            stalled = stalled + 1 if sig == last else 0
            last = sig
            if stalled >= self.stall_limit:
                raise RuntimeError(
                    f"livelock: {stalled} busy ticks without progress "
                    f"(waiting={len(self.waiting)} finished={len(self.finished)})"
                )
        return self.finished
