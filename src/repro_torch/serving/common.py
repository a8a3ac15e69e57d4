"""Serving infrastructure shared by the port's engines: requests, slot
bookkeeping, a shape-signature counter, the end<->cloud link meter, the
pipeline's multi-server resource-occupancy clock and the modeled clock
that request stamps can run on (port of the reference's
``serving/common.py``).

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

from repro_torch.serving.faults import StallGuard


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
    # SLO class: lower ``priority`` admits first (0 = interactive); the
    # latency targets ride along for the load harness to score
    priority: int = 1
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None
    # filled by the engine
    generated: List[int] = field(default_factory=list)
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    seq: int = -1  # submission order stamp (ties within a priority class)
    n_preemptions: int = 0  # times this request was spilled and requeued
    n_migrations: int = 0  # times restored on another lane after its lane died

    @property
    def done(self) -> bool:
        return self.finish_time is not None

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token (None until it lands)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first (None until finished,
        or for one-token generations)."""
        if self.finish_time is None or len(self.generated) < 2:
            return None
        return (self.finish_time - self.first_token_time) / (len(self.generated) - 1)


class VirtualClock:
    """Callable clock over modeled time.  An engine handed one stamps
    request times (submit, first token, finish) on its ``StageTimeline``
    axis: it sets ``now`` to the modeled completion of the stage that
    produced each event, so TTFT and TPOT are read on the deterministic
    clock the schedule is computed on.  The load generator's loop
    (``serving.loadgen.drive``) releases arrivals as ``now`` passes them and
    advances ``now`` to the timeline's makespan after each tick."""

    def __init__(self, now: float = 0.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance_to(self, t: float) -> float:
        """Monotone advance (only an engine stamping a stage completion
        moves ``now`` backwards)."""
        self.now = max(self.now, t)
        return self.now


@dataclass
class LinkStats:
    """Meter for the end<->cloud link: bytes on the wire in each direction
    plus modeled uplink seconds (bytes over the planner's link rate: a
    model of the link, not a measurement), and the end<->end peer traffic
    of a fleet's expert slabs."""

    bytes_up: int = 0
    bytes_down: int = 0
    bytes_peer: int = 0
    transfers: int = 0
    seconds_up: float = 0.0
    seconds_peer: float = 0.0

    def transfer_time(self, nbytes: int, gbps: float) -> float:
        return nbytes * 8.0 / max(gbps * 1e9, 1e-9)

    def record_peer(self, nbytes: int, seconds: float) -> None:
        """Meter an end<->end slab fetch; its wire time comes from the fleet
        registry's peer-link model, so it is recorded, not derived."""
        self.bytes_peer += nbytes
        self.seconds_peer += seconds

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
    max(input ready, resource free).  A resource may have several servers
    (``capacity``), each booking jobs into busy intervals, and a job starts
    in the earliest gap at or after its ready time on whichever server
    offers the earliest start (backfill: fleet lanes book the shared cloud
    out of modeled-time order, and a fast lane's job must land in the
    earlier gap).  The streaming engine feeds it stage times (measured or
    modeled) and modeled link times; ``busy_s`` sums each resource's booked
    seconds, ``serial_s`` all of them, and ``makespan_s`` is the latest end.
    The fleet engine shares one timeline: a multi-server ``"cloud"`` and
    each lane's own end and link resources (``add_resource``)."""

    def __init__(self, resources: Sequence[str] = ("end", "link", "cloud"),
                 capacity: Optional[Dict[str, int]] = None):
        capacity = capacity or {}
        # per resource, per server: sorted [start, end) busy intervals
        self._servers: Dict[str, List[List[Tuple[float, float]]]] = {
            r: [[] for _ in range(max(capacity.get(r, 1), 1))] for r in resources
        }
        self.busy_s: Dict[str, float] = {r: 0.0 for r in resources}
        self.serial_s = 0.0
        self._max_end = 0.0

    def add_resource(self, name: str, capacity: int = 1):
        """Register a resource if absent (an existing one keeps its
        servers and bookings)."""
        if name not in self._servers:
            self._servers[name] = [[] for _ in range(max(capacity, 1))]
            self.busy_s[name] = 0.0

    def n_servers(self, name: str) -> int:
        return len(self._servers[name])

    def remove_server(self, name: str):
        """Drop one server of a multi-server resource (a shared cloud server
        dies).  Work already booked on it stays in ``busy_s`` and
        ``makespan_s``, but its intervals go, so later bookings queue on the
        survivors.  The last server cannot go: that is a total outage, not a
        smaller capacity."""
        servers = self._servers[name]
        if len(servers) <= 1:
            raise ValueError(f"resource {name!r} has a single server; removing it is a "
                             "total outage, not a capacity reduction")
        servers.pop()

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

    @property
    def free_at(self) -> Dict[str, float]:
        """When each resource's earliest-draining server runs dry."""
        return {r: min((ivals[-1][1] if ivals else 0.0) for ivals in servers)
                for r, servers in self._servers.items()}

    def occupy(self, resource: str, ready_s: float, service_s: float) -> float:
        """Book ``service_s`` on ``resource`` no earlier than ``ready_s``;
        returns the job's end time."""
        servers = self._servers[resource]
        best, best_start = 0, None
        for i, ivals in enumerate(servers):
            start = self._earliest_start(ivals, ready_s, service_s)
            if best_start is None or start < best_start:
                best, best_start = i, start
        end = best_start + service_s
        if service_s > 0:
            ivals = servers[best]
            j = bisect.bisect_left(ivals, (best_start, end))
            # coalesce with touching neighbours, so the lists stay short
            s, e = best_start, end
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
        self.serial_s += service_s
        self._max_end = max(self._max_end, end)
        return end

    @property
    def makespan_s(self) -> float:
        return self._max_end

    def summary(self) -> Dict[str, float]:
        return {"pipelined_s": self.makespan_s, "serial_s": self.serial_s,
                **{f"busy_{r}_s": t for r, t in self.busy_s.items()}}


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

    def _slot_usable(self, slot: int) -> bool:
        """Hook: may this slot hold requests at all?  (Padding slots of
        equal-sized micro-batch groups and slots mid-prefill may not.)"""
        return True

    def _admittable(self, slot: int, req: Request) -> bool:
        return True

    def free_slots(self) -> int:
        """Slots able to take a request now (the fleet frontend's admission
        capacity)."""
        return sum(1 for i, s in enumerate(self.slots) if s is None and self._slot_usable(i))

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
            while self.slots[slot] is None and self._slot_usable(slot):
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

    def stall_diagnostic(self) -> str:
        """Queue and slot snapshot for the livelock guard's message (``.``
        free, ``i`` installed but inactive, ``A`` decoding)."""
        slots = "".join("." if r is None else ("A" if self._active[i] else "i")
                        for i, r in enumerate(self.slots))
        return f"waiting={len(self.waiting)} finished={len(self.finished)} slots=[{slots}]"

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Run until every submitted request finishes.  ``stall_limit``
        consecutive busy ticks without progress raise (livelock) with the
        engine's diagnostic instead of spinning to ``max_steps``."""
        guard = StallGuard(self.stall_limit)
        for _ in range(max_steps):
            if not self.busy():
                break
            self.step()
            guard.note(self._progress_sig(), self.stall_diagnostic)
        return self.finished
