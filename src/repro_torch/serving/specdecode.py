"""Speculative multi-token decode across the end-cloud link (port of the
reference's ``serving/specdecode.py``: the engine-independent pieces, in
numpy).

A plain decode round ships one boundary activation up the link and gets one
token back, so in the link-bound regime the round trip caps per-request
latency.  A speculative round drafts ``k`` tokens on the end tier (the full
stack under the end tier's expert mask, against a dense per-slot draft
cache), ships one boundary chunk of k positions, and verifies all k in one
C = k chunk on the cloud.  The accepted prefix commits its lazily mapped
pages; the first rejection rolls the page tables back (``PagePool.rollback``,
table surgery only) and the verify argmax there is the corrected token, so
greedy output equals plain decode's.

Here: the greedy accept rule (:func:`accept_greedy`, :func:`batched_accept`),
the acceptance feedback (:class:`SpecState`) that adapts the draft length
within the planner's budget (``core.pipeline.plan_spec_k``), and the
rollback arithmetic (:func:`rollback_entries`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


def accept_greedy(drafts: Sequence[int], verify_ids: Sequence[int]) -> Tuple[List[int], int]:
    """Greedy accept rule for one slot's round.

    A C-position verify chunk consumed ``[x_0, y_1..y_{C-1}]`` (the pending
    token, then C-1 drafts); ``verify_ids[i]`` is the model's next token
    after row i.  Returns ``(committed, n_rejected_drafts)``: ``v_0..v_a``
    for the longest prefix with ``drafts[i] == verify_ids[i]`` for i < a.
    ``v_0`` always commits (plain decode's own next token), so every round
    makes progress; at a rejection ``v_a`` is the corrected token."""
    C = len(verify_ids)
    if len(drafts) != C - 1:
        raise ValueError(f"drafts/verify length mismatch: {len(drafts)} vs {C} - 1")
    if C == 0:
        return [], 0
    a = 0
    while a < C - 1 and int(drafts[a]) == int(verify_ids[a]):
        a += 1
    return [int(v) for v in verify_ids[: a + 1]], C - 1 - a


@dataclass
class SpecState:
    """Acceptance feedback for one engine.  The planner fixes the budget
    ``k_plan``; ``k_eff`` halves while the acceptance EMA is below ``lo``
    and doubles back above ``hi``, never below 2 while the plan allows
    speculation (at 1 no acceptance would be observed again; turning
    speculation off is the planner's call)."""

    k_plan: int
    ema: float = 0.3  # weight of the newest sample
    lo: float = 0.5
    hi: float = 0.8
    acceptance: Optional[float] = None
    k_eff: int = field(init=False)
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    rollbacks: int = 0

    def __post_init__(self) -> None:
        self.k_eff = max(2, min_pow2_le(self.k_plan)) if self.k_plan > 1 else 1

    def observe_round(self, n_drafted: int, n_accepted: int, *, rolled_back: bool) -> None:
        """One round: ``n_drafted`` positions offered past the guaranteed
        first token, ``n_accepted`` of them accepted; ``rolled_back`` when
        provisional pages were unmapped."""
        self.rounds += 1
        self.drafted += n_drafted
        self.accepted += n_accepted
        if rolled_back:
            self.rollbacks += 1
        if n_drafted > 0:
            obs = n_accepted / n_drafted
            if self.acceptance is None:
                self.acceptance = obs
            else:
                self.acceptance = (1 - self.ema) * self.acceptance + self.ema * obs
            self._adapt()

    def _adapt(self) -> None:
        if self.k_plan <= 1:
            return
        if self.acceptance < self.lo and self.k_eff > 2:
            self.k_eff //= 2
        elif self.acceptance > self.hi and self.k_eff * 2 <= min_pow2_le(self.k_plan):
            self.k_eff *= 2

    @property
    def acceptance_rate(self) -> float:
        """Lifetime acceptance over drafted positions (0.0 before any)."""
        return self.accepted / self.drafted if self.drafted else 0.0

    def metrics(self) -> dict:
        return {
            "spec_rounds": self.rounds,
            "spec_drafted": self.drafted,
            "spec_accepted": self.accepted,
            "spec_acceptance_rate": round(self.acceptance_rate, 4),
            "spec_rollbacks": self.rollbacks,
        }


def min_pow2_le(k: int) -> int:
    """Largest power of two <= k (k >= 1)."""
    if k < 1:
        raise ValueError(f"k={k} < 1")
    p = 1
    while p * 2 <= k:
        p *= 2
    return p


def rollback_entries(new_entries: Sequence[int], *, base_len: int, n_commit: int,
                     page_size: int, pages_per_slot: int) -> List[int]:
    """The entries of a round's ``PagePool.map_tokens(slot, base_len, ...)``
    to unmap once ``n_commit`` tokens committed: those covering positions
    ``[base_len, base_len + n_commit)`` hold accepted KV and stay."""
    keep = set()
    if n_commit > 0:
        keep = {pi % pages_per_slot
                for pi in range(base_len // page_size,
                                (base_len + n_commit - 1) // page_size + 1)}
    return [e for e in new_entries if e not in keep]


def batched_accept(drafts: np.ndarray, verify_ids: np.ndarray,
                   n_valid: np.ndarray) -> Tuple[List[List[int]], np.ndarray]:
    """:func:`accept_greedy` over a group: ``drafts`` [B, >= k-1] (only the
    first ``n_valid[b] - 1`` take part), ``verify_ids`` [B, k], ``n_valid``
    [B] (0 = inactive row, commits nothing).  Returns (committed tokens a
    row, rejected drafts a row)."""
    B = verify_ids.shape[0]
    committed: List[List[int]] = []
    n_rejected = np.zeros((B,), np.int64)
    for b in range(B):
        nv = int(n_valid[b])
        if nv <= 0:
            committed.append([])
            continue
        toks, rej = accept_greedy([int(t) for t in drafts[b, : nv - 1]],
                                  [int(t) for t in verify_ids[b, :nv]])
        committed.append(toks)
        n_rejected[b] = rej
    return committed, n_rejected
