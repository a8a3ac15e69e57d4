"""Fault tolerance for the training loop (port of the reference's
``distributed/fault.py``): ``StepGuard`` detects bad steps (NaN / inf
loss, runaway grad norm, injected failures) so the trainer restores and
continues, ``FailureInjector`` fails chosen steps deterministically (tests
and drills), ``StragglerMitigator`` flags slow steps against the rolling
median.  The reference's ``elastic_topology`` rebuilds a smaller mesh
and is not ported: it comes with ROADMAP item 8b.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class FailureInjector:
    """Deterministically fail specific steps.  One-shot: after a restore
    replays past the step, it does not fire again (the 'node' was
    replaced)."""

    fail_steps: Sequence[int] = ()
    kind: str = "nan_loss"  # nan_loss | exception
    _fired: set = field(default_factory=set)

    def maybe_fail(self, step: int, loss: float) -> float:
        if step in self.fail_steps and step not in self._fired:
            self._fired.add(step)
            if self.kind == "exception":
                raise RuntimeError(f"injected device failure at step {step}")
            return float("nan")
        return loss


@dataclass
class StepGuard:
    max_grad_norm: float = 1e4
    consecutive_bad_limit: int = 3
    bad_count: int = 0

    def check(self, loss: float, grad_norm: Optional[float] = None) -> bool:
        """True = the step is good; False = restore from the checkpoint."""
        bad = not math.isfinite(loss)
        if grad_norm is not None and (
            not math.isfinite(grad_norm) or grad_norm > self.max_grad_norm
        ):
            bad = True
        if bad:
            self.bad_count += 1
            if self.bad_count > self.consecutive_bad_limit:
                raise RuntimeError(
                    f"{self.bad_count} consecutive bad steps — refusing to "
                    "continue (checkpoint likely also bad)"
                )
            return False
        self.bad_count = 0
        return True


@dataclass
class StragglerMitigator:
    """Rolling step-time watchdog: a step counts as straggling at
    ``threshold`` times the rolling median of the last ``window`` steps."""

    window: int = 20
    threshold: float = 2.0
    times: List[float] = field(default_factory=list)
    flagged: List[int] = field(default_factory=list)

    def record(self, step: int, dt: float) -> Optional[str]:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 5:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold * med:
                self.flagged.append(step)
                return "reshard_recommended"
        return None
