"""Fault tolerance for the training loop (port of the reference's
``distributed/fault.py``): ``StepGuard`` detects bad steps (NaN / inf
loss, runaway grad norm, injected failures) so the trainer restores and
continues, ``FailureInjector`` fails chosen steps deterministically (tests
and drills), ``StragglerMitigator`` flags slow steps against the rolling
median, and ``elastic_topology`` rebuilds a (possibly smaller) mesh from
the devices that survive, keeping the model axis: experts keep their EP
layout and data parallelism absorbs the loss.  A checkpoint restores onto
any mesh (``checkpoint.checkpointer``), so training goes on there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.distributed.topology import Topology


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


def elastic_shape(n_available: int, model_axis_size: int) -> Tuple[int, int]:
    """(dp, model) of the largest mesh of at most ``n_available`` devices
    whose model axis is ``model_axis_size``; raises as the reference does
    when fewer devices remain than the model axis needs."""
    if n_available < model_axis_size:
        raise RuntimeError(
            f"cannot keep model axis: {n_available} devices < "
            f"{model_axis_size}-way model parallelism")
    return n_available // model_axis_size, model_axis_size


def elastic_topology(n_available: int, *, model_axis_size: int,
                     axis_names=("data", "model")) -> Topology:
    """The reference's ``elastic_topology``: this rank's topology on the
    largest (dp, model) mesh that keeps the model axis
    (:func:`elastic_shape`), policy ``"tp"``.

    The port runs SPMD, one process a rank, so the launcher starts
    ``dp · model`` ranks (``launch.mesh.spawn_ranks(elastic_shape(...),
    ...)``) and the surplus devices stay idle; the process group must hold
    exactly that many ranks (``make_topology`` raises otherwise)."""
    from repro_torch.launch.mesh import make_topology

    return make_topology(elastic_shape(n_available, model_axis_size), tuple(axis_names),
                         policy="tp")


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
