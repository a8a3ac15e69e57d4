"""The serving side's retry policy and livelock guard (the port's own copy
of ``HealthMonitor``'s backoff and ``StallGuard`` from the reference's
``serving/faults.py``).

* :class:`HealthMonitor`: the bounded exponential backoff every retried
  transfer follows (``backoff_s(attempt) = min(base * 2**attempt, cap)``).
  The fleet shares one monitor across its lanes; a failed peer slab fetch
  backs off once before it falls back to the cloud.
* :class:`StallGuard`: N consecutive busy ticks with an unchanged progress
  signature raise with a queue and slot diagnostic instead of spinning.

The monitor's heartbeat half (``beat``, ``suspect``, its timeouts and
attempt limit), which only lane-failure detection reads, and the fault
schedules and their injector (``FaultEvent``, ``FaultSchedule``,
``ChaosInjector``) are not ported yet (ROADMAP queue A item 5b).  Numpy
free, torch free: the engines import this module, never the other way.
"""

from __future__ import annotations

from typing import Callable, Union

__all__ = ["HealthMonitor", "StallGuard"]


class HealthMonitor:
    """The shared retry and backoff policy: a retried transfer idles
    ``backoff_s(attempt)`` before resending, capped at ``backoff_cap_s``."""

    def __init__(self, *, backoff_base_s: float = 0.01, backoff_cap_s: float = 0.25):
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s

    def backoff_s(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (0-based): bounded exponential."""
        return min(self.backoff_base_s * (2.0 ** max(attempt, 0)), self.backoff_cap_s)


class StallGuard:
    """Livelock guard for the run loops: feed it a hashable progress
    signature once a busy tick; ``limit`` consecutive identical signatures
    raise ``RuntimeError`` with the engine's diagnostic."""

    def __init__(self, limit: int = 256):
        if limit < 1:
            raise ValueError("stall limit must be >= 1")
        self.limit = limit
        self._last = None
        self.stalled_ticks = 0

    def reset(self):
        self._last = None
        self.stalled_ticks = 0

    def note(self, sig, diagnostic: Union[str, Callable[[], str]] = ""):
        if sig == self._last:
            self.stalled_ticks += 1
            if self.stalled_ticks >= self.limit:
                detail = diagnostic() if callable(diagnostic) else diagnostic
                raise RuntimeError(
                    f"no progress for {self.stalled_ticks} consecutive busy ticks "
                    f"(livelock): {detail}"
                )
        else:
            self._last = sig
            self.stalled_ticks = 0
