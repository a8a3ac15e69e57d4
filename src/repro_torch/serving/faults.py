"""Deterministic serving-side fault injection and the recovery policy (the
port's own copy of the reference's ``serving/faults.py``).

Every fault is an event on the engines' modeled clock, fired by a
:class:`ChaosInjector` the fleet engine ticks, so a chaos run is as
deterministic and replayable as a fault-free one: the same seed gives the
same fire log, placement log and tokens.

* :class:`FaultEvent` and :class:`FaultSchedule`: a validated, time-sorted
  list of timed events (lane crash and recovery, link blackout, severe
  degradation and recovery, cloud-server loss, peer-fetch failures, flaky
  boundary transfers), with the seeded :meth:`FaultSchedule.random`
  generator, which draws in the reference's order.
* :class:`ChaosInjector`: binds a schedule to a fleet engine and fires, at
  the top of every fleet tick, each event whose time has passed, through
  the fleet's recovery entry points (``fail_lane``, ``recover_lane``,
  ``set_link_rate``, ``fail_cloud_server``, ...), keeping a fire log.
* :class:`HealthMonitor`: heartbeats (``beat``, ``suspect``: what a
  failure detector would drive ``fail_lane`` from, beside the declared
  crashes), the attempt limit of a retried boundary transfer, and the
  bounded exponential backoff every retry follows
  (``backoff_s(attempt) = min(base * 2**attempt, cap)``).
* :class:`StallGuard`: N consecutive busy ticks with an unchanged progress
  signature raise with a queue and slot diagnostic instead of spinning.

Numpy only, no torch: the engines import this module, never the other way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "ChaosInjector",
    "FaultEvent",
    "FaultSchedule",
    "HealthMonitor",
    "StallGuard",
]

# The serving fault taxonomy:
#   lane_crash        an end device dies: its in-flight work migrates
#   lane_recover      a crashed device rejoins, empty and cold
#   link_blackout     a lane's uplink collapses below the usable floor
#   link_degrade      a lane's uplink drops severely but stays usable
#   link_recover      a lane's uplink returns to the given rate
#   cloud_server_loss one shared cloud server dies (capacity shrinks)
#   peer_fetch_fail   the next N peer slab fetches fail (re-sourced from the cloud)
#   transfer_flaky    the next N boundary transfers of a lane need resends
FAULT_KINDS = (
    "lane_crash",
    "lane_recover",
    "link_blackout",
    "link_degrade",
    "link_recover",
    "cloud_server_loss",
    "peer_fetch_fail",
    "transfer_flaky",
)

_LANE_KINDS = ("lane_crash", "lane_recover", "link_blackout", "link_degrade", "link_recover",
               "transfer_flaky")


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One timed fault; frozen and totally ordered, so schedules sort
    deterministically (ties broken by kind, then device)."""

    t_s: float  # fire time on the engines' modeled clock
    kind: str
    device: int = -1  # lane id of lane and link events; -1 = not applicable
    gbps: float = 0.0  # link events: the declared rate after the event
    count: int = 1  # peer_fetch_fail / transfer_flaky: injected failures

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.kind in _LANE_KINDS and self.device < 0:
            raise ValueError(f"{self.kind} event needs a device id")
        if self.kind in ("link_degrade", "link_recover") and self.gbps <= 0:
            raise ValueError(f"{self.kind} event needs a positive gbps")
        if self.count < 1:
            raise ValueError(f"count={self.count} must be >= 1")


class FaultSchedule:
    """A validated, time-sorted fault schedule; iterating yields the events
    in fire order.  A crash of a crashed lane, or a recovery of a live one,
    is refused here (the injector would silently no-op it)."""

    def __init__(self, events: Sequence[FaultEvent]):
        self.events: List[FaultEvent] = sorted(events)
        crashed: set = set()
        for ev in self.events:
            if ev.kind == "lane_crash":
                if ev.device in crashed:
                    raise ValueError(f"lane {ev.device} crashed twice without recovery")
                crashed.add(ev.device)
            elif ev.kind == "lane_recover":
                if ev.device not in crashed:
                    raise ValueError(f"lane {ev.device} recovered while alive")
                crashed.discard(ev.device)

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        horizon_s: float,
        n_lanes: int,
        nominal_gbps: float = 1.0,
        n_crashes: int = 1,
        n_blackouts: int = 1,
        n_degrades: int = 0,
        n_peer_faults: int = 0,
        n_transfer_faults: int = 0,
        cloud_losses: int = 0,
        recover_frac: Union[float, Sequence[float]] = (0.1, 0.3),
    ) -> "FaultSchedule":
        """Seeded random schedule over ``[0, horizon_s)``: crashes land in
        the first 60% of the horizon and recover ``recover_frac`` of it
        later; blackouts drop a lane's link to ``nominal/1000`` and recover
        to nominal; degrades drop it to 30% of nominal and recover.  Crashes
        need two lanes or more: with the only lane down nothing advances the
        modeled clock to the recovery."""
        if n_crashes > 0 and n_lanes < 2:
            raise ValueError("crash schedules need >= 2 lanes: with the only lane down "
                             "nothing advances the clock to the recovery event")
        rng = np.random.default_rng(seed)
        lo, hi = ((recover_frac, recover_frac) if np.isscalar(recover_frac)
                  else tuple(recover_frac))
        events: List[FaultEvent] = []

        def window(kind_down: str, kind_up: str, lane: int, **kw):
            t0 = float(rng.uniform(0.05, 0.6)) * horizon_s
            dt = float(rng.uniform(lo, hi)) * horizon_s
            events.append(FaultEvent(t0, kind_down, device=lane, **kw))
            up_kw = {"gbps": nominal_gbps} if kind_up == "link_recover" else {}
            events.append(FaultEvent(t0 + dt, kind_up, device=lane, **up_kw))

        # the draws in the reference's order: equal arguments, equal events
        for _ in range(n_crashes):
            window("lane_crash", "lane_recover", int(rng.integers(n_lanes)))
        for _ in range(n_blackouts):
            window("link_blackout", "link_recover", int(rng.integers(n_lanes)),
                   gbps=nominal_gbps / 1000.0)
        for _ in range(n_degrades):
            window("link_degrade", "link_recover", int(rng.integers(n_lanes)),
                   gbps=0.3 * nominal_gbps)
        for _ in range(n_peer_faults):
            events.append(FaultEvent(float(rng.uniform(0.05, 0.8)) * horizon_s,
                                     "peer_fetch_fail", count=int(rng.integers(1, 4))))
        for _ in range(n_transfer_faults):
            events.append(FaultEvent(float(rng.uniform(0.05, 0.8)) * horizon_s,
                                     "transfer_flaky", device=int(rng.integers(n_lanes)),
                                     count=int(rng.integers(1, 3))))
        for _ in range(cloud_losses):
            events.append(FaultEvent(float(rng.uniform(0.05, 0.8)) * horizon_s,
                                     "cloud_server_loss"))
        return cls(events)


class ChaosInjector:
    """Fires a :class:`FaultSchedule` against a fleet engine on its clock.

    ``bind(engine)`` attaches the injector (the fleet ticks it at the top of
    every ``step``); ``tick`` fires, in order, every event not fired yet
    whose ``t_s`` has passed on ``engine.clock``, so an event fires at the
    first tick at or past its time (``t_fired_s``).  An event whose lane is
    already in the requested state no-ops in the engine but still lands in
    the fire log, the determinism witness runs are compared on."""

    def __init__(self, schedule: FaultSchedule, engine=None):
        self.schedule = schedule
        self.engine = None
        self._next = 0
        self.fired: List[Dict] = []
        if engine is not None:
            self.bind(engine)

    def bind(self, engine) -> "ChaosInjector":
        self.engine = engine
        engine.chaos = self
        return self

    @property
    def pending(self) -> int:
        return len(self.schedule.events) - self._next

    def tick(self):
        if self.engine is None:
            raise RuntimeError("ChaosInjector.tick before bind(engine)")
        now = self.engine.clock()
        while self._next < len(self.schedule.events):
            ev = self.schedule.events[self._next]
            if ev.t_s > now:
                break
            self._next += 1
            self._fire(ev, now)

    def _fire(self, ev: FaultEvent, now: float):
        eng = self.engine
        if ev.kind == "lane_crash":
            eng.fail_lane(ev.device)
        elif ev.kind == "lane_recover":
            eng.recover_lane(ev.device)
        elif ev.kind in ("link_blackout", "link_degrade", "link_recover"):
            # a blackout without a declared rate collapses to ~zero (the
            # floor keeps modeled wire times finite)
            eng.set_link_rate(ev.device, ev.gbps if ev.gbps > 0 else 1e-4)
        elif ev.kind == "cloud_server_loss":
            eng.fail_cloud_server()
        elif ev.kind == "peer_fetch_fail":
            eng.inject_peer_faults(ev.count)
        elif ev.kind == "transfer_flaky":
            eng.inject_transfer_faults(ev.device, ev.count)
        self.fired.append({"t_s": ev.t_s, "t_fired_s": now, "kind": ev.kind,
                           "device": ev.device, "gbps": ev.gbps, "count": ev.count})

    def fire_log(self) -> List[Dict]:
        """The fired events in fire order (a copy)."""
        return [dict(d) for d in self.fired]


class HealthMonitor:
    """Fleet health bookkeeping and the shared retry policy.

    Heartbeats: the fleet beats every live lane each tick on the modeled
    clock; ``suspect`` flags a lane whose last beat is older than
    ``heartbeat_timeout_s`` (the chaos injector declares crashes directly,
    so declared and detected failures can be compared).  Backoff: a
    retried transfer (a flaky boundary upload, a failed peer slab fetch)
    idles ``backoff_s(attempt)`` before resending, capped at
    ``backoff_cap_s``; ``max_transfer_attempts`` bounds a boundary upload's
    attempts, and exhausting them raises."""

    def __init__(self, *, heartbeat_timeout_s: float = 1.0, backoff_base_s: float = 0.01,
                 backoff_cap_s: float = 0.25, max_transfer_attempts: int = 5):
        if max_transfer_attempts < 1:
            raise ValueError("max_transfer_attempts must be >= 1")
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.max_transfer_attempts = max_transfer_attempts
        self._last_beat: Dict[str, float] = {}

    def beat(self, name: str, now: float):
        self._last_beat[name] = now

    def last_beat(self, name: str) -> Optional[float]:
        return self._last_beat.get(name)

    def suspect(self, name: str, now: float) -> bool:
        """True when ``name`` has been seen but is past its heartbeat
        timeout (an unseen name is unknown, not suspect)."""
        last = self._last_beat.get(name)
        return last is not None and now - last > self.heartbeat_timeout_s

    def suspects(self, now: float) -> List[str]:
        return [n for n in self._last_beat if self.suspect(n, now)]

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
