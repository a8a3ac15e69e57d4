"""The port's fault pieces against the reference's, one by one: the event
and schedule validation (the same messages), ``FaultSchedule.random`` event
for event, the injector's dispatch and fire log, the health monitor's
backoff and heartbeats (a crashed lane's beats stop and ``suspects`` names
it on the modeled clock at the same tick as the reference's),
``StageTimeline.remove_server`` (bookings after it equal, the last-server
guard), ``ExpertSlabPool.free_layer``, and the registry's dead-holder and
peer-fault counts.  (The fleet under faults: ``test_torch_chaos.py``.)"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import expertpool as jexp
from repro.serving import faults as jfaults
from repro.serving.common import StageTimeline as JTimeline
from repro_torch.core import expertpool as texp
from repro_torch.serving import faults as tfaults
from repro_torch.serving.common import StageTimeline as TTimeline

from test_torch_chaos import fleet_pair, tiny_pair  # noqa: F401

torch.set_num_threads(1)

SIDES = ((jfaults, "jax"), (tfaults, "torch"))


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("args,kw", [
    ((0.1, "meteor_strike"), {}),
    ((0.1, "lane_crash"), {}),
    ((0.1, "transfer_flaky"), dict(count=2)),
    ((0.1, "link_recover"), dict(device=0)),
    ((0.1, "link_degrade"), dict(device=1, gbps=-1.0)),
    ((0.1, "peer_fetch_fail"), dict(count=0)),
], ids=["kind", "device", "flaky-device", "recover-gbps", "degrade-gbps", "count"])
def test_fault_event_validation(args, kw):
    want = _raised(lambda: jfaults.FaultEvent(*args, **kw))
    assert _raised(lambda: tfaults.FaultEvent(*args, **kw)) == want
    assert want[0] == "ValueError"


def test_fault_event_order_and_fields():
    evs = [(0.5, "lane_recover", 0), (0.1, "lane_crash", 0), (0.1, "cloud_server_loss", -1),
           (0.1, "link_blackout", 2), (0.1, "link_blackout", 1)]
    got = [dataclasses.astuple(e) for e in sorted(tfaults.FaultEvent(t, k, device=d)
                                                 for t, k, d in evs)]
    want = [dataclasses.astuple(e) for e in sorted(jfaults.FaultEvent(t, k, device=d)
                                                  for t, k, d in evs)]
    assert got == want
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    with pytest.raises(dataclasses.FrozenInstanceError):
        tfaults.FaultEvent(0.1, "lane_crash", device=0).t_s = 0.2


def test_fault_schedule_sorts_and_validates():
    for mod, _ in SIDES:
        sched = mod.FaultSchedule([mod.FaultEvent(0.5, "lane_recover", device=0),
                                   mod.FaultEvent(0.1, "lane_crash", device=0)])
        assert [e.kind for e in sched] == ["lane_crash", "lane_recover"] and len(sched) == 2
    for bad in (lambda m: [m.FaultEvent(0.1, "lane_crash", device=0),
                           m.FaultEvent(0.2, "lane_crash", device=0)],
                lambda m: [m.FaultEvent(0.1, "lane_recover", device=0)],
                lambda m: [m.FaultEvent(0.1, "lane_crash", device=1),
                           m.FaultEvent(0.2, "lane_recover", device=1),
                           m.FaultEvent(0.3, "lane_recover", device=1)]):
        want = _raised(lambda: jfaults.FaultSchedule(bad(jfaults)))
        assert _raised(lambda: tfaults.FaultSchedule(bad(tfaults))) == want


@pytest.mark.parametrize("seed", [0, 7, 8, 123])
@pytest.mark.parametrize("kw", [
    dict(horizon_s=1.0, n_lanes=3, n_blackouts=2),
    dict(horizon_s=0.37, n_lanes=2, nominal_gbps=2.0, n_crashes=1, n_blackouts=1,
         n_transfer_faults=1),
    dict(horizon_s=5.0, n_lanes=4, n_crashes=2, n_blackouts=0, n_degrades=2, n_peer_faults=3,
         n_transfer_faults=2, cloud_losses=1, recover_frac=0.2),
    dict(horizon_s=1.0, n_lanes=1, n_crashes=0, n_blackouts=1, recover_frac=(0.05, 0.5)),
], ids=["blackouts", "serve-chaos-sweep", "every-kind", "one-lane"])
def test_random_schedule_equals_the_reference(seed, kw):
    got = tfaults.FaultSchedule.random(seed, **kw).events
    want = jfaults.FaultSchedule.random(seed, **kw).events
    assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
    assert got == tfaults.FaultSchedule.random(seed, **kw).events


def test_random_schedule_guard():
    want = _raised(lambda: jfaults.FaultSchedule.random(0, horizon_s=1.0, n_lanes=1,
                                                        n_crashes=1))
    assert _raised(lambda: tfaults.FaultSchedule.random(0, horizon_s=1.0, n_lanes=1,
                                                        n_crashes=1)) == want
    assert ">= 2 lanes" in want[1]


class _Recorder:
    """A stand-in fleet: a settable clock and the recovery entry points,
    each recording its call."""

    def __init__(self):
        self.now = 0.0
        self.calls = []
        self.chaos = None

    def clock(self):
        return self.now

    def __getattr__(self, name):
        if name.startswith(("fail_", "recover_", "set_", "inject_")):
            return lambda *a: self.calls.append((name, a))
        raise AttributeError(name)


def test_injector_fires_like_the_reference():
    def events(m):
        return m.FaultSchedule([
            m.FaultEvent(0.0, "transfer_flaky", device=0, count=3),
            m.FaultEvent(0.02, "lane_crash", device=1),
            m.FaultEvent(0.02, "peer_fetch_fail", count=2),
            m.FaultEvent(0.05, "link_blackout", device=0),
            m.FaultEvent(0.06, "link_degrade", device=2, gbps=0.3),
            m.FaultEvent(0.25, "link_recover", device=0, gbps=2.0),
            m.FaultEvent(0.30, "lane_recover", device=1),
            m.FaultEvent(0.31, "cloud_server_loss"),
        ])

    out = []
    for mod, _ in SIDES:
        eng = _Recorder()
        inj = mod.ChaosInjector(events(mod))
        with pytest.raises(RuntimeError, match="before bind"):
            inj.tick()
        inj.bind(eng)
        assert eng.chaos is inj
        pend = []
        for now in (0.0, 0.01, 0.03, 0.03, 0.2, 0.5):
            eng.now = now
            inj.tick()
            pend.append(inj.pending)
        out.append((eng.calls, inj.fire_log(), pend))
    assert out[0] == out[1]
    calls, log, pend = out[1]
    assert pend[-1] == 0 and log[1]["t_fired_s"] == 0.03 and log[1]["t_s"] == 0.02
    assert ("set_link_rate", (0, 1e-4)) in calls  # a blackout without a rate


def test_backoff_bounded_exponential():
    for mod, _ in SIDES:
        h = mod.HealthMonitor(backoff_base_s=0.01, backoff_cap_s=0.25)
        delays = [h.backoff_s(a) for a in range(-1, 12)]
        assert delays == [jfaults.HealthMonitor(backoff_base_s=0.01,
                                                backoff_cap_s=0.25).backoff_s(a)
                          for a in range(-1, 12)]
        assert delays[1] == pytest.approx(0.01) and max(delays) == pytest.approx(0.25)
        assert h.max_transfer_attempts == 5 and h.heartbeat_timeout_s == 1.0
    for mod, _ in SIDES:
        with pytest.raises(ValueError, match="max_transfer_attempts"):
            mod.HealthMonitor(max_transfer_attempts=0)


def test_heartbeat_suspects():
    for mod, _ in SIDES:
        h = mod.HealthMonitor(heartbeat_timeout_s=0.5)
        h.beat("lane0", 1.0)
        h.beat("lane1", 1.4)
        assert h.last_beat("lane1") == 1.4 and h.last_beat("lane9") is None
        assert not h.suspect("lane0", 1.4) and not h.suspect("lane0", 1.5)
        assert h.suspect("lane0", 1.6)
        assert h.suspects(1.6) == ["lane0"] and h.suspects(2.0) == ["lane0", "lane1"]
        assert not h.suspect("never-seen", 99.0)


def test_crashed_lane_turns_suspect_on_the_modeled_clock(tiny_pair):
    """A crashed lane stops beating: ``suspects(now)`` names it once the
    timeout has passed on the modeled clock, at the same tick as the
    reference's, while the live lanes (beaten each tick) never are, and a
    recovery beats it again at once."""
    views = []
    for side in ("jax", "torch"):
        f, R = fleet_pair(side, tiny_pair, n_lanes=3)
        f.health.heartbeat_timeout_s = 0.01  # above a tick's modeled advance here
        rng = np.random.default_rng(3)
        for i in range(6):
            f.submit(R(i, rng.integers(0, 500, size=10).astype(np.int32), max_new_tokens=16))
        view = []
        for tick in range(200):
            if not f.busy():
                break
            if tick == 3:
                f.fail_lane(0)
            if tick == 15:
                f.recover_lane(0)
            f.step()
            now = f.clock()
            view.append((now, f.health.suspects(now), [f.health.last_beat(f"lane{i}")
                                                       for i in range(3)]))
        views.append(view)
    assert views[0] == views[1]
    named = [i for i, (_, s, _) in enumerate(views[1]) if s]
    assert len(views[1]) > 16 and named and min(named) > 3 and max(named) < 15
    assert all(views[1][i][1] == ["lane0"] for i in named)
    assert all(last[0] == views[1][2][2][0] for _, _, last in views[1][3:15])  # no beats
    assert views[1][15][2][0] > views[1][14][2][0]  # beaten at its recovery


def test_remove_server_equals_the_reference():
    rng = np.random.default_rng(0)
    jobs = [(float(rng.uniform(0, 2)), float(rng.uniform(0.01, 0.5))) for _ in range(40)]
    out = []
    for T in (JTimeline, TTimeline):
        tl = T(["cloud", "end"], capacity={"cloud": 3})
        ends = [tl.occupy("cloud", r, s) for r, s in jobs[:20]]
        busy, span = dict(tl.busy_s), tl.makespan_s
        tl.remove_server("cloud")
        assert tl.n_servers("cloud") == 2
        assert (dict(tl.busy_s), tl.makespan_s) == (busy, span)  # booked work stays
        ends += [tl.occupy("cloud", r, s) for r, s in jobs[20:]]
        tl.remove_server("cloud")
        ends += [tl.occupy("cloud", r, s) for r, s in jobs[:5]]
        guard = _raised(lambda: tl.remove_server("cloud"))
        guard_end = _raised(lambda: tl.remove_server("end"))
        out.append((ends, dict(tl.busy_s), tl.makespan_s, tl.free_at, tl.n_servers("cloud"),
                    guard, guard_end))
    assert out[0] == out[1]
    assert out[1][5][0] == "ValueError" and "single server" in out[1][5][1]


def test_free_layer_equals_the_reference():
    out = []
    for mod in (jexp, texp):
        pool = mod.ExpertSlabPool(10, 3, 6, max_per_layer=4)
        for lid, e in ((0, 1), (1, 2), (0, 4), (2, 0), (0, 5), (1, 3)):
            pool.alloc(lid, e)
        freed = pool.free_layer(0)
        again = pool.free_layer(0)
        after = [pool.alloc(0, e) for e in (2, 3)]
        out.append((freed, again, after, pool.table.tolist(), pool.slabs_in_use))
    assert out[0] == out[1]
    assert out[1][1] == [] and len(out[1][0]) == 3


def test_registry_dead_holder_and_peer_faults():
    out = []
    for mod in (jexp, texp):
        reg = mod.FleetExpertRegistry(2, 4, 1024, lan_gbps=10.0)
        pools = [mod.ExpertSlabPool(8, 2, 4, max_per_layer=4) for _ in range(3)]
        for p in pools:
            reg.register_lane(p, link_gbps=lambda: 1.0, book_link=lambda r, s: r + s)
        pools[0].alloc(0, 1)
        pools[1].alloc(0, 1)
        pools[2].alloc(1, 3)
        rec = [sorted(reg.holders(0, 1)), reg.pick_source(1, 0, 1)]
        reg.set_lane_alive(0, False)
        rec += [reg.holders(0, 1), reg.pick_source(1, 0, 1), reg.pick_source(2, 0, 1),
                reg.total_residents(), reg.unique_residents(), reg.lane_alive(0)]
        reg.set_lane_alive(0, True)
        rec += [sorted(reg.holders(0, 1)), reg.total_residents()]
        with pytest.raises(ValueError):
            reg.inject_peer_faults(0)
        reg.inject_peer_faults(2)
        reg.inject_peer_faults(1)
        rec += [[reg.take_peer_fault() for _ in range(5)], reg.peer_fault_fallbacks]
        out.append(rec)
    assert out[0] == out[1]
    rec = out[1]
    assert rec[1][0] == 0 and rec[3][0] is None and rec[4][0] == 1  # never the corpse
    assert rec[-2] == [True, True, True, False, False] and rec[-1] == 3
