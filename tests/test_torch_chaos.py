"""The port's fleet under faults against the reference's, on the same
weights (``bridge.params_from_numpy``), in f32 on the CPU with
``timing="modeled"`` on a ``VirtualClock``, at the reference chaos tests'
settings (``tests/test_faults.py``: its three simulated end devices and
cloud, two cloud servers, two slots a lane, ``max_spill=1.0``, the exact
boundary), on dense smoke tinyllama at 4 layers.

Every case holds the fire log, the placement log, the replan events, every
``metrics()`` key (``per_device`` included), every request's tokens and its
submit, first-token and finish stamps (within 1e-9 s) equal to the
reference's, and every pool and the migration park drained.  Cases:

* a lane dies mid-decode at split 0, 1, 2 and R: its slots spill, wait in
  the park, and restore on a survivor at another split while a third
  lane's pages live in the one shared cloud storage; the dead lane's cloud
  pages go back to the shared pool and a survivor maps them again; tokens
  equal a run without the crash;
* ``defrag_kv`` between a crash and its recovery.

Migration with int8 KV pages: ``test_torch_chaos_quant.py``; link, transfer
and cloud faults: ``test_torch_chaos_faults.py``; the expert
registry under faults (smoke llama4-scout): ``test_torch_chaos_experts.py``;
a crash mid speculative round: ``test_torch_chaos_spec.py``; the seeded
sweep: ``test_torch_chaos_sweep.py``; ``serve_chaos``'s schedule:
``test_torch_chaos_serve.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import hardware as jhw
from repro.serving import faults as jfaults
from repro.serving import loadgen as jlg
from repro.serving.common import Request as JRequest
from repro.serving.common import VirtualClock as JClock
from repro.serving.fleet import FleetServingEngine as JFleet
from repro_torch.core import hardware as thw
from repro_torch.serving import FleetServingEngine, Request, VirtualClock
from repro_torch.serving import faults as tfaults
from repro_torch.serving import loadgen as tlg

from test_torch_fleet import bridge_pair

torch.set_num_threads(1)

FAULT_KEYS = ("lane_failures", "lane_recoveries", "migrations", "migration_restores",
              "migration_spill_bytes", "transfer_retries", "degraded_ticks", "link_blackout_s",
              "cloud_server_failures")


@pytest.fixture(scope="module")
def tiny_pair():
    return bridge_pair("tinyllama-1.1b", 4)


def END_PROFILES(hw):
    """The reference chaos tests' end devices and cloud."""
    return [hw.DeviceProfile("end-a", peak_gflops=8.0, mem_gb=16.0, mem_bw_gbs=100.0,
                             net_gbps=2.0),
            hw.DeviceProfile("end-b", peak_gflops=6.0, mem_gb=8.0, mem_bw_gbs=50.0,
                             net_gbps=1.0),
            hw.DeviceProfile("end-c", peak_gflops=4.0, mem_gb=8.0, mem_bw_gbs=50.0,
                             net_gbps=1.0)]


def CLOUD(hw):
    return hw.DeviceProfile("cloud-sim", peak_gflops=4.0, mem_gb=80.0, mem_bw_gbs=500.0,
                            net_gbps=2.0)


def side_mods(side):
    """(hardware, faults, loadgen, Request, VirtualClock, FleetServingEngine)."""
    if side == "jax":
        return jhw, jfaults, jlg, JRequest, JClock, JFleet
    return thw, tfaults, tlg, Request, VirtualClock, FleetServingEngine


def fleet_pair(side, pair, *, n_lanes=2, ends=None, cloud=None, **kw):
    """A fleet at the reference chaos tests' settings on one side; returns
    (fleet, that side's Request)."""
    (jm, jp), (tm, tp) = pair
    hw, _, _, R, Clock, Fleet = side_mods(side)
    jx = side == "jax"
    kw.setdefault("compression_rank", 0)
    kw.setdefault("max_len", 160)
    kw.setdefault("cloud_servers", 2)
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_spill", 1.0)
    fleet = Fleet(jm if jx else tm, jp if jx else tp,
                  end_profiles=ends(hw) if ends else END_PROFILES(hw)[:n_lanes],
                  cloud_profile=cloud(hw) if cloud else CLOUD(hw), timing="modeled",
                  clock=Clock(), **kw)
    return fleet, R


CLASSES = (dict(name="interactive", priority=0, weight=0.7, prompt_len=(4, 10),
                new_tokens=(2, 4)),
           dict(name="batch", priority=2, weight=0.3, prompt_len=(16, 40),
                new_tokens=(4, 8)))


def schedule(lg, n=30, rate=300.0, seed=5):
    """The reference chaos tests' seeded two-class schedule."""
    classes = tuple(lg.WorkloadClass(**c) for c in CLASSES)
    return lg.build_schedule(lg.poisson_arrivals(n, rate, seed), classes, seed=seed + 1)


def prompts_requests(R, lens=(12, 14, 9, 10, 13, 11), new=8, seed=42):
    rng = np.random.default_rng(seed)
    return [R(i, rng.integers(0, 500, size=n).astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lens)]


class Run:
    """One side's run: its fleet, requests, injector and the hook's notes."""

    def __init__(self, fleet, reqs, inj, notes):
        self.fleet, self.reqs, self.inj, self.notes = fleet, reqs, inj, notes
        self.tokens = {r.request_id: list(r.generated) for r in reqs}
        self.stamps = [(r.submit_time, r.first_token_time, r.finish_time) for r in reqs]


def run(side, pair, *, faults=(), requests=None, sched=None, hook=None, drive=False,
        max_ticks=3000, **kw):
    """Serve on one side: ``requests(R)`` submitted at once and ticked by
    hand (``hook(fleet, tick, notes)`` before each tick), or
    ``sched(loadgen)`` replayed by ``loadgen.drive``; ``faults`` are
    ``(t_s, kind, kwargs)`` events fired by a ``ChaosInjector``."""
    f, R = fleet_pair(side, pair, **kw)
    _, fm, lg, _, _, _ = side_mods(side)
    inj = None
    if faults:
        inj = fm.ChaosInjector(fm.FaultSchedule([fm.FaultEvent(t, k, **a)
                                                  for t, k, a in faults]), f)
    notes = {}
    if drive:
        reqs = lg.drive(f, sched(lg))
    else:
        reqs = requests(R) if requests is not None else [r for _, r in sched(lg)]
        for r in reqs:
            f.submit(r)
        for tick in range(max_ticks):
            if not f.busy():
                break
            if hook is not None:
                hook(f, tick, notes)
            f.step()
        else:
            raise AssertionError(f"the fleet did not drain in {max_ticks} ticks")
    return Run(f, reqs, inj, notes)


def both(pair, **kw):
    return run("jax", pair, **kw), run("torch", pair, **kw)


def assert_runs_equal(j, t):
    jf, tf = j.fleet, t.fleet
    assert t.tokens == j.tokens
    assert all(r.done and len(r.generated) > 0 for r in t.reqs)
    ids = [r.request_id for r in tf.finished]
    assert sorted(ids) == sorted(r.request_id for r in t.reqs) and len(ids) == len(set(ids))
    for a, b in zip(t.stamps, j.stamps):
        for x, y in zip(a, b):
            assert x == pytest.approx(y, abs=1e-9, rel=0)
    assert [r.n_migrations for r in t.reqs] == [r.n_migrations for r in j.reqs]
    assert [r.n_preemptions for r in t.reqs] == [r.n_preemptions for r in j.reqs]
    assert t.notes == j.notes
    if j.inj is not None:
        assert t.inj.fire_log() == j.inj.fire_log()
        assert t.inj.pending == j.inj.pending == 0
    assert tf.placed == jf.placed
    assert tf.replan_events == jf.replan_events
    jm_, tm_ = jf.metrics(), tf.metrics()
    assert set(tm_) == set(jm_)
    assert tm_ == jm_
    assert tf.lane_alive == jf.lane_alive
    for jl, tl in zip(jf.lanes, tf.lanes):
        assert (tl.link.bytes_up, tl.link.bytes_down, tl.link.bytes_peer, tl.link.transfers) == (
            jl.link.bytes_up, jl.link.bytes_down, jl.link.bytes_peer, jl.link.transfers)
        assert tl.end_pool.pages_in_use == 0
    assert tf.cloud_pool.pages_in_use == tf.cloud_pool.pages_reserved == 0
    assert not tf._migrating and not jf._migrating
    assert tf.timeline.busy_s == jf.timeline.busy_s
    assert tf.timeline.makespan_s == jf.timeline.makespan_s
    assert tf.clock() == pytest.approx(jf.clock(), abs=1e-9, rel=0)


def held_pages(f, i):
    """Pages of the shared cloud pool mapped to lane ``i``'s slots."""
    lane = f.lanes[i]
    return f.cloud_pool.mapped_for(range(lane._cloud_base, lane._cloud_base + lane.max_batch))


def lane_rows(f, i):
    lane = f.lanes[i]
    return f.cloud_pool.table[lane._cloud_base:lane._cloud_base + lane.max_batch]


def decoding(lane, n=2):
    return any(r is not None and len(r.generated) >= n for r in lane.slots)


def crash_when_loaded(victim, at_split_below_r=True, recover_after=None):
    """A hook that kills lane ``victim`` at the first tick it decodes while
    every other lane holds pages of the shared cloud pool, and notes what
    the crash saw; the physical cloud pages the dead lane held are then
    watched for a survivor mapping them again."""

    def hook(f, tick, notes):
        if "crash_tick" not in notes:
            others = [i for i in range(f.n_devices) if i != victim]
            held = [held_pages(f, i) for i in others]
            if decoding(f.lanes[victim]) and all(held):
                dead = lane_rows(f, victim)
                notes["crash_tick"] = tick
                notes["held"] = held
                notes["in_flight"] = sorted(r.request_id for r in f.lanes[victim].slots
                                            if r is not None)
                notes["dead_pages"] = sorted(int(p) for p in dead[dead >= 0])
                notes["reused"] = []
                f.fail_lane(victim)
                notes["parked"] = sorted(f._migrating)
                notes["after_crash"] = held_pages(f, victim)
        elif recover_after is not None and tick == notes["crash_tick"] + recover_after:
            f.recover_lane(victim)
        if "dead_pages" in notes:
            for i in range(f.n_devices):
                if i != victim:
                    rows = lane_rows(f, i)
                    notes["reused"] = sorted(set(notes["reused"]) | (
                        set(notes["dead_pages"]) & set(int(p) for p in rows[rows >= 0])))
    return hook


MIGRATION_SPLITS = {0: [0, 2, 1], 1: [1, 0, 3], 2: [2, 1, 3], 4: [4, 1, 2]}


@pytest.mark.parametrize("src", [0, 1, 2, 4], ids=["src0", "src1", "src2", "srcR"])
def test_migration_onto_another_split(tiny_pair, src):
    """Lane 0 dies mid-decode at split ``src``; the survivors sit at other
    splits (one at split 0 when the source is interior), and both hold
    pages of the shared cloud pool at the crash."""
    splits = MIGRATION_SPLITS[src]
    kw = dict(n_lanes=3, max_len=64, force_splits=splits, requests=prompts_requests)
    j, t = both(tiny_pair, hook=crash_when_loaded(0), **kw)
    assert_runs_equal(j, t)
    n = t.notes
    assert n["parked"] == n["in_flight"] and n["in_flight"] and n["after_crash"] == 0
    assert all(h > 0 for h in n["held"])
    assert n["reused"], "a survivor never mapped a page the dead lane gave back"
    m = t.fleet.metrics()
    assert m["lane_failures"] == 1 and m["migrations"] == len(n["in_flight"])
    assert m["migration_restores"] == m["migrations"] and m["migration_spill_bytes"] > 0
    by_req = {}
    for p in t.fleet.placed:
        by_req.setdefault(p["request_id"], []).append(p["device"])
    for rid in n["in_flight"]:
        req = next(r for r in t.reqs if r.request_id == rid)
        assert req.n_migrations == 1
        dest = by_req[rid][-1]
        assert dest != 0 and t.fleet.lanes[dest].split != src
    clean = run("torch", tiny_pair, **kw)
    assert clean.tokens == t.tokens  # faults move when tokens happen, not which


def test_defrag_between_crash_and_recovery(tiny_pair):
    """``defrag_kv`` compacts the shared pool while lane 0 is down (its
    parked spills hold no pages), then lane 0 comes back."""
    crash = crash_when_loaded(0, recover_after=12)

    def hook(f, tick, notes):
        crash(f, tick, notes)
        if "crash_tick" in notes and tick in (notes["crash_tick"] + 2, notes["crash_tick"] + 6):
            before = f.cloud_pool.table.copy()
            f.defrag_kv()
            mapped = f.cloud_pool.table[f.cloud_pool.table >= 0]
            notes.setdefault("compact", []).append(sorted(mapped.tolist())
                                                   == list(range(mapped.size)))
            notes.setdefault("moved", []).append(
                not np.array_equal(before, f.cloud_pool.table))

    kw = dict(n_lanes=3, max_len=64, force_splits=[1, 2, 3],
              requests=lambda R: prompts_requests(R, lens=(12, 14, 9, 10, 13, 11, 8, 15),
                                                  new=16))
    j, t = both(tiny_pair, hook=hook, **kw)
    assert_runs_equal(j, t)
    n = t.notes
    assert all(n["compact"]) and len(n["compact"]) == 2 and any(n["moved"])
    m = t.fleet.metrics()
    assert m["lane_failures"] == m["lane_recoveries"] == 1 and t.fleet.lane_alive[0]
    assert m["migration_restores"] == m["migrations"] >= 1
