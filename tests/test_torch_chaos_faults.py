"""The port's fleet under link and cloud faults against the reference's
(``test_torch_chaos.py``'s harness and settings: smoke tinyllama at 4
layers in f32 on the CPU, ``timing="modeled"`` on a ``VirtualClock``;
fire log, placement log, replans, every metric, tokens and stamps equal,
pools and the migration park drained): a declared blackout drives a lane
to split 0 (the shared storage grows down under another lane's pages) and
its recovery unwinds it; a cloud server lost mid-run through the injector,
and the last one refused; transfer faults retried under backoff, and
exhausted ("presumed dead"); a fleet with every lane down raises a
livelock naming ``DOWN``.  (A crash mid speculative round:
``test_torch_chaos_spec.py``.)"""

import numpy as np
import pytest
import torch

from test_torch_chaos import (  # noqa: F401
    assert_runs_equal,
    both,
    fleet_pair,
    held_pages,
    run,
    schedule,
    tiny_pair,
)

torch.set_num_threads(1)


def test_blackout_drives_split_zero_and_recovers(tiny_pair):
    """A declared rate below the blackout floor pins lane 0 to split 0 at
    its next safe point (its blocks enter the shared storage below every
    other lane's split, while their pages live there); the declared
    recovery unwinds the pin through the ordinary replan path."""

    def hook(f, tick, notes):
        lane = f.lanes[0]
        if tick == 5:
            notes["nominal"] = lane.bw.gbps
            f.set_link_rate(0, lane.bw.gbps / 1000.0)
            notes["degraded"] = lane.link_degraded
            notes["base_before"] = f.cloud_kv.base if hasattr(f, "cloud_kv") else None
        elif "nominal" in notes and "zero_tick" not in notes and lane.split == 0:
            notes["zero_tick"] = tick
            notes["held"] = [held_pages(f, i) for i in range(f.n_devices)]
            f.set_link_rate(0, notes["nominal"])
            notes["recovered"] = not lane.link_degraded

    kw = dict(n_lanes=3, force_splits=[2, 1, 3], sched=lambda lg: schedule(lg, n=16))
    j, t = both(tiny_pair, hook=hook, **kw)
    j.notes.pop("base_before")
    base = t.notes.pop("base_before")
    assert_runs_equal(j, t)
    n, lane = t.notes, t.fleet.lanes[0]
    assert n["degraded"] and n["recovered"] and "zero_tick" in n
    assert any(h > 0 for h in n["held"][1:])
    assert base == 1 and t.fleet.cloud_kv.base == 0
    assert lane.degraded_ticks > 0 and lane.blackout_seconds() > 0
    assert lane.split > 0, "recovery must unwind the split-0 pin"
    moves = [(ev["old_split"], ev["new_split"]) for ev in t.fleet.replan_events
             if ev["device"] == 0]
    assert moves[0] == (2, 0) and moves[-1][0] == 0


def test_cloud_server_loss_and_the_last_server(tiny_pair):
    """A cloud server lost mid-run through the injector: the shared resource
    keeps one server, each lane's share of the cloud budget halves, and
    the shrunken fleet drains; the last server is refused alike."""
    kw = dict(n_lanes=2, sched=lambda lg: schedule(lg, n=12), drive=True,
              faults=[(0.01, "cloud_server_loss", {})])
    budgets = {}
    for side in ("jax", "torch"):
        f, _ = fleet_pair(side, tiny_pair, n_lanes=2)
        budgets[side] = f.lanes[0].tiers.cloud_cap.gflop_budget
    j, t = both(tiny_pair, **kw)
    assert_runs_equal(j, t)
    f = t.fleet
    assert f.cloud_servers == 1 and f.timeline.n_servers("cloud") == 1
    assert f.metrics()["cloud_server_failures"] == 1
    assert f.lanes[0].tiers.cloud_cap.gflop_budget == pytest.approx(budgets["torch"] / 2)
    assert t.inj.fire_log()[0]["t_fired_s"] >= 0.01
    msgs = []
    for fl in (j.fleet, f):
        with pytest.raises(RuntimeError, match="last cloud server") as info:
            fl.fail_cloud_server()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] and f.cloud_server_failures == 1


def test_transfer_faults_retry_with_backoff(tiny_pair):
    def arm(f, tick, notes):
        if tick == 0:
            f.inject_transfer_faults(0, 2)

    j, t = both(tiny_pair, n_lanes=2, hook=arm, sched=lambda lg: schedule(lg, n=6))
    assert_runs_equal(j, t)
    m = t.fleet.metrics()
    assert m["transfer_retries"] == 2 == m["per_device"][0]["transfer_retries"]
    # each retry crossed the wire again: one more metered upload each
    clean = run("torch", tiny_pair, n_lanes=2, sched=lambda lg: schedule(lg, n=6))
    assert clean.tokens == t.tokens
    assert t.fleet.lanes[0].link.transfers == clean.fleet.lanes[0].link.transfers + 2


def test_transfer_fault_exhaustion_raises(tiny_pair):
    msgs, meters = [], []
    for side in ("jax", "torch"):
        f, R = fleet_pair(side, tiny_pair, n_lanes=1)
        f.health.max_transfer_attempts = 3
        f.inject_transfer_faults(0, 50)
        f.submit(R(0, np.arange(6, dtype=np.int32), max_new_tokens=2))
        with pytest.raises(RuntimeError, match="presumed dead") as info:
            f.run()
        msgs.append(str(info.value))
        lane = f.lanes[0]
        meters.append((lane.link.transfers, lane.link.bytes_up, lane.transfer_retries,
                       lane._transfer_faults))
    assert msgs[0] == msgs[1] and meters[0] == meters[1]
    assert meters[1][2] == 2 and meters[1][3] == 47
    for side in ("jax", "torch"):
        f, _ = fleet_pair(side, tiny_pair, n_lanes=1)
        with pytest.raises(ValueError, match="count"):
            f.inject_transfer_faults(0, 0)


def test_dead_fleet_raises_instead_of_spinning(tiny_pair):
    msgs = []
    for side in ("jax", "torch"):
        f, R = fleet_pair(side, tiny_pair, n_lanes=2)
        f.fail_lane(0)
        f.fail_lane(1)
        f.fail_lane(1)  # a dead lane: no-op
        f.recover_lane(1)
        f.fail_lane(1)
        assert (f.lane_failures, f.lane_recoveries) == (3, 1)
        f.submit(R(0, np.arange(4, dtype=np.int32), max_new_tokens=2))
        f.stall_limit = 16
        with pytest.raises(RuntimeError, match="livelock.*DOWN") as info:
            f.run()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
