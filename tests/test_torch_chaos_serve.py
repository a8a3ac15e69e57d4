"""``benchmarks/serve_chaos.py``'s declared schedule on the port against
the reference (``test_torch_chaos.py``'s harness: smoke tinyllama at 4
layers in f32 on the CPU, ``timing="modeled"`` on a ``VirtualClock``):
its lanes (the first three ``FLEET_PROFILES``) forced to splits 1, 2 and 3,
its trace's classes, and its faults timed against the trace's horizon
(flaky transfers on lane 0, lane 1's crash and recovery, a blackout window
on lane 0), replayed by ``loadgen.drive``.  The trace is 64 requests at
150/s (the benchmark's 600 at 800/s is cut so that the crash and the
recovery land on different ticks of the modeled clock at this depth).
Fire log, placement log, replans, every metric, tokens and stamps equal
the reference's; a second port run repeats the first exactly (per-seed
determinism); chaos tokens equal clean ones; and the interactive class's
p99 TTFT stays within the clean one plus the fault window and the
benchmark's slack.
"""

import dataclasses

import torch

from benchmarks.fleet_throughput import FLEET_PROFILES
from benchmarks.serve_chaos import _fault_schedule as serve_chaos_faults
from repro.serving import loadgen as jlg
from repro_torch.serving import loadgen as tlg

from test_torch_chaos import FAULT_KEYS, assert_runs_equal, run, tiny_pair  # noqa: F401

torch.set_num_threads(1)

LANES = dict(n_lanes=3, force_splits=[1, 2, 3], drive=True)


def serve_chaos_ends(hw):
    """``serve_chaos``'s lanes: the first three ``FLEET_PROFILES``."""
    return [hw.DeviceProfile(**dataclasses.asdict(p)) for p in FLEET_PROFILES[:3]]


def serve_chaos(pair, side, chaos, n=64, rate=150.0):
    """``serve_chaos``'s trace (Poisson arrivals, seed 0, its interactive
    class with a 0.2 s TTFT target beside the batch class) on one side,
    with its declared schedule when ``chaos``."""

    def sched(lg):
        arr = lg.poisson_arrivals(n, rate, 0)
        return lg.build_schedule(arr, (dataclasses.replace(lg.INTERACTIVE, ttft_slo_s=0.2),
                                       lg.BATCH), 1)

    faults = ()
    if chaos:
        horizon = float(jlg.poisson_arrivals(n, rate, 0)[-1])
        faults = [(e.t_s, e.kind, dict(device=e.device, gbps=e.gbps, count=e.count))
                  for e in serve_chaos_faults(horizon, 3)]
    return run(side, pair, sched=sched, faults=faults, ends=serve_chaos_ends, **LANES)


def test_serve_chaos_schedule_twice(tiny_pair):
    j = serve_chaos(tiny_pair, "jax", True)
    t1 = serve_chaos(tiny_pair, "torch", True)
    assert_runs_equal(j, t1)
    t2 = serve_chaos(tiny_pair, "torch", True)
    assert_runs_equal(t1, t2)  # per-seed determinism
    clean = serve_chaos(tiny_pair, "torch", False)
    assert clean.tokens == t1.tokens
    m = t1.fleet.metrics()
    assert m["lane_failures"] == m["lane_recoveries"] == 1
    assert m["migration_restores"] == m["migrations"] >= 1 and m["migration_spill_bytes"] > 0
    assert m["transfer_retries"] == 3 and m["degraded_ticks"] > 0 and m["link_blackout_s"] > 0
    assert {k: m[k] for k in FAULT_KEYS} == {k: t2.fleet.metrics()[k] for k in FAULT_KEYS}
    # serve_chaos's bound: a faulted request waits one outage window at most
    fired = {(d["kind"], d["device"]): d["t_fired_s"] for d in t1.inj.fire_log()}
    window = fired[("lane_recover", 1)] - fired[("lane_crash", 1)] + m["link_blackout_s"]
    p99 = [tlg.summarize(r.reqs, priority=0)["ttft_p99"] for r in (clean, t1)]
    assert p99[1] <= p99[0] + window + 0.05
