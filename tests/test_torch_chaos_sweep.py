"""The reference's randomized chaos sweep (``tests/test_faults.py``) on
the port and the reference side by side (``test_torch_chaos.py``'s
harness: smoke tinyllama at 4 layers in f32 on the CPU,
``timing="modeled"`` on a ``VirtualClock``), three lanes forced to splits
1, 2 and 3 so that a lane's migrated slots restore at another split while
the third lane's pages live in the shared cloud storage: a seeded
``FaultSchedule.random`` of crashes, blackouts and flaky transfers over a
seeded schedule, replayed by ``loadgen.drive``.  Fire log, placement log,
replans, every metric, tokens and stamps equal the reference's; every
request finishes exactly once with the tokens of the run without faults,
and every event fires.  (``serve_chaos``'s declared schedule:
``test_torch_chaos_serve.py``.)
"""

import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, st

from repro.serving import faults as jfaults
from repro.serving import loadgen as jlg

from test_torch_chaos import (  # noqa: F401
    assert_runs_equal,
    both,
    run,
    schedule,
    tiny_pair,
)

torch.set_num_threads(1)

LANES = dict(n_lanes=3, force_splits=[1, 2, 3], drive=True)


@settings(max_examples=3, deadline=None, derandomize=True)
@given(seed=st.integers(min_value=0, max_value=4), n_blackouts=st.integers(0, 1),
       n_crashes=st.integers(0, 1))
def test_random_chaos_equals_the_reference(tiny_pair, seed, n_blackouts, n_crashes):
    sched = lambda lg: schedule(lg, n=24, rate=400.0, seed=seed)  # noqa: E731
    horizon = max(t for t, _ in sched(jlg))
    fs = jfaults.FaultSchedule.random(
        seed + 100, horizon_s=max(horizon, 0.05), n_lanes=3, nominal_gbps=2.0,
        n_crashes=n_crashes, n_blackouts=n_blackouts, n_transfer_faults=1)
    faults = [(e.t_s, e.kind, dict(device=e.device, gbps=e.gbps, count=e.count))
              for e in fs]
    j, t = both(tiny_pair, sched=sched, faults=faults, **LANES)
    assert_runs_equal(j, t)
    clean = run("torch", tiny_pair, sched=sched, **LANES)
    assert clean.tokens == t.tokens, "greedy tokens diverged under chaos"
    m = t.fleet.metrics()
    assert m["migration_restores"] == m["migrations"]
    assert len(t.inj.fire_log()) == len(fs)
