"""The port's load generator (``serving/loadgen.py``) and modeled clock
against the reference's: the arrival processes and the schedule element
for element; ``drive`` refusing a wall clock; and ``drive`` through the
port's and the reference's fleets (two lanes over one shared cloud, both
lanes' cloud rows live at once) and standalone engines, in f32 on the CPU
with ``timing="modeled"`` on bridged weights, under priority admission with
preemption and under FIFO: every request's tokens and its submit,
first-token and finish stamps (within 1e-9 s), and the ``summarize()``
reports, per class and overall, equal.
"""

import numpy as np
import pytest
import torch

from repro.core import hardware as jhw
from repro.serving import loadgen as jlg
from repro.serving.common import Request as JRequest
from repro.serving.common import VirtualClock as JClock
from repro.serving.fleet import FleetServingEngine as JFleet
from repro.serving.stream import EndCloudServingEngine as JEngine
from repro_torch.core import hardware as thw
from repro_torch.serving import EndCloudServingEngine, FleetServingEngine, VirtualClock
from repro_torch.serving import loadgen as tlg
from repro_torch.serving.common import Request

from test_torch_fleet import bridge_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    return bridge_pair("tinyllama-1.1b", 2)


def classes(lg):
    return (
        lg.WorkloadClass("interactive", priority=0, weight=0.7, prompt_len=(4, 10),
                         new_tokens=(2, 4), ttft_slo_s=0.05),
        lg.WorkloadClass("batch", priority=2, weight=0.3, prompt_len=(16, 40),
                         new_tokens=(4, 8), tpot_slo_s=0.001),
    )


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_arrivals_and_schedules_equal_the_reference(seed):
    for n, rate in ((1, 3.0), (50, 5.0), (300, 120.0)):
        np.testing.assert_array_equal(tlg.poisson_arrivals(n, rate, seed),
                                      jlg.poisson_arrivals(n, rate, seed))
        np.testing.assert_array_equal(tlg.poisson_arrivals(n, rate, seed, start_s=2.5),
                                      jlg.poisson_arrivals(n, rate, seed, start_s=2.5))
        for bf, cyc in ((8.0, 4.0), (1.0, 1.0), (3.0, 0.5)):
            np.testing.assert_array_equal(
                tlg.bursty_arrivals(n, rate, seed, burst_factor=bf, cycle_s=cyc),
                jlg.bursty_arrivals(n, rate, seed, burst_factor=bf, cycle_s=cyc))
    arr = tlg.poisson_arrivals(120, 20.0, seed)
    for cls_t, cls_j, vocab in ((classes(tlg), classes(jlg), 500),
                                ((tlg.INTERACTIVE, tlg.BATCH), (jlg.INTERACTIVE, jlg.BATCH), 32000)):
        got = tlg.build_schedule(arr, cls_t, seed + 1, vocab=vocab)
        want = jlg.build_schedule(arr, cls_j, seed + 1, vocab=vocab)
        assert len(got) == len(want) == 120
        for (tt, rt), (tj, rj) in zip(got, want):
            assert tt == tj
            np.testing.assert_array_equal(rt.prompt, rj.prompt)
            assert rt.prompt.dtype == rj.prompt.dtype
            assert (rt.request_id, rt.max_new_tokens, rt.priority, rt.ttft_slo_s,
                    rt.tpot_slo_s) == (rj.request_id, rj.max_new_tokens, rj.priority,
                                       rj.ttft_slo_s, rj.tpot_slo_s)
    for bad in (lambda lg: lg.poisson_arrivals(3, 0.0, 0),
                lambda lg: lg.bursty_arrivals(3, 1.0, 0, burst_factor=0.5),
                lambda lg: lg.build_schedule(arr, (), 0)):
        for lg in (tlg, jlg):
            with pytest.raises(ValueError):
                bad(lg)


def test_drive_refuses_a_wall_clock(tiny):
    (_, (tm, tp)) = tiny
    eng = EndCloudServingEngine(tm, tp, end_profile=thw.PROFILES["a100"],
                                cloud_profile=thw.PROFILES["a100"], max_batch=2, max_len=64,
                                force_split=1, timing="modeled")
    with pytest.raises(ValueError, match="VirtualClock"):
        tlg.drive(eng, [])


def _drive(side, pair, kind, admission, seed):
    (jm, jp), (tm, tp) = pair
    jx = side == "jax"
    hw, lg = (jhw, jlg) if jx else (thw, tlg)
    clock = (JClock if jx else VirtualClock)()
    a100 = hw.PROFILES["a100"]
    kw = dict(max_batch=2, max_len=64, timing="modeled", clock=clock, admission=admission)
    if kind == "fleet":
        eng = (JFleet if jx else FleetServingEngine)(
            jm if jx else tm, jp if jx else tp, end_profiles=[a100, a100], cloud_profile=a100,
            cloud_servers=1, force_splits=[1, 2], **kw)
    else:
        eng = (JEngine if jx else EndCloudServingEngine)(
            jm if jx else tm, jp if jx else tp, end_profile=a100, cloud_profile=a100,
            force_split=1, **kw)
    eng.most_live = 0
    if kind == "fleet":
        step = eng.step

        def counted_step():  # the most lanes holding shared cloud pages at a tick
            out = step()
            eng.most_live = max(eng.most_live, sum(
                eng.cloud_pool.mapped_for(range(l._cloud_base, l._cloud_base + l.max_batch)) > 0
                for l in eng.lanes))
            return out

        eng.step = counted_step
    arr = lg.poisson_arrivals(16, 1e4, seed)  # oversubscribes two a100 lanes (modeled)
    sched = lg.build_schedule(arr, classes(lg), seed + 1)
    reqs = lg.drive(eng, sched)
    return reqs, eng, clock, lg


@pytest.mark.parametrize("kind", ["fleet", "standalone"])
@pytest.mark.parametrize("admission", ["priority", "fifo"])
def test_drive_equals_the_reference(tiny, kind, admission):
    (jr, jeng, jclock, _), (tr, teng, tclock, _) = (
        _drive(side, tiny, kind, admission, seed=3) for side in ("jax", "torch"))
    assert [r.generated for r in tr] == [r.generated for r in jr]
    for a, b in zip(tr, jr):
        for k in ("submit_time", "first_token_time", "finish_time"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), abs=1e-9, rel=0)
        assert (a.n_preemptions, a.seq) == (b.n_preemptions, b.seq)
    assert tclock.now == pytest.approx(jclock.now, abs=1e-9, rel=0)
    for kw in (dict(), dict(priority=0), dict(priority=2), dict(warmup_s=0.0008)):
        got, want = tlg.summarize(tr, **kw), jlg.summarize(jr, **kw)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-9, rel=1e-12), k
    s = tlg.summarize(tr)
    assert s["finished"] == 16 and s["dropped"] == 0
    assert 0 < tlg.summarize(tr, warmup_s=0.0008)["n"] < 16
    if admission == "priority":
        assert s["preemptions"] > 0  # the arrival rate oversubscribes the slots
    else:
        assert s["preemptions"] == 0
    if kind == "fleet":
        assert teng.placed == jeng.placed
        assert {ev["device"] for ev in teng.placed} == {0, 1}
        assert teng.cloud_pool.pages_in_use == 0 and teng.lanes[1]._cloud_base > 0
        assert teng.most_live == 2
        assert teng.metrics()["n_host_syncs"] == jeng.metrics()["n_host_syncs"]


def test_summarize_equals_the_reference():
    def reqs(R):
        out = []
        for i, (sub, first, fin, prio, n) in enumerate(
                [(0.0, 0.1, 1.0, 0, 4), (2.0, 2.2, 3.0, 0, 5), (2.5, 3.8, 4.0, 2, 3),
                 (3.0, None, None, 2, 0), (3.1, 3.3, 3.3, 0, 1)]):
            r = R(i, np.zeros(4, np.int32), priority=prio, ttft_slo_s=0.5, tpot_slo_s=0.1)
            r.submit_time, r.first_token_time, r.finish_time = sub, first, fin
            r.generated = list(range(n))
            out.append(r)
        return out

    for kw in (dict(), dict(warmup_s=1.0), dict(priority=0), dict(warmup_s=1.0, priority=2),
               dict(warmup_s=99.0)):
        assert tlg.summarize(reqs(Request), **kw) == jlg.summarize(reqs(JRequest), **kw)
