"""Seeded load generator and its modeled-clock ``drive`` loop for the
serving engines (the port's own copy of the reference's
``serving/loadgen.py``).

The MLPerf-style harness the scaling claims are measured with: a seeded
arrival process (Poisson or bursty/Markov-modulated), a mixed workload of
SLO classes (prompt/output-length distributions + priority + latency
targets), and a loop (``drive``) that releases requests into an engine as modeled
time passes their arrival stamps.  Everything is deterministic given the
seed: identical seeds reproduce identical arrival traces, identical token
streams (greedy decode on a deterministic schedule), and therefore
identical percentile metrics.

``drive`` runs on the engine's :class:`~repro_torch.serving.common.VirtualClock`
(``timing="modeled"`` engines recommended): per-request TTFT/TPOT are
stamped on the same ``StageTimeline`` axis the schedule is computed on, so
the reported p50/p90/p99 and sustained tok/s are properties of the modeled
deployment, not of this host's wall clock.

Works against any slot engine exposing ``submit / step / busy / timeline /
clock`` — ``EndCloudServingEngine`` and ``FleetServingEngine`` both do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.common import Request, VirtualClock
from repro_torch.serving.faults import StallGuard

__all__ = [
    "WorkloadClass",
    "INTERACTIVE",
    "BATCH",
    "poisson_arrivals",
    "bursty_arrivals",
    "build_schedule",
    "drive",
    "summarize",
]


# ---------------------------------------------------------------------------
# Workload classes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkloadClass:
    """One SLO class of a mixed workload.

    ``weight`` is the class's share of arrivals; prompt/output lengths are
    drawn uniformly from the inclusive ranges.  ``priority`` is the
    admission class (0 admits first); the SLO targets ride on each
    generated :class:`Request` for scoring."""

    name: str
    priority: int
    weight: float
    prompt_len: Tuple[int, int]
    new_tokens: Tuple[int, int]
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None


# The default mix: mostly short interactive traffic, a tail of long
# low-priority batch requests — the head-of-line shape priority admission
# and preemption exist to survive.
INTERACTIVE = WorkloadClass(
    "interactive", priority=0, weight=0.8,
    prompt_len=(4, 16), new_tokens=(2, 6),
)
BATCH = WorkloadClass(
    "batch", priority=2, weight=0.2,
    prompt_len=(40, 90), new_tokens=(8, 24),
)


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------


def poisson_arrivals(n: int, rate_rps: float, seed: int,
                     start_s: float = 0.0) -> np.ndarray:
    """``n`` arrival times of a homogeneous Poisson process at ``rate_rps``
    requests/second (i.i.d. exponential inter-arrivals), sorted ascending.
    Deterministic given the seed."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps={rate_rps}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return start_s + np.cumsum(gaps)

def bursty_arrivals(n: int, rate_rps: float, seed: int,
                    burst_factor: float = 8.0, cycle_s: float = 4.0,
                    start_s: float = 0.0) -> np.ndarray:
    """``n`` arrivals of a Markov-modulated (ON/OFF) process: exponential
    ON periods at ``rate_rps * burst_factor``, exponential OFF periods with
    no arrivals, duty cycle ``1/burst_factor`` — so the long-run mean rate
    is ``rate_rps`` but the traffic lands in bursts.  ``cycle_s`` is the
    mean ON+OFF period length.  Deterministic given the seed."""
    if rate_rps <= 0 or burst_factor < 1.0:
        raise ValueError(f"rate_rps={rate_rps}, burst_factor={burst_factor}")
    rng = np.random.default_rng(seed)
    mean_on = cycle_s / burst_factor
    mean_off = cycle_s - mean_on
    on_rate = rate_rps * burst_factor
    out: List[float] = []
    t = start_s
    while len(out) < n:
        on_end = t + rng.exponential(mean_on)
        tt = t + rng.exponential(1.0 / on_rate)
        while tt < on_end and len(out) < n:
            out.append(tt)
            tt += rng.exponential(1.0 / on_rate)
        t = on_end + (rng.exponential(mean_off) if mean_off > 0 else 0.0)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# Schedule synthesis
# ---------------------------------------------------------------------------


def build_schedule(
    arrivals: np.ndarray,
    classes: Sequence[WorkloadClass],
    seed: int,
    vocab: int = 500,
) -> List[Tuple[float, Request]]:
    """Attach one synthetic request per arrival time: class drawn by
    weight, prompt tokens and output budget drawn from the class's ranges —
    all from one seeded stream, so identical seeds reproduce identical
    schedules token-for-token.  Returns ``[(arrival_s, Request), ...]``
    with ``request_id`` in arrival order."""
    if not classes:
        raise ValueError("need at least one workload class")
    rng = np.random.default_rng(seed)
    w = np.asarray([c.weight for c in classes], np.float64)
    if (w <= 0).any():
        raise ValueError("class weights must be positive")
    w = w / w.sum()
    idx = rng.choice(len(classes), size=len(arrivals), p=w)
    schedule: List[Tuple[float, Request]] = []
    for i, (t, ci) in enumerate(zip(arrivals, idx)):
        c = classes[int(ci)]
        s = int(rng.integers(c.prompt_len[0], c.prompt_len[1] + 1))
        m = int(rng.integers(c.new_tokens[0], c.new_tokens[1] + 1))
        prompt = rng.integers(0, vocab, size=s).astype(np.int32)
        schedule.append(
            (
                float(t),
                Request(
                    request_id=i,
                    prompt=prompt,
                    max_new_tokens=m,
                    priority=c.priority,
                    ttft_slo_s=c.ttft_slo_s,
                    tpot_slo_s=c.tpot_slo_s,
                ),
            )
        )
    return schedule


# ---------------------------------------------------------------------------
# Driving an engine
# ---------------------------------------------------------------------------


def drive(engine, schedule: Sequence[Tuple[float, Request]],
          max_ticks: int = 1_000_000) -> List[Request]:
    """Replay a schedule through an engine on its virtual clock.

    Each tick: submit every request whose arrival time has passed (batched
    submission — a burst lands in one tick), advance the engine one step,
    then move the clock to the timeline makespan.  When the engine drains
    before the next arrival, the clock jumps straight to it (idle modeled
    time costs nothing to simulate).  Returns the schedule's requests.

    A stall guard (``serving.faults.StallGuard``) watches the engine's
    progress signature *and* the clock: modeled time advancing counts as
    progress (a slowly-draining degraded lane is not a livelock), but a
    frozen clock with a wedged engine raises loudly with the engine's
    queue/slot diagnostic instead of spinning to ``max_ticks``.
    """
    clock = engine.clock
    if not isinstance(clock, VirtualClock):
        raise ValueError(
            "drive() needs an engine built with clock=VirtualClock() — "
            "wall-clock request stamps cannot meet a modeled schedule"
        )
    schedule = sorted(schedule, key=lambda p: p[0])
    guard = StallGuard(getattr(engine, "stall_limit", 500))
    i = 0
    for _tick in range(max_ticks):
        if i >= len(schedule) and not engine.busy():
            break
        if not engine.busy() and i < len(schedule):
            clock.advance_to(schedule[i][0])
        while i < len(schedule) and schedule[i][0] <= clock.now:
            t, req = schedule[i]
            engine.submit(req)
            req.submit_time = t  # exact arrival, not the release tick
            i += 1
        engine.step()
        clock.advance_to(engine.timeline.makespan_s)
        guard.note(
            (i, clock.now) + engine._progress_sig(), engine.stall_diagnostic
        )
    else:
        raise RuntimeError(f"drive() hit max_ticks={max_ticks}")
    return [req for _, req in schedule]


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def summarize(requests: Sequence[Request], warmup_s: float = 0.0,
              priority: Optional[int] = None) -> Dict[str, float]:
    """Latency/throughput report over a driven request set.

    ``warmup_s`` drops requests submitted before that modeled time from
    every statistic (the warmup phase: queues filling, cold caches).
    ``priority`` restricts the report to one SLO class.  Keys:
    ``ttft_p50/p90/p99``, ``tpot_p50/p90/p99`` (seconds),
    ``sustained_tok_s`` (finished tokens over the measured span),
    ``preemptions``, ``migrations``, ``dropped`` (submitted but never
    finished), ``n``,
    and SLO violation counts against each request's own targets."""
    sel = [
        r for r in requests
        if r.submit_time >= warmup_s
        and (priority is None or r.priority == priority)
    ]
    done = [r for r in sel if r.done]
    ttft = [r.ttft_s for r in done if r.ttft_s is not None]
    tpot = [r.tpot_s for r in done if r.tpot_s is not None]
    tokens = sum(len(r.generated) for r in done)
    if done:
        t0 = max(warmup_s, min(r.submit_time for r in done))
        span = max(r.finish_time for r in done) - t0
    else:
        span = 0.0
    return {
        "n": len(sel),
        "finished": len(done),
        "dropped": len(sel) - len(done),
        "preemptions": sum(r.n_preemptions for r in sel),
        "migrations": sum(r.n_migrations for r in sel),
        "ttft_p50": _pct(ttft, 50), "ttft_p90": _pct(ttft, 90),
        "ttft_p99": _pct(ttft, 99),
        "tpot_p50": _pct(tpot, 50), "tpot_p90": _pct(tpot, 90),
        "tpot_p99": _pct(tpot, 99),
        "sustained_tok_s": tokens / span if span > 0 else 0.0,
        "slo_ttft_violations": sum(
            1 for r in done
            if r.ttft_slo_s is not None and r.ttft_s is not None
            and r.ttft_s > r.ttft_slo_s
        ),
        "slo_tpot_violations": sum(
            1 for r in done
            if r.tpot_slo_s is not None and r.tpot_s is not None
            and r.tpot_s > r.tpot_slo_s
        ),
    }
