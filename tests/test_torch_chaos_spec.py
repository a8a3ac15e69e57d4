"""A fleet lane dies mid speculative round, the port against the reference
(``test_torch_chaos.py``'s harness: smoke tinyllama at 4 layers in f32 on
the CPU, ``timing="modeled"`` on a ``VirtualClock``): three a100 lanes at
splits 2, 1 and 3 with ``spec_k=4`` and a 50 ms round trip an upload (the
link-bound regime, where the planner picks k > 1).  Lane 0 dies while a
round's boundary is in flight: the round's provisional pages unmap in both
pools before the spill (``_spec_abort``), so the migrated state holds no
draft KV; the fire log, placement log, replans, every metric, tokens and
stamps equal the reference's, and the tokens equal a run without the
crash."""

import torch

from test_torch_chaos import (  # noqa: F401
    assert_runs_equal,
    both,
    decoding,
    prompts_requests,
    run,
    tiny_pair,
)

torch.set_num_threads(1)


def test_crash_mid_speculative_round(tiny_pair):
    """Speculative lanes (``spec_k=4``): lane 0 dies while a round's
    boundary is in flight; its provisional pages unmap before the spill, so
    the migrated state holds no draft KV, and every token equals the run
    without the crash."""

    def hook(f, tick, notes):
        lane = f.lanes[0]
        if "crash_tick" in notes:
            return
        if any(p is not None for p in lane._spec_pending) and decoding(lane, 1):
            notes["crash_tick"] = tick
            notes["rollbacks"] = lane._spec_state.rollbacks
            notes["mapped"] = int(lane.end_pool.pages_in_use)
            f.fail_lane(0)
            notes["aborted"] = lane._spec_state.rollbacks - notes["rollbacks"]
            notes["pending"] = [p is None for p in lane._spec_pending]

    a100 = lambda hw: [hw.PROFILES["a100"]] * 3  # noqa: E731
    kw = dict(ends=a100, cloud=lambda hw: hw.PROFILES["a100"], force_splits=[2, 1, 3],
              spec_k=4, link_rtt_s=0.05, prefill_chunk=8, max_len=64,
              requests=lambda R: prompts_requests(R, new=12))
    j, t = both(tiny_pair, hook=hook, **kw)
    assert_runs_equal(j, t)
    n = t.notes
    assert n["aborted"] >= 1 and all(n["pending"])
    m = t.fleet.metrics()
    assert m["migrations"] >= 1 and m["spec_rounds"] > 0
    clean = run("torch", tiny_pair, **kw)
    assert clean.tokens == t.tokens
