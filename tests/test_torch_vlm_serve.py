"""qwen2-vl-2b (M-RoPE) through the port's four engines against the
reference's, in f32 on the CPU on bridged weights with
``timing="modeled"``; and greedy parity through the paged
``ServingEngine`` for the other attention-only configs the port carries.

Smoke qwen2-vl-2b at 4 layers (head_dim 32, sections (4, 6, 6), 4 query
heads on 2 kv heads).  Each case holds the tokens equal, and the counters,
link meters, metrics and stage signatures as the older engine tests do:

- the paged ``ServingEngine`` (tokens, pages drained);
- ``EndCloudPipeline.run_batch`` (logits at 1e-4, split, codec, boundary
  bytes, link meter) at the planner's interior split with the rank-16
  codec, and at split 0 without it;
- ``EndCloudServingEngine`` at forced splits 0, 2 and 4 with the rank-16
  codec off and on (``test_torch_stream``'s harness), with ``spec_k=4``
  (``test_torch_specdecode``'s harness: also equal to the plain run), and
  with all three int8 streams against the reference's quantized engine;
- a two-lane ``FleetServingEngine`` driven by ``loadgen.drive`` on a
  ``VirtualClock`` (``test_torch_chaos``'s harness with no faults: stamps,
  placement, every metric, the timeline).

The engines feed text positions, the same on all three M-RoPE axes, so
these cases test the plumbing; the sections themselves are tested on a
patch grid in ``test_torch_vlm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chaos import assert_runs_equal, both, schedule
from test_torch_fleet import bridge_pair
from test_torch_specdecode import check_spec
from test_torch_stream import assert_engines_equal, run_engine

from repro.core import hardware as jhw
from repro.serving.endcloud import EndCloudPipeline as JPipeline
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.core import hardware as thw
from repro_torch.serving import EndCloudPipeline, Request, ServingEngine

torch.set_num_threads(1)

NAME = "qwen2-vl-2b"
INT8 = dict(quantize_kv=True, quantize_experts=True, quantize_boundary=True)


@pytest.fixture(scope="module")
def vlm():
    return bridge_pair(NAME, 4)


def serve(side, pair, n=6, seed=0, lens=(4, 24), max_len=64):
    """``n`` requests of ``lens`` tokens through a 4-slot paged engine,
    8-token chunks; (tokens, engine)."""
    (jm, jp), (tm, tp) = pair
    jx = side == "jax"
    rng = np.random.default_rng(seed)
    R = JRequest if jx else Request
    reqs = [R(i, rng.integers(0, 500, size=int(rng.integers(*lens))).astype(np.int32),
              max_new_tokens=6) for i in range(n)]
    eng = (JServingEngine if jx else ServingEngine)(
        jm if jx else tm, jp if jx else tp, max_batch=4, max_len=max_len, prefill_chunk=8)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.generated) for r in reqs], eng


def test_serving_engine_matches_reference(vlm):
    want, _ = serve("jax", vlm)
    got, eng = serve("torch", vlm)
    assert got == want
    assert eng.pool.pages_in_use == 0


@pytest.mark.parametrize("end,rank,split", [("jetson-orin", 16, 1), ("a100", 0, 0)])
def test_pipeline_matches_reference(vlm, end, rank, split):
    """The planner's split for the smoke model: 1 of 4 with the codec on a
    jetson-orin end, 0 on an a100 end (a100 cloud both times)."""
    (jm, jp), (tm, tp) = vlm
    jpipe = JPipeline(jm, jp, compression_rank=rank, end_profile=jhw.PROFILES[end],
                      cloud_profile=jhw.PROFILES["a100"])
    codec = None if jpipe.codec is None else params_from_numpy(
        jax.tree.map(np.asarray, jpipe.codec), "cpu")
    pipe = EndCloudPipeline(tm, tp, end_profile=thw.PROFILES[end],
                            cloud_profile=thw.PROFILES["a100"], codec_params=codec)
    assert pipe.split == jpipe.split == split
    tokens = np.arange(2 * 24, dtype=np.int32).reshape(2, 24) * 7 % 500
    want, jmet = jpipe.run_batch(jnp.asarray(tokens))
    got, met = pipe.run_batch(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for key in ("split", "compressed", "boundary_bytes", "t_comm_s"):
        assert met[key] == jmet[key], key
    assert met["compressed"] == bool(rank)
    assert (pipe.link.bytes_up, pipe.link.transfers) == (jpipe.link.bytes_up,
                                                         jpipe.link.transfers)


@pytest.mark.parametrize("rank", [0, 16])
@pytest.mark.parametrize("split", [0, 2, 4])
def test_stream_engine_matches_reference(vlm, split, rank):
    kw = dict(force_split=split, rank=rank)
    jtok, jeng = run_engine("jax", vlm, **kw)
    ttok, teng = run_engine("torch", vlm, **kw)
    assert teng.split == split
    assert_engines_equal(jtok, jeng, ttok, teng)


def test_stream_engine_speculative_matches_reference(vlm):
    """``spec_k=4`` at split 2: dense, so every draft verifies; the tokens
    also equal the port's plain run."""
    m = check_spec(vlm, force_split=2)
    assert m["spec_plan_k"] == 4 and m["spec_rounds"] > 0
    assert m["spec_acceptance_rate"] == 1.0


def test_stream_engine_int8_streams_match_reference(vlm):
    """All three int8 streams (the expert flag is inert on a dense model)
    at split 2 with the rank-16 codec, against the reference's quantized
    engine."""
    jtok, jeng = run_engine("jax", vlm, force_split=2, rank=16, **INT8)
    ttok, teng = run_engine("torch", vlm, force_split=2, rank=16, **INT8)
    m = teng.metrics()
    assert m["kv_quantized"] == m["boundary_quantized"] == 1.0
    assert_engines_equal(jtok, jeng, ttok, teng)


def test_two_lane_fleet_matches_reference(vlm):
    """Two lanes over one shared two-server cloud, the seeded two-class
    schedule replayed by ``loadgen.drive`` on a ``VirtualClock``."""
    j, t = both(vlm, sched=lambda lg: schedule(lg, n=16), drive=True, n_lanes=2)
    assert_runs_equal(j, t)
    assert {ev["device"] for ev in t.fleet.placed} == {0, 1}


# -- the other attention-only configs -------------------------------------------


@pytest.mark.parametrize("name", ["qwen3-14b", "internlm2-20b", "h2o-danube-3-4b",
                                  "qwen3-moe-235b-a22b"])
def test_attention_only_config_serves_like_reference(name):
    """Smoke config at 2 layers through the paged ``ServingEngine``: QK-norm
    (qwen3), a sliding window of 96 over prompts that outgrow it
    (h2o-danube), 8 experts top-2 with the rank-64 dispatch codec
    (qwen3-moe)."""
    pair = bridge_pair(name, 2)
    kw = dict(n=5, seed=1)
    if pair[1][0].cfg.sliding_window:
        kw.update(lens=(90, 120), max_len=160)
    want, _ = serve("jax", pair, **kw)
    got, eng = serve("torch", pair, **kw)
    assert got == want
    assert eng.pool.pages_in_use == 0
