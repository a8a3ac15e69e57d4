"""The slice as a whole: the port's ``Model`` and paged ``ServingEngine``
against the reference's on the same weights (carried over by
``bridge.params_from_numpy``), in f32 on the CPU, for the smoke switch-base
and smoke llama4-scout configs; plus the engine's admission behaviour."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models.model import build_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.models.model import Model
from repro_torch.serving import Request, ServingEngine

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

MOE = ["switch-base", "llama4-scout-17b-16e"]
MASK = np.asarray([1, 0, 0, 0, 1, 1, 0, 1], bool)


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    """(reference model, params), (port model, the same params), f32."""
    name = request.param
    jcfg = jsmoke(jget(name)).replace(num_layers=4, dtype="float32")
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = smoke_config(get_config(name)).replace(num_layers=4, dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return (jmodel, jparams), (Model(cfg, device="cpu"), params)


def _workload(n=9, seed=0, lo=4, hi=16, new=6, cls=Request):
    """tests/test_serving.py's workload shape."""
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, 500, size=rng.integers(lo, hi)).astype(np.int32),
                max_new_tokens=new) for i in range(n)]


def _serve(engine_cls, req_cls, model, params, **kw):
    reqs = _workload(cls=req_cls, **kw.pop("load", {}))
    eng = engine_cls(model, params, max_batch=4, max_len=64, **kw)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("mask", [None, MASK])
def test_greedy_tokens_match_reference_engine(pair, mask):
    (jm, jp), (tm, tp) = pair
    want, _ = _serve(JServingEngine, JRequest, jm, jp, expert_mask=mask)
    got, eng = _serve(ServingEngine, Request, tm, tp, expert_mask=mask)
    assert got == want
    assert eng.pool.pages_in_use == 0


def test_long_prompts_over_several_chunks_match(pair):
    """Prompts of 20-40 tokens through 8-token chunks (several chunks each,
    some slots admitted while others decode)."""
    (jm, jp), (tm, tp) = pair
    kw = dict(prefill_chunk=8, load=dict(n=5, seed=3, lo=20, hi=40, new=5))
    want, _ = _serve(JServingEngine, JRequest, jm, jp, **kw)
    got, eng = _serve(ServingEngine, Request, tm, tp, **kw)
    assert got == want
    assert eng.stage_trace_counts() == {"decode": 1, "prefill_chunk": 1}


def test_step_logits_match_reference(pair):
    """One prefill chunk then one decode step, logits compared directly."""
    (jm, jp), (tm, tp) = pair
    from repro.models import kvcache as jkv
    from repro_torch.models import kvcache as tkv

    cfg = tm.cfg
    ps, pool = 4, tkv.PagePool(6, 4, 6, n_slots=1)
    pool.reserve(0, 6)
    pool.map_range(0, 0, 11)
    table = pool.device_rows([0], device="cpu")
    chunk = np.zeros((1, 16), np.int32)
    chunk[0, :10] = np.arange(30, 40)
    jpages = jkv.init_paged_blocks(jm.cfg, cfg.block_repeat, 6, ps, jnp.float32)
    tpages = tkv.init_paged_blocks(cfg, cfg.block_repeat, 6, ps, torch.float32, "cpu")
    i32 = lambda v: np.asarray(v, np.int32)  # noqa: E731
    jl, jpages = jm.prefill_chunk_step(jp, jnp.asarray(chunk), jpages, jnp.asarray(table.numpy()),
                                       jnp.asarray(i32([0])), jnp.asarray(i32([10])), page_size=ps)
    tl, tpages = tm.prefill_chunk_step(tp, torch.from_numpy(chunk), tpages, table,
                                       torch.from_numpy(i32([0])), torch.from_numpy(i32([10])),
                                       page_size=ps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    tok = i32([[7]])
    jl2, _ = jm.decode_step_paged(jp, jnp.asarray(tok), jpages, jnp.asarray(table.numpy()),
                                  jnp.asarray(i32([10])), page_size=ps)
    tl2, _ = tm.decode_step_paged(tp, torch.from_numpy(tok), tpages, table,
                                  torch.from_numpy(i32([10])), page_size=ps)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny():
    cfg = smoke_config(get_config("switch-base")).replace(num_layers=2)
    model = Model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def test_submit_time_checks(tiny):
    model, params = tiny
    eng = ServingEngine(model, params, max_batch=2, max_len=32)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(0, np.arange(30, dtype=np.int32), max_new_tokens=8))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(1, np.zeros(0, np.int32)))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(2, np.arange(4, dtype=np.int32), max_new_tokens=0))
    small = ServingEngine(model, params, max_batch=2, max_len=64, page_size=16, kv_pages=2)
    with pytest.raises(ValueError, match="never"):
        small.submit(Request(3, np.arange(40, dtype=np.int32), max_new_tokens=8))
    with pytest.raises(ValueError, match="selects no experts"):
        ServingEngine(model, params, expert_mask=np.zeros(8, bool))
    eng.submit(Request(4, np.arange(16, dtype=np.int32), max_new_tokens=16))
    done = eng.run()
    assert len(done) == 1 and len(done[0].generated) == 16


def test_prefill_finish_frees_slot_same_pass(tiny):
    model, params = tiny
    eng = ServingEngine(model, params, max_batch=1, max_len=64)
    short = Request(0, np.arange(5, dtype=np.int32), max_new_tokens=1)
    nxt = Request(1, np.arange(6, 14, dtype=np.int32), max_new_tokens=4)
    eng.submit(short)
    eng.submit(nxt)
    eng._admit()
    assert short.done and eng.slots[0] is nxt and not eng.waiting
    eng.run()
    assert len(nxt.generated) == 4 and eng.pool.pages_in_use == 0


@pytest.mark.parametrize("admission", ["priority", "fifo"])
def test_priority_head_does_not_starve_interactive(tiny, admission):
    """A page-hungry low-priority head blocks a fifo queue; priority
    admission lets the interactive request past it."""
    model, params = tiny
    probe = ServingEngine(model, params, max_batch=2, max_len=64, page_size=16)
    running = Request(0, np.arange(24, dtype=np.int32), max_new_tokens=8, priority=0)
    hungry = Request(1, np.arange(40, dtype=np.int32), max_new_tokens=8, priority=2)
    small = Request(2, np.arange(6, dtype=np.int32), max_new_tokens=8, priority=0)
    need = {r.request_id: probe._pages_for(r) for r in (running, hungry, small)}
    eng = ServingEngine(model, params, max_batch=2, max_len=64, page_size=16,
                        kv_pages=need[0] + need[1] - 1, admission=admission)
    eng.submit(running)
    eng.step()
    eng.submit(hungry)
    eng.step()
    assert hungry in eng.waiting
    eng.submit(small)
    eng.step()
    assert (eng.slots[1] is small) == (admission == "priority")
    assert len(eng.run()) == 3 and eng.pool.pages_in_use == 0


def test_eos_terminates_and_metrics(tiny):
    model, params = tiny
    eng = ServingEngine(model, params, max_batch=2, max_len=64)
    probe = Request(0, np.arange(5, dtype=np.int32), max_new_tokens=2)
    eng.submit(probe)
    eng.run()
    first = probe.generated[0]
    req = Request(1, np.arange(5, dtype=np.int32), max_new_tokens=50, eos_id=first)
    eng.submit(req)
    eng.run()
    assert req.generated == [first]
    m = eng.metrics()
    assert m["requests_finished"] == 2 and m["kv_pages_in_use"] == 0
    assert 0 < m["kv_bytes_peak"] <= m["kv_bytes_dense_equiv"]


def test_unported_patterns_raise():
    cfg = smoke_config(get_config("switch-base")).replace(
        layer_pattern=(smoke_config(get_config("switch-base")).layer_pattern[0].__class__(
            kind="attn", cross_attn=True),), num_layers=1)
    with pytest.raises(NotImplementedError):
        ServingEngine(Model(cfg, device="cpu"), {}, max_batch=1)
