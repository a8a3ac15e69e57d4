"""The port's speculative decode against the reference's, on the CPU in f32.

The numpy pieces (``serving.specdecode``'s accept rule, acceptance state
and rollback arithmetic, ``core.pipeline.plan_spec_k``) on parametrised and
hypothesis inputs; ``PagePool.map_tokens`` / ``rollback`` through a random
lifecycle, table by table; the dense rings (``init_cache``, ``ring_write``,
``prefill_write``), ``decode_attention``, ``Model.prefill``,
``decode_step`` and ``verify_chunk_step`` on bridged weights (tolerance
1e-5 in f32); and the streaming engine with ``spec_k > 1`` beside the
reference engine (``timing="modeled"``, the default clock): tokens, every
metric but the wall-clock one, the host syncs and the stage signatures, at
splits 0, 2 and 4, on the MoE rejection path, with the codec, pooled and
dense-mask, with each int8 stream and all three, and across a bandwidth
observation that turns speculation on mid-run.  Smoke tinyllama-1.1b at 4
layers (dense: every draft verifies) and smoke llama4-scout (the end mask
makes the draft diverge).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, st

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import compression as jcomp
from repro.core import hardware as jhw
from repro.core.pipeline import plan_spec_k as jplan_spec_k
from repro.models import attention as jattn
from repro.models import kvcache as jkv
from repro.models.model import build_model
from repro.serving import specdecode as jspec
from repro.serving.common import Request as JRequest
from repro.serving.stream import EndCloudServingEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import LayerSpec
from repro_torch.core import hardware as thw
from repro_torch.core.pipeline import plan_spec_k
from repro_torch.models import attention as tattn
from repro_torch.models import kvcache as tkv
from repro_torch.models.model import Model
from repro_torch.models.transformer import compute_params
from repro_torch.serving import EndCloudServingEngine, Request
from repro_torch.serving import specdecode as tspec

torch.set_num_threads(1)

WALL_CLOCK = {"link_blackout_s"}  # the only metric that reads the host clock
TOL = 1e-5  # f32, the same inputs through both packages


# -- the numpy pieces ------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(k=st.integers(1, 8), seed=st.integers(0, 10_000), agree=st.integers(0, 8))
def test_accept_greedy_matches_reference(k, seed, agree):
    rng = np.random.default_rng(seed)
    verify = rng.integers(0, 4, size=k).tolist()
    drafts = [verify[i] if i < agree else int(rng.integers(0, 4)) for i in range(k - 1)]
    assert tspec.accept_greedy(drafts, verify) == jspec.accept_greedy(drafts, verify)
    with pytest.raises(ValueError, match="mismatch"):
        tspec.accept_greedy(drafts + [0], verify)


@settings(max_examples=40, deadline=None)
@given(B=st.integers(1, 6), k=st.integers(2, 8), seed=st.integers(0, 10_000))
def test_batched_accept_matches_reference(B, k, seed):
    rng = np.random.default_rng(seed)
    verify = rng.integers(0, 3, size=(B, k))
    drafts = np.where(rng.random((B, k)) < 0.7, verify,
                      rng.integers(0, 3, size=(B, k)))
    n_valid = rng.integers(0, k + 1, size=B)
    tc, tr = tspec.batched_accept(drafts, verify, n_valid)
    jc, jr = jspec.batched_accept(drafts, verify, n_valid)
    assert tc == jc and np.array_equal(tr, jr)


@settings(max_examples=40, deadline=None)
@given(k_plan=st.integers(1, 9), seed=st.integers(0, 10_000))
def test_spec_state_matches_reference(k_plan, seed):
    rng = np.random.default_rng(seed)
    t, j = tspec.SpecState(k_plan), jspec.SpecState(k_plan)
    for _ in range(20):
        d = int(rng.integers(0, 8))
        a = int(rng.integers(0, d + 1))
        rb = bool(rng.integers(0, 2))
        t.observe_round(d, a, rolled_back=rb)
        j.observe_round(d, a, rolled_back=rb)
        assert (t.k_eff, t.acceptance, t.metrics()) == (j.k_eff, j.acceptance, j.metrics())


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9, 100])
def test_min_pow2_le_matches_reference(k):
    assert tspec.min_pow2_le(k) == jspec.min_pow2_le(k)


def test_min_pow2_le_rejects_zero():
    with pytest.raises(ValueError):
        tspec.min_pow2_le(0)


@settings(max_examples=60, deadline=None)
@given(base=st.integers(0, 40), n_commit=st.integers(0, 8), ps=st.sampled_from([2, 4, 16]),
       pps=st.sampled_from([2, 3, 4, 8]), seed=st.integers(0, 1000))
def test_rollback_entries_matches_reference(base, n_commit, ps, pps, seed):
    rng = np.random.default_rng(seed)
    new = sorted(set(rng.integers(0, pps, size=3).tolist()))
    kw = dict(base_len=base, n_commit=n_commit, page_size=ps, pages_per_slot=pps)
    assert tspec.rollback_entries(new, **kw) == jspec.rollback_entries(new, **kw)


@settings(max_examples=60, deadline=None)
@given(split=st.integers(0, 4), rtt=st.sampled_from([0.0, 1e-3, 0.01, 0.05, 0.5]),
       gbps=st.sampled_from([None, 0.05, 1.0, 100.0]), ratio=st.sampled_from([1.0, 0.25]),
       acc=st.sampled_from([0.0, 0.3, 0.7, 1.0]), k_max=st.sampled_from([1, 2, 4, 6, 8]),
       end_gbps=st.sampled_from([0.1, 1.0, 10.0]))
def test_plan_spec_k_matches_reference(split, rtt, gbps, ratio, acc, k_max, end_gbps):
    args = ([1.0, 0.5, 2.0, 1.0], 32768)
    kw = dict(split=split, link_rtt_s=rtt, measured_gbps=gbps, compression_ratio=ratio,
              acceptance=acc, k_max=k_max)
    t = plan_spec_k(*args, thw.Capability(5.0, 4.0, end_gbps), thw.Capability(50.0, 64.0, 10.0),
                    **kw)
    j = jplan_spec_k(*args, jhw.Capability(5.0, 4.0, end_gbps), jhw.Capability(50.0, 64.0, 10.0),
                     **kw)
    assert t == j


def test_plan_spec_k_validates_split():
    with pytest.raises(ValueError):
        plan_spec_k([1.0] * 4, 1.0, thw.Capability(5.0, 4.0, 1.0),
                    thw.Capability(50.0, 64.0, 10.0), split=5)


# -- PagePool: provisional maps and their rollback ---------------------------


def _pool_state(pool):
    return (pool.table.tolist(), list(pool._free), pool._mapped.tolist(),
            pool._reserved.tolist(), pool.pages_in_use, pool.peak_in_use)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 200), page_size=st.sampled_from([2, 4]),
       pps=st.sampled_from([3, 4, 6]), k=st.integers(2, 8))
def test_map_tokens_rollback_lifecycle_matches_reference(seed, page_size, pps, k):
    """Admit, speculative rounds (provisional map, rollback past a random
    accepted prefix), spill, restore and free in a random order, as the
    reference's property test drives its pool: equal returns and equal
    tables, free lists and counters after every operation."""
    rng = np.random.default_rng(seed)
    n = 4
    pools = [cls(num_pages=n * pps, page_size=page_size, pages_per_slot=pps, n_slots=n)
             for cls in (tkv.PagePool, jkv.PagePool)]
    lengths = np.zeros(n, np.int64)
    held = np.zeros(n, bool)
    parked = {}
    for _ in range(60):
        slot = int(rng.integers(n))
        op = rng.choice(["round", "spill", "restore", "free", "admit"])
        if op == "admit" and not held[slot] and slot not in parked:
            need = tkv.pages_needed(int(rng.integers(1, 3 * page_size)), page_size, pps)
            if pools[0].can_reserve(need):
                for p in pools:
                    p.reserve(slot, need)
                held[slot], lengths[slot] = True, 0
        elif op == "round" and held[slot]:
            L, r = int(lengths[slot]), pools[0].reserved_pages(slot)
            n_valid = k if r == pps else min(k, r * page_size - L)
            if n_valid < 1:
                continue
            new = [p.map_tokens(slot, L, L + n_valid) for p in pools]
            assert new[0] == new[1]
            n_commit = int(rng.integers(1, n_valid + 1))
            rb = tspec.rollback_entries(new[0], base_len=L, n_commit=n_commit,
                                        page_size=page_size, pages_per_slot=pps)
            if rb:
                for p in pools:
                    p.rollback(slot, rb)
            lengths[slot] = L + n_commit
        elif op == "spill" and held[slot] and pools[0]._mapped[slot] > 0:
            out = [p.spill_slot(slot) for p in pools]
            assert all(np.array_equal(a, b) for a, b in zip(out[0][:2], out[1][:2]))
            assert out[0][2] == out[1][2]
            parked[slot] = (out[0][0], out[0][2], lengths[slot])
            held[slot], lengths[slot] = False, 0
        elif op == "restore" and slot in parked and not held[slot]:
            entries, n_pages, length = parked[slot]
            if pools[0].can_reserve(n_pages):
                rows = [p.restore_slot(slot, entries, n_pages) for p in pools]
                assert np.array_equal(rows[0], rows[1])
                del parked[slot]
                held[slot], lengths[slot] = True, length
        elif op == "free" and held[slot]:
            for p in pools:
                p.free(slot)
            held[slot], lengths[slot] = False, 0
        assert _pool_state(pools[0]) == _pool_state(pools[1])


def test_rollback_of_an_unmapped_entry_raises():
    pool = tkv.PagePool(num_pages=8, page_size=4, pages_per_slot=4, n_slots=2)
    pool.reserve(0, 2)
    new = pool.map_tokens(0, 0, 5)
    assert len(new) == 2
    pool.rollback(0, [new[-1]])
    with pytest.raises(ValueError, match="unmapped"):
        pool.rollback(0, [new[-1]])


# -- dense rings, decode attention and the model steps -----------------------


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (11, 8)])
def test_ring_writes_match_reference(S, W):
    rng = np.random.default_rng(S)
    k, v = (rng.standard_normal((2, S, 2, 4)).astype(np.float32) for _ in range(2))
    kc, vc = tkv.prefill_write(torch.zeros(2, W, 2, 4), torch.zeros(2, W, 2, 4),
                               torch.from_numpy(k), torch.from_numpy(v))
    jk, jv = jkv.prefill_write(jnp.zeros((2, W, 2, 4)), jnp.zeros((2, W, 2, 4)), k, v)
    _close(kc, jk, 0)
    _close(vc, jv, 0)
    kn, vn = (rng.standard_normal((2, 1, 2, 4)).astype(np.float32) for _ in range(2))
    lengths = np.array([S, S + 3], np.int32)
    kc, vc = tkv.ring_write(kc, vc, torch.from_numpy(kn), torch.from_numpy(vn),
                            torch.from_numpy(lengths))
    jk, jv = jkv.ring_write(jk, jv, kn, vn, lengths)
    _close(kc, jk, 0)
    _close(vc, jv, 0)


def test_init_cache_matches_reference_and_refuses_other_layers():
    jcfg = jsmoke(jget("tinyllama-1.1b")).replace(num_layers=4, dtype="float32")
    cfg = smoke_config(get_config("tinyllama-1.1b")).replace(num_layers=4, dtype="float32")
    jc = jkv.init_cache(jcfg, 3, 40, jnp.float32)
    tc = tkv.init_cache(cfg, 3, 40, torch.float32, "cpu")
    assert tc["lengths"].shape == jc["lengths"].shape
    for pos, entry in jc["blocks"].items():
        assert {n: tuple(l.shape) for n, l in tc["blocks"][pos].items()} == {
            n: tuple(l.shape) for n, l in entry.items()}
    # cross-attention leaves (ported with the encoder-decoder): the
    # reference's xk/xv of encoder_seq_len frames beside the rings
    xcfg = dict(layer_pattern=(LayerSpec(cross_attn=True),), encoder_seq_len=12)
    jc = jkv.init_cache(jcfg.replace(**xcfg), 1, 8, jnp.float32)
    tc = tkv.init_cache(cfg.replace(**xcfg), 1, 8, torch.float32, "cpu")
    for pos, entry in jc["blocks"].items():
        assert set(entry) == {"k", "v", "xk", "xv"}
        assert {n: tuple(l.shape) for n, l in tc["blocks"][pos].items()} == {
            n: tuple(l.shape) for n, l in entry.items()}
    # SSM leaves (mamba2 smoke's): the reference's shapes and types, zeros
    scfg = smoke_config(get_config("mamba2-130m")).replace(num_layers=2)
    jc = jkv.init_cache(jsmoke(jget("mamba2-130m")).replace(num_layers=2), 3, 8, jnp.bfloat16)
    tc = tkv.init_cache(scfg, 3, 8, torch.bfloat16, "cpu")
    assert tc["lengths"].shape == jc["lengths"].shape
    for pos, entry in jc["blocks"].items():
        assert set(entry) == set(tc["blocks"][pos]) == {"ssm", "conv_x", "conv_bc"}
        for n, leaf in entry.items():
            got = tc["blocks"][pos][n]
            assert tuple(got.shape) == leaf.shape and not got.any()
            assert str(got.dtype) == f"torch.{leaf.dtype}"


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_reference(window):
    """Queries at ring positions with unwritten slots (position < 0) and,
    with a window, keys past it: both masked."""
    rng = np.random.default_rng(0)
    B, W, H, KV, hd = 3, 16, 4, 2, 8
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, W, KV, hd)).astype(np.float32) for _ in range(2))
    lengths = np.array([3, 15, 21], np.int32)
    kp = jkv.ring_key_positions(jnp.asarray(lengths), W)
    want = jattn.decode_attention(q, k, v, jnp.asarray(lengths), kp, window=window)
    got = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), tkv.ring_key_positions(torch.from_numpy(lengths), W),
        window=window)
    _close(got, want)


@pytest.fixture(scope="module")
def models():
    """name -> (reference model, params), (port model, the same params)."""
    out = {}
    for name in ("tinyllama-1.1b", "llama4-scout-17b-16e"):
        jcfg = jsmoke(jget(name)).replace(num_layers=4, dtype="float32", param_dtype="float32")
        jm = build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        cfg = smoke_config(get_config(name)).replace(num_layers=4, dtype="float32",
                                                      param_dtype="float32")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        out[name] = (jm, jp), (Model(cfg, device="cpu"), tp)
    return out


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "llama4-scout-17b-16e"])
def test_model_steps_match_reference(models, name):
    """``prefill`` (logits and every ring), three ``decode_step`` s over the
    rings (partial masks on the MoE model), and ``verify_chunk_step`` over
    paged pools: the logits of every position."""
    (jm, jp), (tm, tp) = models[name]
    tp = compute_params(tp, tm.cfg)
    mask = None
    if tm.cfg.moe is not None:
        mask = np.arange(tm.cfg.moe.num_experts) % 3 != 1
    tmask = None if mask is None else torch.from_numpy(mask)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 500, size=(2, 12)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=32, expert_mask=mask)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len=32, expert_mask=tmask)
    _close(tl, jl)
    for pos, entry in jc["blocks"].items():
        for n, leaf in entry.items():
            _close(tc["blocks"][pos][n], leaf)
    t = rng.integers(0, 500, size=(2, 1)).astype(np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(t), jc, expert_mask=mask)
        tl, tc = tm.decode_step(tp, torch.from_numpy(t), tc, expert_mask=tmask)
        _close(tl, jl)
        assert tc["lengths"].tolist() == np.asarray(jc["lengths"]).tolist()
        t = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)

    # verify chunk over paged pools: a prompt chunk first, then C = 4 with
    # a padding row in the second slot
    ps, pps, P = 4, 8, 16
    cfg = tm.cfg
    jpages = {f"pos{i}": {n: jnp.zeros((cfg.block_repeat, P + 1, ps, cfg.num_kv_heads,
                                        cfg.head_dim)) for n in ("k", "v")}
              for i in range(len(cfg.layer_pattern))}
    tpages = {pos: {n: torch.zeros(l.shape) for n, l in e.items()} for pos, e in jpages.items()}
    table = np.arange(2 * pps, dtype=np.int32).reshape(2, pps)
    for start, C, nv in ((0, 8, [8, 6]), (8, 4, [4, 3])):
        chunk = rng.integers(0, 500, size=(2, C)).astype(np.int32)
        args = (np.full((2,), start, np.int32), np.asarray(nv, np.int32))
        jl, jpages = jm.verify_chunk_step(jp, jnp.asarray(chunk), jpages, jnp.asarray(table),
                                          *map(jnp.asarray, args), page_size=ps,
                                          expert_mask=mask)
        tl, tpages = tm.verify_chunk_step(tp, torch.from_numpy(chunk), tpages,
                                          torch.from_numpy(table), *map(torch.from_numpy, args),
                                          page_size=ps, expert_mask=tmask)
        assert tl.shape == (2, C, cfg.padded_vocab_size)
        for b, n in enumerate(nv):
            _close(tl[b, :n], np.asarray(jl)[b, :n])


# -- the engine ----------------------------------------------------------------


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 500, size=int(rng.integers(4, 16))).astype(np.int32)
            for _ in range(n)]


def _end_sim(hw, net):
    return hw.DeviceProfile("end-sim", peak_gflops=2.0, mem_gb=8.0, mem_bw_gbs=50.0,
                            net_gbps=net)


def run_engine(side, pair, *, end_net=None, rank=0, actions=None, n_req=4, new=6, **kw):
    """Serve ``n_req`` requests on the reference (``side="jax"``) or the
    port with ``actions[tick](engine)`` before that tick; returns (tokens,
    engine).  A codec of ``rank`` is drawn by the reference and carried
    across; ``end_net`` swaps the a100 end for a simulated one with that
    uplink (Gbps)."""
    (jm, jp), (tm, tp) = pair
    jx = side == "jax"
    hw = jhw if jx else thw
    end = hw.PROFILES["a100"] if end_net is None else _end_sim(hw, end_net)
    codec = None
    if rank:
        codec = jcomp.init_lowrank_1d(jax.random.PRNGKey(7), jm.cfg.d_model, rank)
        if not jx:
            codec = params_from_numpy(jax.tree.map(np.asarray, codec), "cpu")
    eng = (JEngine if jx else EndCloudServingEngine)(
        jm if jx else tm, jp if jx else tp, end_profile=end, cloud_profile=hw.PROFILES["a100"],
        codec_params=codec, max_batch=4, max_len=64, prefill_chunk=8, timing="modeled", **kw)
    reqs = [(JRequest if jx else Request)(i, p, max_new_tokens=new)
            for i, p in enumerate(_prompts(n_req))]
    for r in reqs:
        eng.submit(r)
    tick = 0
    while eng.busy():
        if actions and tick in actions:
            actions[tick](eng)
        eng.step()
        tick += 1
        assert tick < 500
    return [r.generated for r in reqs], eng


def assert_engines_equal(jtok, jeng, ttok, teng):
    assert ttok == jtok
    assert teng.replan_events == jeng.replan_events
    assert (teng.link.bytes_up, teng.link.bytes_down, teng.link.transfers) == (
        jeng.link.bytes_up, jeng.link.bytes_down, jeng.link.transfers)
    jm_, tm_ = jeng.metrics(), teng.metrics()
    assert set(tm_) == set(jm_)
    assert {k: tm_[k] for k in tm_ if k not in WALL_CLOCK} == {
        k: jm_[k] for k in jm_ if k not in WALL_CLOCK}
    assert teng.n_host_syncs == jeng.n_host_syncs
    assert teng.stage_trace_counts() == jeng.stage_trace_counts()
    assert teng.end_pool.pages_in_use == teng.cloud_pool.pages_in_use == 0
    assert teng.end_pool.pages_reserved == teng.cloud_pool.pages_reserved == 0


def check_spec(pair, *, plain_equal=True, **kw):
    """Port and reference with speculation; the port's tokens also equal
    its own plain run's.  Returns the port's metrics."""
    kw.setdefault("spec_k", 4)
    kw.setdefault("link_rtt_s", 0.05)
    jtok, jeng = run_engine("jax", pair, **kw)
    ttok, teng = run_engine("torch", pair, **kw)
    assert_engines_equal(jtok, jeng, ttok, teng)
    if plain_equal:
        plain, _ = run_engine("torch", pair, **{**kw, "spec_k": 1})
        assert ttok == plain
    return teng.metrics()


@pytest.mark.parametrize("split", [0, 2, 4])
def test_engine_spec_matches_reference_at_splits(models, split):
    """Dense model: the draft is the model, every draft verifies."""
    m = check_spec(models["tinyllama-1.1b"], force_split=split)
    assert m["spec_plan_k"] == 4 and m["spec_rounds"] > 0
    assert m["spec_acceptance_rate"] == 1.0 and m["spec_rollbacks"] == 0


def test_engine_spec_moe_rejection_path(models):
    """The end mask makes the draft diverge from the full router: rounds
    reject and roll back, k_eff adapts, tokens stay the reference's."""
    m = check_spec(models["llama4-scout-17b-16e"], force_split=2)
    assert m["spec_rounds"] > 0 and m["spec_rollbacks"] > 0
    assert 0.0 <= m["spec_acceptance_rate"] < 1.0


def test_engine_spec_with_codec(models):
    """The eq. 8 codec on the boundary at an interior split (its loss moves
    tokens off the plain run's only through the codec, so both engines
    compress the same numbers)."""
    m = check_spec(models["llama4-scout-17b-16e"], force_split=2, rank=16)
    assert m["compressed"] and m["spec_rounds"] > 0


@pytest.mark.parametrize("pool", [True, False])
def test_engine_spec_pooled_and_dense_mask(models, pool):
    """The pooled end chunk (resident FFN) and the dense-mask one."""
    m = check_spec(models["llama4-scout-17b-16e"], force_split=3, expert_pool=pool)
    assert m["spec_rounds"] > 0
    assert ("expert_hit_rate" in m) == pool


@pytest.mark.parametrize("flags", [
    dict(quantize_kv=True),
    dict(quantize_experts=True),
    dict(quantize_boundary=True),
    dict(quantize_kv=True, quantize_experts=True, quantize_boundary=True),
])
def test_engine_spec_int8_streams(models, flags):
    """Each int8 stream alone and all three: the verify and end chunks over
    int8 pools (C = k), the quantized boundary's C = k payload."""
    m = check_spec(models["llama4-scout-17b-16e"], force_split=2, plain_equal=False, **flags)
    assert m["spec_rounds"] > 0


def test_engine_spec_turned_on_by_a_bandwidth_observation(models):
    """A 100 kbps uplink makes the boundary wire-bound, so the plan starts
    at k = 1; a declared 10 Mbps turns speculation on mid-run (and moves
    the split at the next safe point); running slots get their draft
    caches then."""
    pair = models["tinyllama-1.1b"]
    act = {6: lambda e: e.observe_bandwidth(0.01, hard=True)}
    m = check_spec(pair, force_split=2, end_net=0.0001, link_rtt_s=0.01, actions=act, new=10)
    assert m["spec_plan_k"] == 4 and m["spec_rounds"] > 0


def test_engine_no_rtt_plans_no_speculation(models):
    """With no round trip the plan is 1: nothing speculative runs, and the
    metrics are the plain engine's."""
    pair = models["llama4-scout-17b-16e"]
    _, spec = run_engine("torch", pair, force_split=2, spec_k=8)
    _, plain = run_engine("torch", pair, force_split=2)
    assert spec.metrics()["spec_plan_k"] == 1
    sm, pm = spec.metrics(), plain.metrics()
    assert {k: sm[k] for k in sm if k not in WALL_CLOCK} == {
        k: pm[k] for k in pm if k not in WALL_CLOCK}
    assert spec.stage_trace_counts() == plain.stage_trace_counts()
