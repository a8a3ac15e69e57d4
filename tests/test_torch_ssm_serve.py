"""SSM and hybrid patterns through the port's ``Model``, dense caches,
dense-ring ``ServingEngine`` and ``EndCloudPipeline`` against the
reference's, on bridged weights in f32 on the CPU: mamba2-130m smoke at 4
layers (attention-free) and jamba-1.5-large smoke (one 8-layer block: SSM
x7, attention at position 4, top-2 group-gated MoE at the odd positions).

- ``kvcache.init_cache`` leaf shapes and types; ``install_slot`` (a conv
  tail shorter than ``d_conv - 1`` zero-filled at its end, rings truncated
  and padded); ``split_cache`` / ``merge_cache`` at splits 0, R // 2, R;
- ``Model.prefill`` then greedy ``decode_step`` s: logits and every cache
  leaf at 1e-4 (f32 summed in other orders);
- the dense ``ServingEngine`` with 1- and 2-token prompts among the
  requests: tokens and every ``metrics()`` key equal; a prompt past one
  SSD chunk that is not a whole number of chunks refused;
- ``EndCloudPipeline.run_batch`` at the planner's splits 0, interior and R
  on mamba2 and at jamba's interior split of two blocks (interior with a
  rank-32 codec carried across from the reference): logits at 1e-4, split,
  codec, boundary bytes, link meter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import hardware as jhw
from repro.models import kvcache as jkv
from repro.models.model import build_model
from repro.serving.endcloud import EndCloudPipeline as JPipeline
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import hardware as thw
from repro_torch.models import kvcache as tkv
from repro_torch.models.model import Model
from repro_torch.serving import EndCloudPipeline, Request, ServingEngine

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

MAMBA, JAMBA = "mamba2-130m", "jamba-1.5-large-398b"
LAYERS = {MAMBA: 4, JAMBA: 8}


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v.numpy())
            for k, v in tree.items()}


def bridge(name, layers):
    """(reference model, params), (port model, the same params), f32: the
    port's own init (the reference's layout, ``test_torch_package``)
    carried across, which spares compiling the reference's init."""
    cfg = smoke_config(get_config(name)).replace(num_layers=layers, dtype="float32")
    tm = Model(cfg, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    jm = build_model(jsmoke(jget(name)).replace(num_layers=layers, dtype="float32"))
    return (jm, _to_jax(tp)), (tm, tp)


@pytest.fixture(scope="module", params=[MAMBA, JAMBA])
def pair(request):
    return bridge(request.param, LAYERS[request.param])


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def assert_caches_equal(got, want, tol):
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].float().numpy(), w.astype(np.float32), rtol=tol,
                                   atol=tol, err_msg=k)


def test_init_cache_matches_reference(pair):
    (jm, _), (tm, _) = pair
    jc = jkv.init_cache(jm.cfg, 3, 40, jnp.bfloat16)
    tc = tkv.init_cache(tm.cfg, 3, 40, torch.bfloat16, "cpu")
    want = {k: (v.shape, str(v.dtype)) for k, v in _leaves(jc)}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in _leaves(tc)}
    assert got == want
    kinds = {k.split("/")[-1] for k in got}
    assert {"ssm", "conv_x", "conv_bc"} <= kinds
    assert ("k" in kinds) == (tm.cfg.name == JAMBA)


def test_install_slot_matches_reference(pair):
    """A one-request cache with conv tails of 2 rows (a 2-token prompt) and
    rings of 24 into a batch of 40-slot rings: padded at the end, as the
    reference pads; and rings of 48 truncated."""
    (jm, _), (tm, _) = pair
    rng = np.random.default_rng(0)
    batch = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                         jkv.init_cache(jm.cfg, 3, 40, jnp.float32))
    for W in (24, 48):
        one = jax.tree.map(np.asarray, jkv.init_cache(jm.cfg, 1, W, jnp.float32))
        for pos, entry in one["blocks"].items():
            for n, leaf in entry.items():
                shape = list(leaf.shape)
                if n.startswith("conv"):
                    shape[2] = 2
                entry[n] = rng.standard_normal(shape).astype(np.float32)
        one["lengths"] = np.array([2], np.int32)
        want = jkv.install_slot(jax.tree.map(jnp.asarray, batch), 1, one)
        tb = params_from_numpy(batch, "cpu")
        got = tkv.install_slot(tb, 1, params_from_numpy(one, "cpu"))
        assert got is tb
        assert_caches_equal(got, want, 0)


def test_split_and_merge_cache_match_reference(pair):
    (jm, _), (tm, _) = pair
    rng = np.random.default_rng(1)
    cache = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                         jkv.init_cache(jm.cfg, 2, 16, jnp.float32))
    tc = params_from_numpy(cache, "cpu")
    R = tm.cfg.block_repeat
    for split in sorted({0, R // 2, R}):
        jend, jcloud = jkv.split_cache(cache, split)
        end, cloud = tkv.split_cache(tc, split)
        assert_caches_equal(end, jend, 0)
        assert_caches_equal(cloud, jcloud, 0)
        assert_caches_equal(tkv.merge_cache(end, cloud), jkv.merge_cache(jend, jcloud), 0)


def test_prefill_then_decode_matches_reference(pair):
    """A 2-token prompt's prefill (conv tails of 2 rows: only
    ``install_slot``'s padding lets them decode, in both packages), then a
    32-token prompt (one chunk) and 4 greedy steps over rings of 36: logits
    and every cache leaf each step."""
    (jm, jp), (tm, tp) = pair
    jprefill = jax.jit(jm.prefill, static_argnames=("max_len",))
    jdecode = jax.jit(jm.decode_step)
    short = np.array([[5, 9], [7, 1]], np.int32)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(short)}, max_len=8)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(short)}, max_len=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert_caches_equal(tc, jc, 1e-4)
    tokens = (np.arange(2 * 32, dtype=np.int32).reshape(2, 32) * 7 + 3) % 500
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(tokens)}, max_len=36)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, max_len=36)
    for _ in range(4):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        assert_caches_equal(tc, jc, 1e-4)
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        assert np.array_equal(tl.argmax(-1).numpy(), nxt[:, 0])
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert_caches_equal(tc, jc, 1e-4)


# 1- and 2-token prompts (conv tails padded by install_slot); 5 requests
# through 4 slots, so a finished slot is overwritten; three prompt lengths
# (the reference compiles a prefill for each)
PROMPTS = (2, 9, 1, 9, 2)


def _serve(engine_cls, req_cls, model, params):
    rng = np.random.default_rng(0)
    reqs = [req_cls(i, rng.integers(0, 500, size=n).astype(np.int32), max_new_tokens=6)
            for i, n in enumerate(PROMPTS)]
    eng = engine_cls(model, params, max_batch=4, max_len=48)
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [list(r.generated) for r in reqs], eng


def test_dense_engine_matches_reference(pair):
    (jm, jp), (tm, tp) = pair
    want, jeng = _serve(JServingEngine, JRequest, jm, jp)
    got, eng = _serve(ServingEngine, Request, tm, tp)
    assert got == want
    assert not eng.paged and eng.metrics() == jeng.metrics() == {
        "requests_finished": len(PROMPTS), "paged": False}
    assert eng.attn_bytes_step() == jeng.attn_bytes_step()
    assert eng.stage_trace_counts() == jeng.stage_trace_counts() == {}
    # every slot decodes, inactive ones too: lengths advance past the prompts;
    # the cache keeps the reference's leaves, state and types (nothing of it
    # is cast with the params, though ``conv_x`` names a param too)
    assert tuple(eng.cache["lengths"].numpy()) == tuple(np.asarray(jeng.cache["lengths"]))
    assert_caches_equal(eng.cache, jeng.cache, 1e-4)
    assert {k: str(v.dtype) for k, v in _leaves(eng.cache)} == {
        k: f"torch.{v.dtype}" for k, v in _leaves(jeng.cache)}


def test_dense_engine_refuses_a_ragged_long_prompt(pair):
    """A prompt past one SSD chunk that is not a whole number of chunks:
    the reference's prefill asserts, the port's raises."""
    (_, _), (tm, tp) = pair
    eng = ServingEngine(tm, tp, max_batch=2, max_len=48)
    eng.submit(Request(0, np.arange(40, dtype=np.int32), max_new_tokens=4))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        eng.run()


PIPELINES = [
    # (config, layers, rank, end profile, cloud profile, the planner's split):
    # mamba2 at splits 0, interior (codec on) and R; jamba at two blocks
    # (16 layers), so that it has an interior split (codec on)
    (MAMBA, 4, 0, "xeon-4214r", "a100", 0),
    (MAMBA, 4, 32, "a100", "jetson-orin", 3),
    (MAMBA, 4, 32, "tpu-v5e", "xeon-4214r", 4),
    (JAMBA, 16, 32, "xeon-4214r", "xeon-4214r", 1),
]


@pytest.mark.parametrize("name,layers,rank,end,cloud,split", PIPELINES,
                         ids=[f"{p[0][:5]}-split{p[5]}" for p in PIPELINES])
def test_pipeline_matches_reference(name, layers, rank, end, cloud, split):
    (jm, jp), (tm, tp) = bridge(name, layers)
    prof = dict(end_profile=jhw.PROFILES[end], cloud_profile=jhw.PROFILES[cloud])
    jpipe = JPipeline(jm, jp, compression_rank=rank, **prof)
    codec = None if jpipe.codec is None else params_from_numpy(
        jax.tree.map(np.asarray, jpipe.codec), "cpu")
    pipe = EndCloudPipeline(tm, tp, end_profile=thw.PROFILES[end],
                            cloud_profile=thw.PROFILES[cloud], codec_params=codec)
    assert pipe.split == jpipe.split == split
    assert pipe.tiers.compress == jpipe.tiers.compress == (0 < split < tm.cfg.block_repeat)
    tokens = (np.arange(2 * 32, dtype=np.int32).reshape(2, 32) * 7) % 500
    want, jmet = jpipe.run_batch(jnp.asarray(tokens))
    got, met = pipe.run_batch(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for key in ("split", "compressed", "boundary_bytes", "t_comm_s"):
        assert met[key] == jmet[key], key
    assert (pipe.link.bytes_up, pipe.link.transfers) == (jpipe.link.bytes_up,
                                                         jpipe.link.transfers)
