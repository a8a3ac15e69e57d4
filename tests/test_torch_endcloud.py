"""The port's one-shot two-tier path against the reference's
``serving/endcloud.py``: the capability model (eq. 3), the end-tier expert
mask (eq. 2-4), the tier planner with its split search (eq. 9-11) for
every pair of device profiles, and ``EndCloudPipeline.run_batch`` logits,
metrics and link meter on the same weights and codec (carried across with
``bridge.params_from_numpy``), in f32 on the CPU.

The planner is numpy arithmetic in the same order on both sides, so its
outputs are compared for equality.  Pipeline logits: f32 on both sides,
summed in other orders through 4 layers, held at rtol = atol = 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import hardware as jhw
from repro.core import selection as jsel
from repro.models.model import build_model
from repro.serving.endcloud import EndCloudPipeline as JPipeline
from repro.serving.endcloud import end_mask_from_state as jend_mask
from repro.serving.endcloud import plan_tiers as jplan_tiers
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import hardware as thw
from repro_torch.core import selection as tsel
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.lowrank import lowrank_decode, lowrank_encode
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.serving import EndCloudPipeline, LinkStats, plan_tiers
from repro_torch.serving.endcloud import end_mask_from_state, split_block_params

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

PROFILES = sorted(thw.PROFILES)
STATES = [thw.DeviceState(), thw.DeviceState(cpu_free=0.8, mem_free=0.6),
          thw.DeviceState(power_free=0.3, bandwidth_free=0.5)]


def _jstate(s):
    return jhw.DeviceState(**dataclasses.asdict(s))


def _configs():
    """(name, port config, reference config): full-width switch-base and
    mamba2-130m (the SSM planner's inputs), the smoke llama4-scout and
    tinyllama of the reference's own tests, and the smoke jamba-1.5-large
    (hybrid; at full width its experts fit on no xeon-4214r or phone-soc
    end, whose mask then selects none: both packages refuse that plan)."""
    out = [(name, get_config(name), jget(name)) for name in ("switch-base", "mamba2-130m")]
    for name in ("llama4-scout-17b-16e", "tinyllama-1.1b"):
        out.append((name, smoke_config(get_config(name)).replace(num_layers=4),
                    jsmoke(jget(name)).replace(num_layers=4)))
    out.append(("jamba-1.5-large-398b", smoke_config(get_config("jamba-1.5-large-398b")),
                jsmoke(jget("jamba-1.5-large-398b"))))
    return out


CONFIGS = _configs()


def test_profiles_and_capability_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in thw.PROFILES.items()} == {
        k: dataclasses.asdict(v) for k, v in jhw.PROFILES.items()}
    for name in PROFILES:
        for s in STATES:
            assert dataclasses.asdict(thw.capability(thw.PROFILES[name], s)) == \
                dataclasses.asdict(jhw.capability(jhw.PROFILES[name], _jstate(s)))


@pytest.mark.parametrize("name,cfg,jcfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_param_counts_equal_the_reference(name, cfg, jcfg):
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("name,cfg,jcfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_end_masks_equal_the_reference(name, cfg, jcfg):
    for prof in PROFILES:
        for s in STATES:
            got = end_mask_from_state(cfg, thw.PROFILES[prof], s)
            want = jend_mask(jcfg, jhw.PROFILES[prof], _jstate(s))
            if cfg.moe is None:
                assert got is None and want is None
                continue
            np.testing.assert_array_equal(got, np.asarray(want))
            m = cfg.moe
            direct = tsel.end_mask_for(thw.PROFILES[prof], s, cfg.d_model, m.d_ff_expert,
                                       m.num_experts, m.num_groups, gated=cfg.ffn_gated,
                                       group_priority=[3, 1, 0, 2])
            np.testing.assert_array_equal(direct, jsel.end_mask_for(
                jhw.PROFILES[prof], _jstate(s), cfg.d_model, m.d_ff_expert,
                m.num_experts, m.num_groups, gated=cfg.ffn_gated,
                group_priority=[3, 1, 0, 2]))


def _plans(cfg, jcfg, **kw):
    """Port and reference ``plan_tiers`` on the same inputs (a zero codec
    of rank d/2: the planner reads only its rank)."""
    rank = kw.pop("rank")
    codec = None if rank == 0 else {"enc": np.zeros((cfg.d_model, rank), np.float32)}
    state = kw.pop("end_state", thw.DeviceState())
    got = plan_tiers(Model(cfg, device="cpu"), codec_params=codec, end_state=state, **kw)
    jkw = {k: jhw.PROFILES[v.name] if k.endswith("profile") else v for k, v in kw.items()}
    want = jplan_tiers(build_model(jcfg), codec_params=codec, end_state=_jstate(state), **jkw)
    return got, want


def _assert_same_plan(got, want):
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan)
    assert (got.split, got.compress) == (want.split, want.compress)
    assert dataclasses.asdict(got.end_cap) == dataclasses.asdict(want.end_cap)
    assert dataclasses.asdict(got.cloud_cap) == dataclasses.asdict(want.cloud_cap)
    assert got.layer_gflops == want.layer_gflops
    assert (got.boundary_bytes, got.compression_ratio, got.alpha) == (
        want.boundary_bytes, want.compression_ratio, want.alpha)
    if want.end_mask is None:
        assert got.end_mask is None
    else:
        np.testing.assert_array_equal(got.end_mask.numpy(), np.asarray(want.end_mask))


@pytest.mark.parametrize("rank_frac", [0, 2])
@pytest.mark.parametrize("name,cfg,jcfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_plan_tiers_equal_the_reference_for_every_profile_pair(name, cfg, jcfg, rank_frac):
    rank = cfg.d_model // rank_frac if rank_frac else 0
    for end in PROFILES:
        for cloud in PROFILES:
            for state in STATES[:2]:
                got, want = _plans(cfg, jcfg, rank=rank, end_profile=thw.PROFILES[end],
                                   cloud_profile=thw.PROFILES[cloud], end_state=state)
                _assert_same_plan(got, want)


def test_switch_base_jetson_end_a100_cloud():
    """The chip run's deployment: split 1 of 6, codec on, 3 of 8 experts on
    the end tier."""
    cfg = get_config("switch-base")
    got, want = _plans(cfg, jget("switch-base"), rank=384, end_profile=thw.PROFILES["jetson-orin"],
                       cloud_profile=thw.PROFILES["a100"])
    _assert_same_plan(got, want)
    assert (got.split, got.compress, int(got.end_mask.sum())) == (1, True, 3)


@pytest.mark.parametrize("where", ["zero", "mid", "all"])
@pytest.mark.parametrize("name,cfg,jcfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_force_split_and_cloud_share(name, cfg, jcfg, where):
    R = cfg.block_repeat
    split = {"zero": 0, "mid": R // 2, "all": R}[where]
    for share in (1.0, 0.25):
        got, want = _plans(cfg, jcfg, rank=cfg.d_model // 4, end_profile=thw.PROFILES["jetson-orin"],
                           cloud_profile=thw.PROFILES["a100"], force_split=split,
                           cloud_share=share)
        _assert_same_plan(got, want)
        assert got.split == split
    with pytest.raises(ValueError, match="pin_split"):
        plan_tiers(Model(cfg, device="cpu"), end_profile=thw.PROFILES["a100"],
                   cloud_profile=thw.PROFILES["a100"], force_split=R + 1)


@pytest.mark.parametrize("pin_compress", [None, False, True])
@pytest.mark.parametrize("servers", [(1, 1), (3, 2)])
def test_plan_pipeline_split_options_equal_the_reference(servers, pin_compress):
    from repro.core.pipeline import plan_pipeline_split as jsplit
    from repro_torch.core.pipeline import plan_pipeline_split

    end_s, cloud_s = servers
    for end, cloud in (("jetson-orin", "a100"), ("xeon-4214r", "xeon-4214r")):
        caps = [thw.capability(thw.PROFILES[n], thw.DeviceState()) for n in (end, cloud)]
        jcaps = [jhw.capability(jhw.PROFILES[n], jhw.DeviceState()) for n in (end, cloud)]
        for edge in (False, True):
            kw = dict(compression_ratio=0.25, alpha=0.3, end_servers=end_s,
                      cloud_servers=cloud_s, edge_boundary=edge, pin_compress=pin_compress)
            layers = (0.5, 0.25, 1.0, 0.75)
            got = plan_pipeline_split(layers, 1536.0, *caps, **kw)
            want = jsplit(layers, 1536.0, *jcaps, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert (got.est_step_time_s, got.est_latency_s) == (
                want.est_step_time_s, want.est_latency_s)


def test_all_false_end_mask_is_rejected():
    cfg = smoke_config(get_config("llama4-scout-17b-16e"))
    with pytest.raises(ValueError, match="selects no experts"):
        plan_tiers(Model(cfg, device="cpu"), end_profile=thw.PROFILES["a100"],
                   cloud_profile=thw.PROFILES["a100"], end_mask=np.zeros(8, bool))


def test_split_block_params():
    cfg = smoke_config(get_config("tinyllama-1.1b")).replace(num_layers=4)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0))
    end, cloud = split_block_params(params, 1)
    assert end["blocks"]["pos0"]["attn"]["wq"].shape[0] == 1
    assert cloud["blocks"]["pos0"]["attn"]["wq"].shape[0] == 3
    assert "lm_head" in cloud and "embed" in end and "lm_head" not in end


# --- the pipeline on bridged weights -----------------------------------------

PIPELINES = [
    # (config, compression rank (None = d_model), end profile, cloud profile,
    #  the split the planner picks: all-end, interior or all-cloud)
    ("llama4-scout-17b-16e", 0, "a100", "xeon-4214r", "all"),
    ("llama4-scout-17b-16e", 32, "jetson-orin", "a100", "mid"),
    ("tinyllama-1.1b", None, "a100", "a100", "zero"),
]


@pytest.fixture(scope="module", params=PIPELINES, ids=[f"{p[0]}-r{p[1]}" for p in PIPELINES])
def pipelines(request):
    """The reference pipeline and the port's on the same f32 weights and
    codec (the reference's own, drawn from its seed, carried across)."""
    name, rank, end, cloud, where = request.param
    jcfg = jsmoke(jget(name)).replace(num_layers=4, dtype="float32")
    cfg = smoke_config(get_config(name)).replace(num_layers=4, dtype="float32")
    rank = cfg.d_model if rank is None else rank
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jpipe = JPipeline(jmodel, jparams, compression_rank=rank,
                      end_profile=jhw.PROFILES[end], cloud_profile=jhw.PROFILES[cloud])
    codec = None if jpipe.codec is None else jax.tree.map(np.asarray, jpipe.codec)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    pipe = EndCloudPipeline(
        Model(cfg, device="cpu"), params, end_profile=thw.PROFILES[end],
        cloud_profile=thw.PROFILES[cloud],
        codec_params=None if codec is None else params_from_numpy(codec, "cpu"))
    return jpipe, pipe, where


def test_pipeline_matches_reference(pipelines):
    jpipe, pipe, where = pipelines
    R = pipe.cfg.block_repeat
    assert pipe.split == jpipe.split == {"zero": 0, "mid": 1, "all": R}[where]
    tokens = np.arange(2 * 32, dtype=np.int32).reshape(2, 32) % 500
    want, jm = jpipe.run_batch(jnp.asarray(tokens))
    before = (flash_attention_fwd.launches, lowrank_encode.launches, lowrank_decode.launches)
    got, m = pipe.run_batch(torch.from_numpy(tokens))
    # the CPU runs plain versions: no kernel launches
    assert (flash_attention_fwd.launches, lowrank_encode.launches,
            lowrank_decode.launches) == before
    assert got.shape == (2, 32, pipe.cfg.padded_vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert set(m) == set(jm)
    for key in ("split", "compressed", "boundary_bytes", "t_comm_s"):
        assert m[key] == jm[key], key
    # only an interior boundary is compressed (a full-rank codec never pays)
    assert m["compressed"] == (where == "mid")
    width = pipe.codec["enc"].shape[1] if m["compressed"] else pipe.cfg.d_model
    assert m["boundary_bytes"] == 2 * 32 * width * 4
    assert _link_fields(pipe.link) == _link_fields(jpipe.link)
    if pipe.end_mask is not None:
        np.testing.assert_array_equal(pipe.end_mask.numpy(), np.asarray(jpipe.end_mask))


def _link_fields(link):
    """Every field of a link meter, the peer meter's too."""
    return {f.name: getattr(link, f.name) for f in dataclasses.fields(link)}


def test_link_stats_equal_the_reference():
    from repro.serving.common import LinkStats as JLinkStats

    got, want = LinkStats(), JLinkStats()
    for nbytes, gbps in ((4096, 0.1), (1 << 20, 0.3), (7, 50.0)):
        assert got.record_up(nbytes, gbps) == want.record_up(nbytes, gbps)
        got.record_down(nbytes // 7)
        want.record_down(nbytes // 7)
        got.record_peer(nbytes, nbytes * 1e-9)
        want.record_peer(nbytes, nbytes * 1e-9)
    assert _link_fields(got) == _link_fields(want)
    assert set(_link_fields(got)) == {"bytes_up", "bytes_down", "bytes_peer", "transfers",
                                      "seconds_up", "seconds_peer"}


def test_pipeline_default_codec_and_refusals():
    """Without ``codec_params`` a rank > 0 draws the port's own orthonormal
    codec (seed 7, on the CPU); an M-RoPE config runs, its text positions
    on all three axes, so its logits are the plain-RoPE ones bit for bit;
    the hard group restriction is not ported and raises."""
    cfg = smoke_config(get_config("llama4-scout-17b-16e")).replace(num_layers=4, dtype="float32")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prof = dict(end_profile=thw.PROFILES["a100"], cloud_profile=thw.PROFILES["a100"])
    pipe = EndCloudPipeline(model, params, compression_rank=16, **prof)
    enc = pipe.codec["enc"]
    torch.testing.assert_close(enc.T @ enc, torch.eye(16), rtol=0, atol=1e-5)
    logits, m = pipe.run_batch(np.zeros((1, 8), np.int32))
    assert m["compressed"] and m["boundary_bytes"] == 8 * 16 * 4
    assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    mrope = EndCloudPipeline(Model(cfg.replace(mrope_sections=(4, 6, 6)), device="cpu"),
                             params, compression_rank=16, **prof)
    assert torch.equal(mrope.run_batch(np.zeros((1, 8), np.int32))[0], logits)
    hard = cfg.replace(moe=dataclasses.replace(cfg.moe, group_top_k=1))
    with pytest.raises(NotImplementedError, match="group_top_k"):
        EndCloudPipeline(Model(hard, device="cpu"), params, **prof).run_batch(
            np.zeros((1, 8), np.int32))


def test_apply_layer_full_refuses_unported_branches():
    """An attention layer with and without ``collect_cache``; an SSM layer
    and a cross-attention layer (ported with the encoder-decoder) equal to
    the reference's, their collected caches too."""
    cfg = smoke_config(get_config("tinyllama-1.1b"))
    spec = cfg.layer_pattern[0]
    p = transformer.block_params(
        transformer.init_params(cfg, torch.Generator().manual_seed(0))["blocks"], 0)["pos0"]
    x = torch.zeros(1, 4, cfg.d_model)
    angles = torch.zeros(1, 4, cfg.head_dim // 2)
    y, aux, entry = transformer.apply_layer_full(p, x, spec, cfg, angles)
    assert y.shape == x.shape and aux == {} and entry == {}
    # collect_cache (ported with speculative decode's draft caches): the
    # layer's k/v in fresh dense rings of max_len, the rest zeros
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y2, _, entry = transformer.apply_layer_full(p, x, spec, cfg, angles, collect_cache=True,
                                                max_len=8)
    h = transformer.rms_norm(x, p["norm1"], cfg.norm_eps)
    _, k, v = transformer.attn.project_qkv(p["attn"], h, cfg, angles)
    assert torch.equal(y2, transformer.apply_layer_full(p, x, spec, cfg, angles)[0])
    for name, want in (("k", k), ("v", v)):
        ring = entry[name]
        assert ring.shape == (1, 8, cfg.num_kv_heads, cfg.head_dim)
        assert torch.equal(ring[:, :4], want.to(ring.dtype)) and not ring[:, 4:].any()
    from repro.models import transformer as jtransformer

    layer = jax.jit(jtransformer.apply_layer_full, static_argnums=(2, 3, 4),
                    static_argnames=("train", "collect_cache", "max_len"))
    # a cross-attention layer (whisper smoke's) over 64 encoder frames
    # equals the reference's, its rings and cross cache (xk, xv) too
    wcfg = smoke_config(get_config("whisper-base")).replace(dtype="float32")
    wspec = wcfg.layer_pattern[0]
    wp = transformer.block_params(
        transformer.init_params(wcfg, torch.Generator().manual_seed(4))["blocks"], 0)["pos0"]
    enc = torch.randn(1, wcfg.encoder_seq_len, wcfg.d_model,
                      generator=torch.Generator().manual_seed(5))
    yw, _, entry = transformer.apply_layer_full(wp, x, wspec, wcfg, angles, enc_out=enc,
                                                collect_cache=True, max_len=8)
    jyw, _, jentry = layer(jax.tree.map(lambda t: jnp.asarray(t.numpy()), wp), x.numpy(), wspec,
                           jsmoke(jget("whisper-base")).replace(dtype="float32"), None,
                           angles.numpy(), enc_out=enc.numpy(), train=False,
                           collect_cache=True, max_len=8)
    np.testing.assert_allclose(yw.numpy(), np.asarray(jyw), rtol=1e-5, atol=1e-5)
    assert set(entry) == set(jentry) == {"k", "v", "xk", "xv"}
    for name, want in jentry.items():
        assert tuple(entry[name].shape) == want.shape
        np.testing.assert_allclose(entry[name].numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # an SSM layer (mamba2 smoke's) equals the reference's, its collected
    # state and conv tails too

    scfg = smoke_config(get_config("mamba2-130m")).replace(dtype="float32")
    sspec = scfg.layer_pattern[0]
    sp = transformer.block_params(
        transformer.init_params(scfg, torch.Generator().manual_seed(2))["blocks"], 0)["pos0"]
    jsp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), sp)
    xs = torch.randn(2, 8, scfg.d_model, generator=torch.Generator().manual_seed(3))
    sangles = torch.zeros(2, 8, scfg.head_dim // 2)
    ys, aux, entry = transformer.apply_layer_full(sp, xs, sspec, scfg, sangles,
                                                  collect_cache=True, max_len=8)
    jys, jaux, jentry = layer(
        jsp, xs.numpy(), sspec, jsmoke(jget("mamba2-130m")).replace(dtype="float32"), None,
        sangles.numpy(), train=False, collect_cache=True, max_len=8)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-4, atol=1e-4)
    assert aux == {} and set(entry) == set(jentry) == {"ssm", "conv_x", "conv_bc"}
    for name, want in jentry.items():
        assert tuple(entry[name].shape) == want.shape
        np.testing.assert_allclose(entry[name].numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
