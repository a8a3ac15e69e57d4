"""The MoE dispatch codec (eq. 8 on the expert dispatch) in the port,
against the reference on the same weights (``bridge.params_from_numpy``
carries the reference's codec across; no torch generator reproduces its
draw): the consumer-form roundtrip's plain version against
``core/compression.py``'s ``roundtrip_1d`` and ``recon_loss``;
``moe_sorted`` and ``moe_resident`` with a codec (output, ``recon_loss``,
``aux_loss``); the model's prefill-chunk and decode steps; the paged
``ServingEngine``'s greedy tokens; the streaming ``EndCloudServingEngine``
at forced splits 0, 1 and 2 (tokens, link meters, pool counters,
metrics); the plan rule; and the codec through the tier split and the
pooled end tier's strip.  On the CPU the wrappers run their plain
versions; the CUDA kernel is held against them on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances:
- f32: both sides sum in f32 in other orders (the codec's two products,
  the expert FFN's grouped product): the roundtrip and ``recon_loss`` at
  rtol 1e-5 (atol 1e-5 for values near zero); the MoE layer's output at
  rtol 1e-5 with an atol of 1e-5 times its largest value (its expert
  outputs sum over d_ff); model logits at 1e-4, as
  ``tests/test_torch_serving.py`` holds them.
- bf16: one rounding of the same f32 sums can land one bf16 ulp apart
  (Z, and X̂ after it): X̂ at rtol 2^-7 plus 2^-7 of its largest value;
  ``recon_loss`` at rtol 2^-6 (a mean over many elements of which a few
  sit one ulp apart); the MoE layer's bf16 output at rtol 2^-6 plus 2^-6
  of its largest value (bf16 rounds after each product of the expert FFN
  and the codec, a few ulps in all).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CompressionConfig as JCompression
from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import compression as jcomp
from repro.core import expertpool as jep
from repro.core import hardware as jhw
from repro.core import moe as jmoe
from repro.models.model import build_model
from repro.serving.common import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.stream import EndCloudServingEngine as JEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import CompressionConfig, get_config, smoke_config
from repro_torch.core import compression as tcomp
from repro_torch.core import hardware as thw
from repro_torch.core import moe as tmoe
from repro_torch.kernels.lowrank import (
    lowrank_roundtrip_loss,
    lowrank_roundtrip_loss_plain,
    roundtrip_plan,
)
from repro_torch.models import kvcache as tkv
from repro_torch.models import transformer
from repro_torch.models.model import Model
from repro_torch.serving import EndCloudServingEngine, Request, ServingEngine
from repro_torch.serving.endcloud import split_block_params, strip_expert_weights

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
NAMES = ("switch-base", "llama4-scout-17b-16e")
RECON_WEIGHT = 0.05  # the benchmarks' ec2moe system (benchmarks/common.py)
WALL_CLOCK = {"link_blackout_s"}  # the only metric that reads the host clock


def _codec_cfgs(name, *, rank=None, dtype="float32", **replace):
    """(reference config, port config): smoke ``name`` with the ec2moe
    system's dispatch codec (rank d_model // 2 unless given)."""
    jcfg = jsmoke(jget(name)).replace(dtype=dtype, param_dtype="float32", **replace)
    cfg = smoke_config(get_config(name)).replace(dtype=dtype, param_dtype="float32", **replace)
    r = cfg.d_model // 2 if rank is None else rank
    jcfg = jcfg.replace(compression=JCompression(rank=r, boundaries=("dispatch",),
                                                 recon_weight=RECON_WEIGHT))
    cfg = cfg.replace(compression=CompressionConfig(rank=r, boundaries=("dispatch",),
                                                    recon_weight=RECON_WEIGHT))
    return jcfg, cfg


def _np(a):
    return np.asarray(a, np.float32)


def _x(T, d, seed):
    return np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)


def _close_rows(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7 * np.abs(want).max())


# -- the consumer's roundtrip -----------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,d,r", [(1, 128, 64), (8, 128, 64), (37, 96, 24), (130, 128, 128)])
def test_roundtrip_loss_matches_reference(T, d, r, dtype):
    """``roundtrip_loss_1d`` (the plain version of the fused kernel on the
    CPU) against the reference's ``roundtrip_1d`` then ``recon_loss``; at
    r = d the codec is orthonormal and square, so X̂ is X."""
    jdt, tdt = DTYPES[dtype]
    jp = jcomp.init_lowrank_1d(jax.random.PRNGKey(7), d, r)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = _x(T, d, seed=T)
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    want = jcomp.roundtrip_1d(jp, xj)
    want_loss = float(jcomp.recon_loss(xj, want))
    got, loss = tcomp.roundtrip_loss_1d(tp, xt)
    assert got.dtype == tdt and got.shape == xt.shape and loss.dtype == torch.float32
    _close_rows(got.float(), want, dtype)
    np.testing.assert_allclose(float(loss), want_loss,
                               rtol=1e-5 if dtype == "float32" else 2 ** -6, atol=1e-7)
    # the fused form's sum is T*d times its mean, over its own (rounded) X̂
    x_hat, sq, mean = lowrank_roundtrip_loss(xt, tp["enc"].to(tdt), tp["dec"].to(tdt))
    assert torch.equal(x_hat, got)
    np.testing.assert_allclose(float(sq), float(mean) * T * d, rtol=1e-6)
    own = float((xt.float() - x_hat.float()).square().mean())
    np.testing.assert_allclose(float(mean), own, rtol=1e-5)
    assert torch.equal(tcomp.roundtrip_1d(tp, xt), got)


def test_roundtrip_rounds_z_between_the_products():
    """bf16: Z is rounded to bf16 before the decode (the consumer's form),
    not kept in f32 as the reference kernel's contract keeps it."""
    d, r = 128, 64
    jp = jcomp.init_lowrank_1d(jax.random.PRNGKey(7), d, r)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = torch.from_numpy(_x(16, d, seed=3)).bfloat16()
    enc, dec = tp["enc"].bfloat16(), tp["dec"].bfloat16()
    x_hat, _, _ = lowrank_roundtrip_loss_plain(x, enc, dec)
    z = (x.float() @ enc.float()).bfloat16()
    assert torch.equal(x_hat, (z.float() @ dec.float()).bfloat16())
    unrounded = ((x.float() @ enc.float()) @ dec.float()).bfloat16()
    assert not torch.equal(x_hat, unrounded)


@pytest.mark.parametrize("r,plan", [(1, "fused"), (64, "fused"), (384, "fused"), (512, "fused"),
                                    (513, "composed"), (640, "composed")])
def test_roundtrip_plan_rule(r, plan):
    """One launch where the rank spans at most 8 column tiles of 64 (a
    cluster), composed beyond: by the rank alone."""
    assert roundtrip_plan(r) == plan


@pytest.mark.parametrize("nt,r,dtype,split", [
    (1, 384, torch.bfloat16, 2), (8, 384, torch.bfloat16, 2), (256, 384, torch.bfloat16, 2),
    (257, 384, torch.bfloat16, 1), (1024, 384, torch.bfloat16, 1),  # many clusters already
    (8, 100, torch.bfloat16, 2), (8, 512, torch.bfloat16, 1),  # 16 blocks: past the rule's 12
    (8, 384, torch.float32, 1),  # the f32 form has no split
])
def test_roundtrip_split_rule(nt, r, dtype, split):
    """The bf16 launch splits phase 1's K over two blocks a column tile
    where the cluster stays within 12 blocks and the grid within 4 row
    tiles: by the shape alone."""
    from repro_torch.kernels.lowrank import ops

    assert ops.roundtrip_split(nt, r, dtype) == split


def test_roundtrip_composed_wide_rank_matches_fused_plain():
    """r = 640 (10 column tiles): ``roundtrip_loss_1d`` composes encode,
    decode and the loss, and gives the fused plain version's numbers."""
    d, r = 768, 640
    tp = tcomp.init_lowrank_1d(torch.Generator().manual_seed(0), d, r)
    x = torch.from_numpy(_x(6, d, seed=1)).bfloat16()
    got, loss = tcomp.roundtrip_loss_1d(tp, x)
    want, _, want_loss = lowrank_roundtrip_loss_plain(x, tp["enc"].bfloat16(),
                                                      tp["dec"].bfloat16())
    assert torch.equal(got, want)
    torch.testing.assert_close(loss, want_loss, rtol=1e-6, atol=0)


# -- the MoE layer ----------------------------------------------------------


def _moe_params(jcfg, seed):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _close_moe(got, want, dtype):
    got, want = _np(got), _np(want)
    tol = 1e-5 if dtype == "float32" else 2 ** -6
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _close_loss(got, want, dtype):
    np.testing.assert_allclose(float(got), float(want),
                               rtol=1e-5 if dtype == "float32" else 2 ** -6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,top_k", [("switch-base", 1), ("llama4-scout-17b-16e", 1),
                                        ("switch-base", 2)])
def test_moe_sorted_codec_matches_reference(name, top_k, dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg, cfg = _codec_cfgs(name, dtype=dtype)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, top_k=top_k))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, top_k=top_k))
    p, tp = _moe_params(jcfg, seed=1)
    assert p["codec"]["enc"].shape == (cfg.d_model, cfg.d_model // 2)
    x = _x(20, cfg.d_model, seed=2)
    want, jaux = jmoe.moe_sorted(p, jnp.asarray(x).astype(jdt), jcfg)
    got, aux = tmoe.moe_sorted(tp, torch.from_numpy(x).to(tdt), cfg)
    assert got.dtype == tdt
    _close_moe(got.float(), want, dtype)
    _close_loss(aux["recon_loss"], jaux["recon_loss"], dtype)
    _close_loss(aux["aux_loss"], jaux["aux_loss"], dtype)
    assert float(aux["recon_loss"]) > 0
    # serving: the same output, the losses left out
    served, saux = tmoe.moe_sorted(tp, torch.from_numpy(x).to(tdt), cfg, aux=False)
    assert torch.equal(served, got) and "recon_loss" not in saux


def _resident_codec_case(jcfg, resident, seed):
    """Layer 0 of a slab pool holds ``resident`` experts (the reference's
    weights written into its store) beside the layer's gate and codec."""
    E = jcfg.moe.num_experts
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    pool = jep.ExpertSlabPool(E, n_layers=1, num_experts=E, max_per_layer=E)
    for e in resident:
        pool.alloc(0, e)
    full = {k: p[k][None] for k in ("wi", "wg", "wo") if k in p}
    store = jep.write_slabs(jep.init_slab_store(jcfg, E), full,
                            [(int(pool.table[0, e]), 0, e) for e in resident])
    t = jep.device_resident_tables(pool, [0], len(resident) + 1)
    jres = {"gate": p["gate"], "codec": p["codec"],
            "resident": {"ids": t["ids"][0], "slot": t["slot"][0], "store": store}}
    return jres, params_from_numpy(jax.tree.map(np.asarray, jres), "cpu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,resident,mask", [
    ("switch-base", [0, 1, 4], [0, 1, 4]),
    ("switch-base", [0, 4], [0, 1, 4]),  # expert 1 is routed away: garbage-slot rows
    ("llama4-scout-17b-16e", [3, 7], None),
])
def test_moe_resident_codec_matches_reference(name, resident, mask, dtype):
    """Every dispatched row goes through the codec, rows on the garbage slot
    too, and the expert outputs after the unsort."""
    jdt, tdt = DTYPES[dtype]
    jcfg, cfg = _codec_cfgs(name, dtype=dtype)
    jres, tres = _resident_codec_case(jcfg, resident, seed=3)
    E = cfg.moe.num_experts
    m = None if mask is None else np.isin(np.arange(E), mask)
    x = _x(16, cfg.d_model, seed=4)
    want, jaux = jmoe.moe_resident(jres, jnp.asarray(x).astype(jdt), jcfg,
                                   None if m is None else jnp.asarray(m))
    tm = None if m is None else torch.from_numpy(m)
    got, aux = tmoe.moe_resident(tres, torch.from_numpy(x).to(tdt), cfg, tm, aux=True)
    _close_moe(got.float(), want, dtype)
    _close_loss(aux["recon_loss"], jaux["recon_loss"], dtype)
    _close_loss(aux["aux_loss"], jaux["aux_loss"], dtype)
    served, saux = tmoe.moe_resident(tres, torch.from_numpy(x).to(tdt), cfg, tm)
    assert torch.equal(served, got) and set(saux) == {"topk_idx"}


def _port_moe(rank, seed=0):
    """The shape of ``tests/test_moe.py``'s layer (8 experts in 4 groups,
    top-2, gated; the port has no qwen3-moe config, so smoke llama4-scout
    stands in) in the port, its params from a torch generator."""
    cfg = smoke_config(get_config("llama4-scout-17b-16e"))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=8, num_groups=4, top_k=2,
                                              capacity_factor=4.0),
                      ffn_gated=True, compression=None)
    if rank:
        cfg = cfg.replace(compression=CompressionConfig(rank=rank, boundaries=("dispatch",)))
    return cfg, tmoe.init_moe(torch.Generator().manual_seed(seed), cfg)


def test_dispatch_codec_recon_tracked():
    """Port of ``tests/test_moe.py::test_dispatch_codec_recon_tracked``: the
    reconstruction term is positive for a truncating codec, ~zero at full
    rank (d_model 128)."""
    errs = {}
    for rank in (8, 128):
        cfg, params = _port_moe(rank)
        assert params["codec"]["enc"].shape == (128, rank)
        x = torch.randn(32, cfg.d_model, generator=torch.Generator().manual_seed(1))
        _, aux = tmoe.moe_sorted(params, x, cfg)
        errs[rank] = float(aux["recon_loss"])
    assert errs[128] < 1e-6
    assert errs[8] > 1e-2


def test_full_rank_codec_identity_output():
    """Port of ``tests/test_moe.py::test_full_rank_codec_identity_output``:
    a full-rank codec leaves the layer's output as it is."""
    cfg, p = _port_moe(128)
    plain_cfg = cfg.replace(compression=None)
    p_plain = {k: v for k, v in p.items() if k != "codec"}
    x = torch.randn(16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    y1, _ = tmoe.moe_sorted(p_plain, x, plain_cfg)
    y2, _ = tmoe.moe_sorted(p, x, cfg)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-3, atol=1e-4)


def test_init_moe_codec_per_block():
    """``init_moe`` draws one orthonormal codec a block over the lead dims,
    in f32, the decoder the encoder's transpose."""
    cfg, _ = _port_moe(16)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg, lead=(3,))
    enc, dec = p["codec"]["enc"], p["codec"]["dec"]
    assert enc.shape == (3, 128, 16) and dec.shape == (3, 16, 128)
    assert enc.dtype == torch.float32 and enc.is_contiguous() and dec.is_contiguous()
    for i in range(3):
        torch.testing.assert_close(enc[i].T @ enc[i], torch.eye(16), rtol=0, atol=1e-5)
        assert torch.equal(dec[i], enc[i].T)
    assert not torch.equal(enc[0], enc[1])
    assert "codec" not in tmoe.init_moe(torch.Generator().manual_seed(0), _port_moe(0)[0])


# -- the model, the serving engine ------------------------------------------


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    """(reference model, params), (port model, the same params): 4-layer
    smoke f32 with the dispatch codec."""
    jcfg, cfg = _codec_cfgs(request.param, num_layers=4)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return (jm, jp), (Model(cfg, device="cpu"), params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))


def test_compute_params_keeps_the_codec_in_the_activation_type(pair):
    """The dispatch codec gains ``enc_act`` / ``dec_act`` (the activation
    type's cast, made once) beside its f32 ``enc`` / ``dec``."""
    _, (tm, tp) = pair
    bf = tm.cfg.replace(dtype="bfloat16")
    cp = transformer.compute_params(tp, bf)
    for pos, layer in cp["blocks"].items():
        if "moe" not in layer:
            continue
        codec, src = layer["moe"]["codec"], tp["blocks"][pos]["moe"]["codec"]
        assert codec["enc"] is src["enc"] and codec["enc"].dtype == torch.float32
        for k in ("enc", "dec"):
            assert codec[f"{k}_act"].dtype == torch.bfloat16
            assert torch.equal(codec[f"{k}_act"], src[k].bfloat16())


def test_step_logits_match_reference(pair):
    """One prefill chunk then one decode step, logits compared directly
    (``tests/test_torch_serving.py``'s harness, the codec on)."""
    from repro.models import kvcache as jkv

    (jm, jp), (tm, tp) = pair
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
    # the codec is on the path: without it the logits move
    no_codec = {**tp, "blocks": {k: {**v, "moe": {n: w for n, w in v["moe"].items()
                                                  if n != "codec"}} if "moe" in v else v
                                 for k, v in tp["blocks"].items()}}
    tpages2 = tkv.init_paged_blocks(cfg, cfg.block_repeat, 6, ps, torch.float32, "cpu")
    tl3, _ = tm.prefill_chunk_step(no_codec, torch.from_numpy(chunk), tpages2, table,
                                   torch.from_numpy(i32([0])), torch.from_numpy(i32([10])),
                                   page_size=ps)
    assert float((tl3 - tl).abs().max()) > 1e-3


def _workload(cls, n=9, seed=0, lo=4, hi=16, new=6):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, 500, size=rng.integers(lo, hi)).astype(np.int32),
                max_new_tokens=new) for i in range(n)]


def test_serving_engine_greedy_tokens_match_reference(pair):
    (jm, jp), (tm, tp) = pair
    out = []
    for eng_cls, req_cls, m, p in ((JServingEngine, JRequest, jm, jp),
                                   (ServingEngine, Request, tm, tp)):
        reqs = _workload(req_cls)
        eng = eng_cls(m, p, max_batch=4, max_len=64, prefill_chunk=8)
        for r in reqs:
            eng.submit(r)
        eng.run()
        out.append([r.generated for r in reqs])
    assert out[1] == out[0]
    assert eng.pool.pages_in_use == 0


# -- the streaming two-tier engine ------------------------------------------


@pytest.fixture(scope="module")
def stream_pair():
    """4-layer smoke switch-base (2 blocks) with the dispatch codec, f32."""
    jcfg, cfg = _codec_cfgs("switch-base", num_layers=4)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return (jm, jp), (Model(cfg, device="cpu"), params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))


def _run_stream(side, pair, split):
    """``tests/test_torch_stream.py``'s harness: 5 requests on the a100
    pair at a forced split, the end tier pooled, modeled timing."""
    (jm, jp), (tm, tp) = pair
    jx = side == "jax"
    hw = jhw if jx else thw
    eng = (JEngine if jx else EndCloudServingEngine)(
        jm if jx else tm, jp if jx else tp, end_profile=hw.PROFILES["a100"],
        cloud_profile=hw.PROFILES["a100"], max_batch=4, max_len=64, timing="modeled",
        force_split=split)
    rng = np.random.default_rng(0)
    reqs = [(JRequest if jx else Request)(
        i, rng.integers(0, 500, size=int(rng.integers(4, 16))).astype(np.int32),
        max_new_tokens=8) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    tick = 0
    while eng.busy():
        eng.step()
        tick += 1
        assert tick < 500
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("split", [0, 1, 2])
def test_stream_engine_codec_matches_reference(stream_pair, split):
    jtok, jeng = _run_stream("jax", stream_pair, split)
    ttok, teng = _run_stream("torch", stream_pair, split)
    assert teng.split == split and teng.expert_pool is not None
    assert ttok == jtok
    assert (teng.link.bytes_up, teng.link.bytes_down, teng.link.transfers) == (
        jeng.link.bytes_up, jeng.link.bytes_down, jeng.link.transfers)
    assert (teng.n_stage_steps, teng.n_prefill_chunks) == (jeng.n_stage_steps,
                                                           jeng.n_prefill_chunks)
    assert (teng.n_expert_evictions, teng.n_expert_prefetches, teng.expert_bytes_down) == (
        jeng.n_expert_evictions, jeng.n_expert_prefetches, jeng.expert_bytes_down)
    jm_, tm_ = jeng.metrics(), teng.metrics()
    assert set(tm_) == set(jm_)
    assert {k: tm_[k] for k in tm_ if k not in WALL_CLOCK} == {
        k: jm_[k] for k in jm_ if k not in WALL_CLOCK}
    assert teng.end_pool.pages_in_use == teng.cloud_pool.pages_in_use == 0


def test_codec_survives_tier_split_and_strip(stream_pair):
    """The split cuts the codec with every other stacked leaf (views of the
    block rows); the pooled end tier's strip drops only ``wi``/``wg``/``wo``."""
    _, (tm, tp) = stream_pair
    cfg = tm.cfg
    cp = transformer.compute_params(tp, cfg)
    end, cloud = split_block_params(cp, 1)
    moe_pos = [f"pos{i}" for i, s in enumerate(cfg.layer_pattern) if s.moe]
    for pos in moe_pos:
        full = cp["blocks"][pos]["moe"]["codec"]
        for tier, rows in ((end, slice(0, 1)), (cloud, slice(1, None))):
            codec = tier["blocks"][pos]["moe"]["codec"]
            assert set(codec) == {"enc", "dec", "enc_act", "dec_act"}
            for k, v in codec.items():
                assert torch.equal(v, full[k][rows])
                assert v.data_ptr() == full[k][rows].data_ptr()  # a view, no copy
        stripped = strip_expert_weights(end, cfg)["blocks"][pos]["moe"]
        assert set(stripped) == set(end["blocks"][pos]["moe"]) - {"wi", "wg", "wo"}
        assert stripped["codec"] is end["blocks"][pos]["moe"]["codec"]
