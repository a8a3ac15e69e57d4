"""The port's MoE layer against the reference's ``core/moe.py``: the
grouped expert FFN over expert-sorted rows (empty groups included), the
sorted and naive paths, the shared expert, and ``apply_moe``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import moe as jmoe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import CompressionConfig, get_config, smoke_config
from repro_torch.core import gating as tg
from repro_torch.core import moe as tmoe
from repro_torch.distributed.topology import Topology, single_device_topology

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

# f32 on both sides; ragged_dot and the per-group matmuls sum in other orders
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(name, **moe_kw):
    jcfg = jsmoke(jget(name)).replace(dtype="float32")
    cfg = smoke_config(get_config(name)).replace(dtype="float32")
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _params(jcfg, seed=0):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("name,sizes", [
    ("switch-base", [3, 0, 2, 0, 1, 1, 0, 1]),  # non-gated GELU, empty groups
    ("llama4-scout-17b-16e", [0, 5, 0, 0, 2, 0, 0, 1]),  # gated SiLU
    ("switch-base", [6, 0, 0, 0, 0, 0, 0, 0]),  # every row on one expert
])
def test_grouped_mlp_matches_reference(name, sizes):
    jcfg, cfg = _cfgs(name)
    p, tp = _params(jcfg)
    n = sum(sizes) + 2  # two rows past sum(group_sizes): both come back 0
    xs = np.random.default_rng(0).standard_normal((n, cfg.d_model)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = jmoe._grouped_mlp(jnp.asarray(xs), jnp.asarray(gs), p["wi"], p.get("wg"),
                             p["wo"], jcfg.act)
    got = tmoe._grouped_mlp(torch.from_numpy(xs), torch.from_numpy(gs), tp["wi"],
                            tp.get("wg"), tp["wo"], cfg.act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy()[-2:], 0.0)


@pytest.mark.parametrize("name,top_k", [("switch-base", 1), ("llama4-scout-17b-16e", 1),
                                        ("switch-base", 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_sorted_and_naive_match_reference(name, top_k, masked):
    jcfg, cfg = _cfgs(name, top_k=top_k)
    p, tp = _params(jcfg, seed=1)
    x = np.random.default_rng(1).standard_normal((20, cfg.d_model)).astype(np.float32)
    m = np.asarray([1, 0, 0, 0, 1, 1, 0, 1], bool) if masked else None
    jm = None if m is None else jnp.asarray(m)
    tm = None if m is None else torch.from_numpy(m)
    want_s, jaux = jmoe.moe_sorted(p, jnp.asarray(x), jcfg, jm)
    got_s, aux = tmoe.moe_sorted(tp, torch.from_numpy(x), cfg, tm)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_allclose(aux["aux_loss"].item(), float(jaux["aux_loss"]), rtol=1e-5)
    want_n, _ = jmoe.moe_naive(p, jnp.asarray(x), jcfg, jm)
    got_n, _ = tmoe.moe_naive(tp, torch.from_numpy(x), cfg, tm)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), **TOL)
    np.testing.assert_allclose(got_s.numpy(), got_n.numpy(), **TOL)


@pytest.mark.parametrize("impl", ["sorted", "naive"])
def test_apply_moe_with_shared_expert(impl):
    """llama4-scout's always-on shared expert is added on both paths."""
    jcfg, cfg = _cfgs("llama4-scout-17b-16e")
    jcfg, cfg = jcfg.replace(moe_impl=impl), cfg.replace(moe_impl=impl)
    p, tp = _params(jcfg, seed=2)
    assert "shared" in tp
    x = np.random.default_rng(2).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want, jaux = jmoe.apply_moe(p, jnp.asarray(x), jcfg, None, train=False)
    got, aux = tmoe.apply_moe(tp, torch.from_numpy(x), cfg, train=False)
    # serving drops the losses and returns the routed ids, which count the
    # reference's routing statistics
    assert got.shape == x.shape and set(aux) == {"topk_idx"}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stats = tg.routing_stats(aux["topk_idx"], cfg.moe.num_experts, cfg.moe.num_groups)
    for k in stats:
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jaux[k]), rtol=1e-6)


def test_codec_and_unported_paths_raise():
    """The dispatch codec is ported (held to the reference in
    ``tests/test_torch_dispatch.py``): a layer with one runs it.  The
    expert-parallel bodies need a topology (``tests/test_torch_ep.py``):
    without one, ``a2a`` and ``tp`` raise the reference's ``ValueError``,
    as does a single-shard impl on an expert-parallel topology."""
    _, cfg = _cfgs("switch-base")
    _, tp = _params(_cfgs("switch-base")[0])
    x = torch.zeros(4, cfg.d_model)
    eye = torch.eye(cfg.d_model)
    cfg_codec = cfg.replace(compression=CompressionConfig(rank=cfg.d_model,
                                                          boundaries=("dispatch",)))
    y, aux = tmoe.moe_sorted({**tp, "codec": {"enc": eye, "dec": eye}}, x, cfg_codec)
    assert y.shape == x.shape and float(aux["recon_loss"]) == 0.0
    for impl in ("a2a", "tp"):
        with pytest.raises(ValueError, match=f"unknown moe impl '{impl}'"):
            tmoe.apply_moe(tp, x, cfg.replace(moe_impl=impl))
        with pytest.raises(ValueError, match=f"unknown moe impl '{impl}'"):
            tmoe.apply_moe(tp, x, cfg.replace(moe_impl=impl), single_device_topology())
    with pytest.raises(ValueError, match="expert-parallel topology"):
        tmoe.apply_moe(tp, x, cfg.replace(moe_impl="sorted"),
                       Topology(mesh_shape=(1, 4), coords=(0, 0)))


def test_init_moe_shapes_and_scales_match_reference():
    jcfg, cfg = _cfgs("llama4-scout-17b-16e")
    jp = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, want in flat_j:
        got = tp
        for key in path:
            got = got[key.key]
        assert tuple(got.shape) == want.shape and str(got.dtype).endswith(str(want.dtype))
        if want.std() > 0:  # same truncated-normal scale, another generator
            assert abs(got.float().std().item() / want.std() - 1) < 0.1


# ---------------------------------------------------------------------------
# The CUDA kernel's two paths: the rule that picks one from the call's
# shape, and the tensor-core path's decomposition emulated on the CPU.

from repro_torch.kernels.expert_mlp import ops as ffn_ops  # noqa: E402


@pytest.mark.parametrize("n,dtype,want", [
    (4, torch.bfloat16, ("stream", 96)),     # the streaming cloud tier
    (8, torch.bfloat16, ("stream", 96)),     # the serving decode
    (32, torch.bfloat16, ("stream", 96)),    # a prefill chunk
    (63, torch.bfloat16, ("stream", 86)),    # partials capped at 16 MB
    (64, torch.bfloat16, ("mma", 1)),        # one full row tile
    (65, torch.bfloat16, ("mma", 1)),
    (1024, torch.bfloat16, ("mma", 1)),      # the one-shot pipeline's batch
    (8, torch.float32, ("stream", 96)),      # f32: exact, on the CUDA cores
    (1024, torch.float32, ("stream", 5)),
])
def test_ffn_plan(n, dtype, want):
    """switch-base's d 768, f 3072; the rule reads the call's shape only,
    so the grouped and the resident wrapper take one path for one n."""
    assert ffn_ops.ffn_plan(n, 768, 3072, dtype) == want
    path, splits = want
    assert path == "mma" or splits * n * 768 <= ffn_ops.SCRATCH_FLOATS or splits == 1


def test_ffn_plan_widths():
    assert ffn_ops.ffn_plan(1024, 96, 200, torch.bfloat16) == ("mma", 1)
    assert ffn_ops.ffn_plan(1024, 96, 203, torch.bfloat16)[0] == "stream"  # f % 8


@pytest.mark.parametrize("n,dtype,want", [
    (8, torch.bfloat16, ("stream", 102)),  # partials capped at 16 MB
    (72, torch.bfloat16, ("mma", 1)),
    (72, torch.float32, ("stream", 11)),
])
def test_ffn_plan_at_llama4_scout_width(n, dtype, want):
    """d_model 5120, d_ff 8192: the rule has no width limit (the streaming
    kernel takes its output columns in passes past 1024)."""
    assert ffn_ops.ffn_plan(n, 5120, 8192, dtype) == want


def _mma_tiles(sizes, n, zero_group=-1, bm=64):
    """The tensor-core path's row tiles, as csrc/expert_mlp.cu::find_tile
    maps the grid's row-tile index: each group's run of rows (clipped to
    [0, n)) in tiles of ``bm`` from its first row, then the rows past the
    groups; (group, first row, rows, zero)."""
    tiles, start = [], 0
    for g, c in enumerate(sizes):
        ce = max(0, min(c, n - start))
        for t in range(-(-ce // bm)):
            tiles.append((g, start + t * bm, min(bm, ce - t * bm), g == zero_group))
        start += c
    total = max(0, min(start, n))
    for t in range(-(-(n - total) // bm)):
        tiles.append((None, total + t * bm, min(bm, n - total - t * bm), True))
    assert len(tiles) <= -(-n // bm) + len(sizes) + 1  # the launch's grid bound
    return tiles


def _two_gemms(xs, sizes, wi, wg, wo, act, bm=64):
    """The tensor-core path: per row tile, H = act(X Wi) [* X Wg] over all
    ``bm`` rows from the tile's first row (rows of the next group too,
    computed but never stored), then Y = H Wo, and only the tile's rows
    stored; zero tiles store zeros."""
    from repro_torch.models.layers import ACTIVATIONS

    a = ACTIVATIONS[act]
    n = xs.shape[0]
    y = torch.full_like(xs, float("nan"))
    for g, r0, rows, zero in _mma_tiles(sizes, n, bm=bm):
        if zero:
            y[r0:r0 + rows] = 0
            continue
        x = xs[r0:r0 + bm]
        h = a(x @ wi[g]) * (x @ wg[g]) if wg is not None else a(x @ wi[g])
        y[r0:r0 + rows] = (h @ wo[g])[:rows]
    return y


@pytest.mark.parametrize("name,sizes,bm", [
    ("switch-base", [0, 1, 63, 64, 65, 0, 2, 1], 64),   # around one row tile
    ("switch-base", [200, 0, 0, 0, 0, 0, 0, 0], 64),    # every row on one expert
    ("llama4-scout-17b-16e", [5, 0, 9, 3, 0, 0, 7, 1], 4),  # gated SiLU, short tiles
])
def test_two_gemm_decomposition_matches_reference(name, sizes, bm):
    jcfg, cfg = _cfgs(name)
    p, tp = _params(jcfg)
    n = sum(sizes) + 2  # two rows past sum(group_sizes): both come back 0
    xs = np.random.default_rng(3).standard_normal((n, cfg.d_model)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    want = jmoe._grouped_mlp(jnp.asarray(xs), jnp.asarray(gs), p["wi"], p.get("wg"),
                             p["wo"], jcfg.act)
    got = _two_gemms(torch.from_numpy(xs), sizes, tp["wi"], tp.get("wg"), tp["wo"], cfg.act,
                     bm=bm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy()[-2:], 0.0)
