"""The port's int8 byte streams against the reference, piece by piece, on
the CPU (plain versions of the kernels), numpy inputs made from a seed:

- ``kernels.quant`` against ``kernels/quant/ref.py`` and the reference's
  Pallas kernels in interpret mode: equal codes and scales (f32 and f16
  scales, f32 and bf16 inputs, all-zero rows, rows so small that the f16
  scale underflows to 0, round-half-to-even ties), and the column mode;
- the consumers' quantizers bit-equal to the reference's:
  ``quantize_kv_tokens``, ``quantize_boundary`` / ``dequantize_boundary``,
  ``quantize_slab`` and the int8 ``write_slabs``;
- the int8 KV pools: leaves, page bytes, the quantizing writers, and a tier
  re-split that moves the scales with their pages;
- quantized paged attention against ``paged_attention_ref(k_scale=,
  v_scale=)`` at C = 1 and 4, window None and 7 (rtol = atol = 2e-5, as the
  reference's own kernel test);
- the int8 resident expert FFN against ``expert_mlp_resident_quant_ref``
  (rtol 1e-5, atol 1e-4, as the reference's kernel test) and against
  ``moe_resident``'s int8 branch;
- the boundary payload meter against ``serving/common.py::payload_nbytes``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import compression as jcomp
from repro.core import expertpool as jep
from repro.core import moe as jmoe
from repro.kernels.expert_mlp.ref import expert_mlp_resident_quant_ref
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.kernels.quant import dequantize_rows as jdequantize_rows
from repro.kernels.quant import quantize_rows as jquantize_rows
from repro.kernels.quant.ref import dequantize_rows_ref, quantize_rows_ref
from repro.models import kvcache as jkv
from repro.serving.common import payload_nbytes as jpayload_nbytes
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import compression as tcomp
from repro_torch.core import expertpool as tep
from repro_torch.core import moe as tmoe
from repro_torch.kernels.expert_mlp import grouped_mlp_resident_quant
from repro_torch.kernels.paged_attention import paged_attention_quant
from repro_torch.kernels.quant import dequantize_rows, quantize_rows
from repro_torch.models import kvcache as tkv
from repro_torch.serving.common import payload_nbytes

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _np(a) -> np.ndarray:
    """A reference or port array as numpy, bf16 widened to f32."""
    if isinstance(a, torch.Tensor):
        a = a.float() if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _pair(x: np.ndarray, dtype: str):
    """The same values on both sides: (jax array, torch tensor) in ``dtype``."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(TORCH_DT[dtype])


def _rows(seed: int, n: int) -> np.ndarray:
    """Rows with the edge cases: all zeros, a row whose f16 scale underflows
    to 0, exact round-half ties (scale 1), a wide-range row, random rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((7, n)).astype(np.float32) * np.float32(3.0)
    x[0] = 0.0
    x[1] = 0.0
    x[1, :4] = [1e-7, -2e-7, 0.0, 5e-8]
    x[2] = 0.0
    x[2, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[3] *= np.float32(1e-4)
    x[4, 0] = 1e4
    return x


def _assert_equal(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))
    assert _np(got).dtype == _np(want).dtype


# -- kernels.quant ------------------------------------------------------------


def test_scale_types_and_floors_equal_reference():
    """The storage type and floor of each stream's scales."""
    for (tt, tf), (jt, jf) in (
        ((tkv.KV_SCALE_DTYPE, tkv.KV_SCALE_FLOOR), (jkv.KV_SCALE_DTYPE, jkv.KV_SCALE_FLOOR)),
        ((tep.SLAB_SCALE_DTYPE, tep.SLAB_SCALE_FLOOR), (jep.SLAB_SCALE_DTYPE, jep.SLAB_SCALE_FLOOR)),
        ((tcomp.BOUNDARY_SCALE_DTYPE, 1e-8), (jcomp.BOUNDARY_SCALE_DTYPE, 1e-8)),
    ):
        assert str(tt).removeprefix("torch.") == jnp.dtype(jt).name and tf == jf


@pytest.mark.parametrize("scale_dtype", ["float32", "float16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_equals_reference(dtype, scale_dtype):
    jx, tx = _pair(_rows(0, 48), dtype)
    jq, js = quantize_rows_ref(jx, scale_dtype=jnp.dtype(scale_dtype))
    tq, ts = quantize_rows(tx, scale_dtype=TORCH_DT[scale_dtype])
    _assert_equal(tq, jq)
    _assert_equal(ts, js)
    assert tuple(ts.shape) == (7, 1)
    if scale_dtype == "float16":  # the underflowed row: scale 0, codes +-127 / 0
        assert float(ts[1, 0]) == 0.0 and tq[1, :4].tolist() == [127, -127, 0, 127]
    assert not tq[0].any() and tq[2, :6].tolist() == [127, 0, 2, 2, 0, -2]
    for out in ("float32", "bfloat16"):
        _assert_equal(dequantize_rows(tq, ts, dtype=TORCH_DT[out]),
                      dequantize_rows_ref(jq, js, dtype=jnp.dtype(out)))


def test_quantize_rows_within_the_pallas_kernels_tolerance():
    """The reference's Pallas quantizer (interpret mode, f32 scales, leading
    axes flattened) within its own test's tolerance of the jnp oracle
    (``tests/test_quant.py::test_quant_ops_kernel_matches_ref``: XLA may fold
    its divide into a reciprocal, so scales within 3e-7 and codes within one
    step); its dequantizer on the same codes gives the port's values."""
    jx, tx = _pair(_rows(1, 40).reshape(7, 2, 20), "float32")
    jq, js = jquantize_rows(jx, interpret=True)
    tq, ts = quantize_rows(tx)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=3e-7)
    assert np.abs(_np(tq).astype(np.int32) - _np(jq).astype(np.int32)).max() <= 1
    _assert_equal(dequantize_rows(torch.tensor(_np(jq)), torch.tensor(_np(js)),
                                  dtype=torch.bfloat16),
                  jdequantize_rows(jq, js, interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_columns_equals_rows_of_the_transpose(dtype):
    """``axis=-2``: one scale per column, the codes of the transposed rows."""
    x = _rows(2, 30).reshape(7, 3, 10)
    _, tx = _pair(x, dtype)
    q, s = quantize_rows(tx, axis=-2)
    qt, st = quantize_rows(tx.transpose(-1, -2).contiguous())
    assert tuple(s.shape) == (7, 1, 10)
    assert torch.equal(q, qt.transpose(-1, -2)) and torch.equal(s, st.transpose(-1, -2))


def test_wrappers_reject_other_devices_and_axes():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        quantize_rows(x)
    with pytest.raises(ValueError, match="device"):
        dequantize_rows(torch.zeros(4, 8, dtype=torch.int8, device="meta"),
                        torch.zeros(4, 1, device="meta"))
    with pytest.raises(ValueError, match="axis"):
        quantize_rows(torch.zeros(4, 8), axis=0)


# -- the consumers' quantizers ------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_tokens_equals_reference(dtype):
    """One f16 scale per token over its KV * hd values."""
    x = _rows(3, 2 * 16).reshape(7, 1, 2, 16)
    jx, tx = _pair(x, dtype)
    jq, js = jkv.quantize_kv_tokens(jx)
    tq, ts = tkv.quantize_kv_tokens(tx)
    _assert_equal(tq, jq)
    _assert_equal(ts, js)
    assert tuple(ts.shape) == (7, 1) and ts.dtype == tkv.KV_SCALE_DTYPE
    pool = torch.tensor(np.asarray(jq))
    _assert_equal(tkv.dequantize_kv_pool(pool, ts, torch.float32),
                  jkv.dequantize_kv_pool(jq, js, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_boundary_equals_reference(dtype):
    jz, tz = _pair(_rows(4, 24).reshape(7, 1, 24), dtype)
    jq, js = jcomp.quantize_boundary(jz)
    tq, ts = tcomp.quantize_boundary(tz)
    _assert_equal(tq, jq)
    _assert_equal(ts, js)
    assert ts.dtype == tcomp.BOUNDARY_SCALE_DTYPE
    _assert_equal(tcomp.dequantize_boundary(tq, ts, TORCH_DT[dtype]),
                  jcomp.dequantize_boundary(jq, js, jnp.dtype(dtype)))
    assert payload_nbytes((tq, ts)) == jpayload_nbytes((jq, js)) == 7 * (24 + 2)
    assert payload_nbytes(tz) == jpayload_nbytes(jz)


def test_quantize_slab_equals_reference():
    """One f32 scale per output column; an all-zero column and an all-zero
    slab keep the 1e-8 floor and codes 0."""
    w = np.random.default_rng(5).standard_normal((3, 12, 20)).astype(np.float32)
    w[1] = 0.0
    w[0, :, 3] = 0.0
    jq, js = jep.quantize_slab(jnp.asarray(w))
    tq, ts = tep.quantize_slab(torch.from_numpy(w))
    _assert_equal(tq, jq)
    _assert_equal(ts, js)
    assert tuple(ts.shape) == (3, 20) and not tq[1].any() and float(ts[1, 0]) == np.float32(1e-8)


@pytest.mark.parametrize("name", ["switch-base", "llama4-scout-17b-16e"])
def test_write_slabs_quantized_equals_reference(name):
    jcfg = jsmoke(jget(name)).replace(num_layers=4, dtype="float32", param_dtype="float32")
    cfg = smoke_config(get_config(name)).replace(num_layers=4, dtype="float32",
                                                  param_dtype="float32")
    R, E = cfg.block_repeat, cfg.moe.num_experts
    rng = np.random.default_rng(6)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    full = {"wi": rng.standard_normal((R, E, d, f)), "wo": rng.standard_normal((R, E, f, d))}
    if cfg.ffn_gated:
        full["wg"] = rng.standard_normal((R, E, d, f))
    full = {k: v.astype(np.float32) for k, v in full.items()}
    asg = [(3, 0, 5), (0, R - 1, 2), (6, 1, 0), (1, 0, E - 1)]
    want = jep.write_slabs(jep.init_slab_store(jcfg, 7, quantized=True),
                           {k: jnp.asarray(v) for k, v in full.items()}, asg)
    got = tep.write_slabs(tep.init_slab_store(cfg, 7, quantized=True, device="cpu"),
                          {k: torch.from_numpy(v) for k, v in full.items()}, asg)
    assert set(got) == set(want)
    for k in want:
        _assert_equal(got[k], want[k])


# -- int8 KV pools --------------------------------------------------------------


def _kv_cfgs(name="tinyllama-1.1b"):
    return jsmoke(jget(name)).replace(num_layers=4), smoke_config(get_config(name)).replace(
        num_layers=4)


def test_quantized_pools_and_page_bytes_equal_reference():
    jcfg, cfg = _kv_cfgs()
    for quantized in (False, True):
        jb = jkv.init_paged_blocks(jcfg, 2, 8, 4, jnp.dtype(jcfg.dtype), quantized=quantized)
        tb = tkv.init_paged_blocks(cfg, 2, 8, 4, cfg.torch_dtype, "cpu", quantized=quantized)
        assert set(tb) == set(jb)
        for pos in jb:
            assert set(tb[pos]) == set(jb[pos])
            for k, leaf in jb[pos].items():
                assert tuple(tb[pos][k].shape) == leaf.shape
                assert str(tb[pos][k].dtype).removeprefix("torch.") == str(leaf.dtype)
        assert tkv.paged_block_bytes(tb) == jkv.paged_block_bytes(jb)
    assert tkv.dense_page_bytes(cfg, 2, 4) / tkv.paged_block_bytes(tb) >= 1.9


def _write_case(seed):
    """Pools, a page table with garbage-routed entries, and k/v to write."""
    rng = np.random.default_rng(seed)
    P, ps, KV, hd, B, pps = 6, 4, 2, 8, 3, 3
    table = np.asarray([[0, 4, P], [2, P, P], [5, 1, 3]], np.int32)
    pools = {n: rng.integers(-127, 128, (P + 1, ps, KV, hd)).astype(np.int8) for n in "kv"}
    scales = {n: rng.random((P + 1, ps)).astype(np.float16) for n in "kv"}
    return rng, table, pools, scales, (P, ps, KV, hd, B, pps)


def test_quantizing_writers_equal_reference():
    rng, table, pools, scales, (P, ps, KV, hd, B, pps) = _write_case(7)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    # one decode token per slot at ring position ``lengths``
    k, v = (rng.standard_normal((B, 1, KV, hd)).astype(np.float32) for _ in range(2))
    lengths = np.asarray([5, 2, 11], np.int32)
    want = jkv.paged_ring_write_quant(
        *(jnp.asarray(a) for a in (pools["k"], pools["v"], scales["k"], scales["v"], k, v,
                                   table, lengths)), ps)
    got = tkv.paged_ring_write_quant(
        *(t(a) for a in (pools["k"], pools["v"], scales["k"], scales["v"], k, v, table,
                         lengths)), ps)
    for g, w in zip(got, want):
        _assert_equal(g, w)
    # a chunk of C tokens with padding rows routed to the garbage page
    C = 5
    k, v = (rng.standard_normal((B, C, KV, hd)).astype(np.float32) for _ in range(2))
    start = np.asarray([0, 1, 6], np.int32)
    positions = start[:, None] + np.arange(C, dtype=np.int32)[None]
    valid = np.arange(C)[None] < np.asarray([5, 3, 4])[:, None]
    want = jkv.paged_write_tokens_quant(
        *(jnp.asarray(a) for a in (pools["k"], pools["v"], scales["k"], scales["v"], k, v,
                                   table, positions, valid)), ps)
    got = tkv.paged_write_tokens_quant(
        *(t(a) for a in (pools["k"], pools["v"], scales["k"], scales["v"], k, v, table,
                         positions, valid)), ps)
    for g, w in zip(got, want):  # the garbage page takes one of several writes
        _assert_equal(g[:P], w[:P])


@pytest.mark.parametrize("old,new", [(1, 3), (3, 0)])
def test_resplit_moves_scales_with_their_pages(old, new):
    """A re-split carries the int8 codes and the f16 scales of the moved
    blocks to the destination pool's rows, as the reference does."""
    jcfg, cfg = _kv_cfgs()
    R, P, ps = cfg.block_repeat, 5, 4

    def blocks(n, seed):
        r = np.random.default_rng(seed)
        out = {}
        for pos, entry in jkv.init_paged_blocks(jcfg, n, P, ps, jnp.float32,
                                                quantized=True).items():
            out[pos] = {k: (r.integers(-127, 128, leaf.shape).astype(np.int8)
                            if leaf.dtype == jnp.int8 else r.random(leaf.shape).astype(np.float16))
                        for k, leaf in entry.items()}
        return out

    end, cloud = blocks(old, 1), blocks(R - old, 2)
    e_tab = np.asarray([[0, 3, -1], [1, -1, -1]])
    c_tab = np.asarray([[4, 0, -1], [2, -1, -1]])
    e2c = jkv.page_perm(e_tab, c_tab, P, P)
    c2e = jkv.page_perm(c_tab, e_tab, P, P)
    jtree = lambda b: {p: {k: jnp.asarray(v) for k, v in e.items()} for p, e in b.items()}  # noqa: E731
    ttree = lambda b: {p: {k: torch.from_numpy(v) for k, v in e.items()} for p, e in b.items()}  # noqa: E731
    want = jkv.resplit_paged_blocks(jtree(end), jtree(cloud), old, new, e2c, c2e)
    got = tkv.resplit_paged_blocks(ttree(end), ttree(cloud), old, new, e2c, c2e)
    for w_tier, g_tier in zip(want, got):
        for pos in w_tier:
            assert set(g_tier[pos]) == {"k", "v", "k_scale", "v_scale"}
            for k in w_tier[pos]:
                _assert_equal(g_tier[pos][k], w_tier[pos][k])


# -- quantized paged attention --------------------------------------------------


def _quant_pool_case(lengths, seed=0, num_pages=24, ps=4, pps=4, KV=2, hd=32):
    """The reference test's case: pages mapped for every slot's tokens, the
    pools quantized by ``quantize_kv_tokens`` from standard normal draws."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    pool = jkv.PagePool(num_pages, ps, pps, n_slots=B)
    for b, ln in enumerate(lengths):
        pool.reserve(b, jkv.pages_needed(int(ln) + 1, ps, pps))
        pool.map_range(b, 0, int(ln) + 1)
    table = np.array(pool.device_rows(range(B)))
    k = rng.standard_normal((num_pages + 1, ps, KV, hd)).astype(np.float32)
    v = rng.standard_normal((num_pages + 1, ps, KV, hd)).astype(np.float32)
    kq, ks = jkv.quantize_kv_tokens(jnp.asarray(k))
    vq, vs = jkv.quantize_kv_tokens(jnp.asarray(v))
    return [np.array(a) for a in (kq, vq, ks, vs)], table


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("C", [1, 4])
def test_paged_attention_quant_plain_equals_reference(C, window):
    start = np.asarray([0, 2, 6, 12])
    n_valid = np.asarray([1, 4, 4, 2]) if C > 1 else np.ones(4, np.int64)
    if C == 1:
        start = np.asarray([1, 5, 9, 15])
    last = start + n_valid - 1
    (kq, vq, ks, vs), table = _quant_pool_case(last, seed=C)
    q = np.random.default_rng(10 + C).standard_normal((4, C, 4, 32)).astype(np.float32)
    positions = (start[:, None] + np.arange(C)[None]).astype(np.int32)
    ln = last.astype(np.int32)
    want = paged_attention_ref(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
                               jnp.asarray(table), jnp.asarray(positions), jnp.asarray(ln),
                               window=window, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    t = torch.from_numpy
    before = paged_attention_quant.launches
    got = paged_attention_quant(t(q), t(kq), t(vq), t(ks), t(vs), t(table), t(positions),
                                t(ln), window=window)
    assert paged_attention_quant.launches == before  # the plain version: no launch
    rows = np.arange(C)[None, :] < n_valid[:, None]
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], rtol=2e-5, atol=2e-5)


# -- the int8 resident expert FFN -------------------------------------------------


def _quant_store(rng, N, d, f, gated):
    mats = {"wi": (d, f), "wo": (f, d)}
    if gated:
        mats["wg"] = (d, f)
    store = {}
    for k, shape in mats.items():
        q, s = jep.quantize_slab(jnp.asarray(rng.standard_normal((N, *shape)), jnp.float32))
        store[k], store[f"{k}_scale"] = np.array(q), np.array(s)
    return store


@pytest.mark.parametrize("gated", [False, True])
def test_resident_quant_plain_equals_reference(gated):
    """Slots of C rows each through ``expert_mlp_resident_quant_ref``."""
    rng = np.random.default_rng(5)
    N, S, C, d, f = 6, 3, 8, 32, 64
    store = _quant_store(rng, N, d, f, gated)
    x = rng.standard_normal((S, C, d)).astype(np.float32)
    ids = np.asarray([0, 3, 5], np.int32)
    act = "silu" if gated else "gelu"
    j = {k: jnp.asarray(v) for k, v in store.items()}
    want = expert_mlp_resident_quant_ref(
        jnp.asarray(x), j["wi"], j.get("wg"), j["wo"], j["wi_scale"], j.get("wg_scale"),
        j["wo_scale"], jnp.asarray(ids), act=act)
    t = {k: torch.from_numpy(v) for k, v in store.items()}
    got = grouped_mlp_resident_quant(
        torch.from_numpy(x.reshape(S * C, d)), torch.full((S,), C, dtype=torch.int32),
        t["wi"], t.get("wg"), t["wo"], torch.from_numpy(ids), act,
        wi_scale=t["wi_scale"], wg_scale=t.get("wg_scale"), wo_scale=t["wo_scale"])
    np.testing.assert_allclose(got.numpy().reshape(S, C, d), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["switch-base", "llama4-scout-17b-16e"])
def test_moe_resident_int8_store_equals_reference(name):
    """``moe_resident`` over an int8 slab store written from the same f32
    experts: a resident subset with non-resident experts routed away."""
    jcfg = jsmoke(jget(name)).replace(dtype="float32", param_dtype="float32")
    cfg = smoke_config(get_config(name)).replace(dtype="float32", param_dtype="float32")
    E = cfg.moe.num_experts
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    full = {k: v[None] for k, v in jp.items() if k in ("wi", "wg", "wo")}  # one block
    resident = [1, 2, 5, E - 1]
    asg = [(slab, 0, e) for slab, e in enumerate(resident)]
    jstore = jep.write_slabs(jep.init_slab_store(jcfg, 6, quantized=True), full, asg)
    S = len(resident)
    ids = np.asarray(list(range(S)) + [6], np.int32)
    slot = np.full((E,), S, np.int32)
    slot[resident] = np.arange(S)
    x = np.random.default_rng(4).standard_normal((10, cfg.d_model)).astype(np.float32)
    jres = {"store": jstore, "ids": jnp.asarray(ids), "slot": jnp.asarray(slot)}
    want, _ = jmoe.moe_resident({**{k: v for k, v in jp.items() if k not in full},
                                 "resident": jres}, jnp.asarray(x), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tstore = tep.write_slabs(tep.init_slab_store(cfg, 6, quantized=True, device="cpu"),
                             {k: v[None] for k, v in tp.items() if k in full}, asg)
    tres = {"store": tstore, "ids": torch.from_numpy(ids), "slot": torch.from_numpy(slot)}
    got, _ = tmoe.moe_resident({**{k: v for k, v in tp.items() if k not in full},
                                "resident": tres}, torch.from_numpy(x), cfg)
    # f32 products summed in other orders (outputs up to ~40): the
    # tolerance of the reference's int8 resident kernel test
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
