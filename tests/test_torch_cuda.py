"""The port's kernels on the card: each against its plain version, the
wrappers' input checks, and the serving engine, the one-shot end-cloud
pipeline and the streaming end-cloud engine (with and without its int8
streams, with speculative decode and with a preemption) and a two-lane
fleet driven by ``loadgen.drive`` on the card against the same on the
CPU.  Marked ``cuda``; skipped where no CUDA device is visible.  Run on a
machine with the card (``--noconftest``: the suite's conftest imports
JAX, which the port does not need):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import CompressionConfig, get_config, smoke_config
from repro_torch.core.expertpool import quantize_slab
from repro_torch.core.gating import init_group_gate
from repro_torch.core.hardware import PROFILES
from repro_torch.kernels.expert_mlp import (
    grouped_mlp,
    grouped_mlp_plain,
    grouped_mlp_resident,
    grouped_mlp_resident_plain,
    grouped_mlp_resident_quant,
    grouped_mlp_resident_quant_plain,
)
from repro_torch.kernels.flash_attention import flash_attention_fwd, flash_attention_plain
from repro_torch.kernels.group_gate import group_gate, group_gate_plain
from repro_torch.kernels.group_gate import ops as group_gate_ops
from repro_torch.core import compression as comp
from repro_torch.kernels.lowrank import (
    lowrank_decode,
    lowrank_decode_quant,
    lowrank_decode_quant_plain,
    lowrank_encode,
    lowrank_encode_quant,
    lowrank_project_plain,
    lowrank_roundtrip,
    lowrank_roundtrip_loss,
    lowrank_roundtrip_loss_plain,
    lowrank_roundtrip_plain,
)
from repro_torch.kernels.lowrank import ops as lowrank_ops
from repro_torch.kernels.paged_attention import (
    paged_attention,
    paged_attention_plain,
    paged_attention_quant,
)
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.quant import (
    cols_plan,
    dequantize_rows,
    dequantize_rows_plain,
    paged_write_quant,
    quantize_rows,
    quantize_rows_plain,
)
from repro_torch.models import kvcache
from repro_torch.models.kvcache import paged_write_quant_plain, quantize_kv_tokens
from repro_torch.models.model import Model, to_device
from repro_torch.serving import EndCloudPipeline, EndCloudServingEngine, Request, ServingEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only on the card)")
    return torch.Generator(device="cuda").manual_seed(0)


def _attention_case(gen, dtype, C=3, B=3, H=4, KV=2, hd=32, ps=4, pps=4):
    P = B * pps
    table = torch.arange(P, dtype=torch.int32, device="cuda").view(B, pps)
    table[0, 2:] = P  # slot 0: two mapped pages, the rest garbage
    lengths = torch.tensor([5, 14, 23], dtype=torch.int32, device="cuda")  # slot 2 wraps
    q_pos = (lengths[:, None] - C + 1 + torch.arange(C, device="cuda")[None]).int()
    q = torch.randn(B, C, H, hd, generator=gen, device="cuda").to(dtype)
    pk = torch.randn(P + 1, ps, KV, hd, generator=gen, device="cuda").to(dtype)
    pv = torch.randn(P + 1, ps, KV, hd, generator=gen, device="cuda").to(dtype)
    return q, pk, pv, table, q_pos, lengths


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_attention_kernel(gen, dtype, tol, window):
    args = _attention_case(gen, dtype)
    before = paged_attention.launches
    got = paged_attention(*args, window=window)
    want = paged_attention_plain(*args, window=window)
    assert paged_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    q, pk, pv, table, q_pos, lengths = args
    dead = paged_attention(q, pk, pv, torch.full_like(table, pk.shape[0] - 1), q_pos, lengths)
    assert bool((dead == 0).all())


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.float16])
def test_quantize_rows_kernel(gen, axis, dtype, scale_dtype):
    """Codes and scales bit-equal to the plain version's (an all-zero line,
    a line whose f16 scale underflows to 0, ragged widths); the dequantizer
    bit-equal too."""
    x = (torch.randn(3, 37, 45, generator=gen, device="cuda") * 3).to(dtype)
    line = (slice(None), 0) if axis == -1 else (slice(None), slice(None), 0)
    x[0][line[1:]] = 0
    x[1][line[1:]] = (x[1][line[1:]].float() * 1e-7).to(dtype)
    before = quantize_rows.launches
    q, s = quantize_rows(x, scale_dtype=scale_dtype, axis=axis)
    assert quantize_rows.launches == before + 1
    rq, rs = quantize_rows_plain(x, scale_dtype=scale_dtype, axis=axis)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    if scale_dtype == torch.float16:
        assert float(s[1][line[1:]].float().max()) == 0.0
    if axis == -1:
        for out in (torch.float32, torch.bfloat16):
            assert torch.equal(dequantize_rows(q, s, dtype=out),
                               dequantize_rows_plain(q, s, dtype=out))
    with pytest.raises(ValueError, match="contiguous"):
        quantize_rows(x.transpose(0, 1), scale_dtype=scale_dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_attention_quant_kernel(gen, dtype, tol, window):
    q, pk, pv, table, q_pos, lengths = _attention_case(gen, dtype)
    kq, ks = quantize_kv_tokens(pk)
    vq, vs = quantize_kv_tokens(pv)
    args = (q, kq, vq, ks, vs, table, q_pos, lengths)
    before = paged_attention_quant.launches, paged_attention.launches
    got = paged_attention_quant(*args, window=window)
    assert (paged_attention_quant.launches, paged_attention.launches) == (
        before[0] + 1, before[1])
    want = paged_attention_plain(q, kq, vq, table, q_pos, lengths, window=window,
                                 k_scale=ks, v_scale=vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    dead = paged_attention_quant(q, kq, vq, ks, vs, torch.full_like(table, kq.shape[0] - 1),
                                 q_pos, lengths)
    assert bool((dead == 0).all())
    with pytest.raises(ValueError, match="dtypes"):
        paged_attention_quant(q, pk, pv, ks, vs, table, q_pos, lengths)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_grouped_mlp_resident_quant_kernel(gen, gated, dtype, tol):
    """An int8 store with f32 column scales: within the tolerance of the
    plain version, garbage-slot rows exactly 0."""
    N, d, f = 6, 96, 200
    store = {}
    for k, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d))):
        w = torch.randn(N + 1, *shape, generator=gen, device="cuda") / shape[0] ** 0.5
        w[N] = 0  # the garbage slab
        store[k], store[f"{k}_scale"] = quantize_slab(w)
    wg = store["wg"] if gated else None
    scales = dict(wi_scale=store["wi_scale"], wo_scale=store["wo_scale"],
                  wg_scale=store["wg_scale"] if gated else None)
    ids = torch.tensor([4, 1, 2, N], dtype=torch.int32, device="cuda")
    sizes = torch.tensor([3, 0, 9, 2], dtype=torch.int32, device="cuda")
    xs = torch.randn(int(sizes.sum()), d, generator=gen, device="cuda").to(dtype)
    act = "silu" if gated else "gelu"
    before = grouped_mlp_resident_quant.launches
    got = grouped_mlp_resident_quant(xs, sizes, store["wi"], wg, store["wo"], ids, act, **scales)
    assert grouped_mlp_resident_quant.launches == before + 1
    want = grouped_mlp_resident_quant_plain(xs, sizes, store["wi"], wg, store["wo"], ids, act,
                                            **scales)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * scale)
    assert bool((got[-2:] == 0).all())
    with pytest.raises(ValueError, match="int8"):
        grouped_mlp_resident_quant(xs, sizes, store["wi"].float(), wg, store["wo"], ids, act,
                                   **scales)


@pytest.mark.parametrize("mask", [None, [1, 0, 0, 0, 1, 1, 0, 1]])
@pytest.mark.parametrize("T", [5, 40])
def test_group_gate_kernel(gen, mask, T):
    K, d, Mk = 4, 96, 2
    w_local = torch.randn(K, d, Mk, generator=gen, device="cuda")
    b_local = torch.randn(K, Mk, generator=gen, device="cuda")
    w_global = torch.randn(d, K, generator=gen, device="cuda")
    b_global = torch.randn(K, generator=gen, device="cuda")
    x = torch.randn(T, d, generator=gen, device="cuda").bfloat16()
    m = None if mask is None else torch.tensor(mask, dtype=torch.bool, device="cuda")
    got = group_gate(x, w_local, b_local, w_global, b_global, m)
    want = group_gate_plain(x, w_local, b_local, w_global, b_global, m)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="one \\[E\\]"):
        group_gate(x, w_local, b_local, w_global, b_global,
                   torch.ones(T, K * Mk, dtype=torch.bool, device="cuda"))


@pytest.mark.parametrize("mask", ["none", "partial", "dead group"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [4, 8, 256, 1024])
@pytest.mark.parametrize("model", ["switch-base", "llama4-scout-17b-16e",
                                   "qwen3-moe-235b-a22b"])
def test_group_gate_kernel_path_shapes(gen, model, T, dtype, mask):
    """The path's widths (switch-base d 768, 8 experts in 4 groups;
    llama4-scout d 5120, 16 in 4; qwen3-moe d 4096, 128 in 16, the wide
    form) and row counts: within 1e-4 of the plain
    version (f32 probabilities, the logits summed in another order), the
    same bits from a second launch, one launch counted a call."""
    moe = get_config(model).moe
    d, E, Mk = get_config(model).d_model, moe.num_experts, moe.experts_per_group
    p = init_group_gate(gen, d, moe)
    p["b_local"].normal_(generator=gen)
    p["b_global"].normal_(generator=gen)
    e = torch.arange(E, device="cuda")
    m = {"none": None, "partial": e % 3 != 1,
         "dead group": (e // Mk != 1) & (e % Mk != 0)}[mask]
    x = torch.randn(T, d, generator=gen, device="cuda").to(dtype)
    args = (x, p["w_local"], p["b_local"], p["w_global"], p["b_global"], m)
    before = group_gate.launches
    got = group_gate(*args)
    assert group_gate.launches == before + 1
    want = group_gate_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
    again = group_gate(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    if mask == "dead group":
        assert bool((got[1][:, 1] == 0).all()) and bool((got[0][:, Mk:2 * Mk] == 0).all())


@pytest.mark.parametrize("K,Mk,d,aligned", [
    (2, 4, 96, True), (8, 2, 160, True), (1, 3, 2100, True),  # the generic form
    (4, 2, 96, False),  # switch-base's (K, Mk) off 16-byte alignment: generic too
    (4, 4, 2100, True),  # llama4-scout's form with a deep loop over d
    (16, 8, 4096, True), (4, 8, 100, True), (32, 8, 96, True),  # the wide form
    (2, 32, 333, False), (16, 1, 64, True),
])
@pytest.mark.parametrize("masked", [False, True])
def test_group_gate_kernel_forms(gen, K, Mk, d, aligned, masked):
    """Every kernel form and loop depth (``launch_plan``) against the plain
    version at 6 and 300 tokens, the same bits from a second launch."""
    lead = 0 if aligned else 1  # a one-float leading slice breaks 16-byte alignment
    w_local = torch.randn(K * d * Mk + lead, generator=gen, device="cuda")[lead:].view(K, d, Mk)
    w_global = torch.randn(d, K, generator=gen, device="cuda")
    b_local = torch.randn(K, Mk, generator=gen, device="cuda")
    b_global = torch.randn(K, generator=gen, device="cuda")
    form = group_gate_ops.launch_plan(8, d, K, Mk, (w_local.data_ptr(), w_global.data_ptr()))[0]
    if K * Mk > 16 or K > 8:
        assert form == 3
    else:
        assert (form == 0) == ((K, Mk) not in ((4, 2), (4, 4)) or not aligned)
    m = (torch.arange(K * Mk, device="cuda") % 3 != 1) if masked else None
    for T in (6, 300):
        x = torch.randn(T, d, generator=gen, device="cuda").bfloat16()
        args = (x, w_local, b_local, w_global, b_global, m)
        got = group_gate(*args)
        want = group_gate_plain(*args)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
        again = group_gate(*args)
        assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_group_gate_kernel_raises(gen):
    K, d, Mk, T = 4, 64, 2, 8
    w_local = torch.randn(K, d, Mk, generator=gen, device="cuda")
    b_local = torch.randn(K, Mk, generator=gen, device="cuda")
    w_global = torch.randn(d, K, generator=gen, device="cuda")
    b_global = torch.randn(K, generator=gen, device="cuda")
    x = torch.randn(T, d, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        group_gate(torch.randn(d, T, generator=gen, device="cuda").T, w_local, b_local,
                   w_global, b_global)
    with pytest.raises(ValueError, match="contiguous"):
        group_gate(x, w_local.transpose(1, 2).contiguous().transpose(1, 2), b_local,
                   w_global, b_global)
    with pytest.raises(ValueError, match="dtype"):
        group_gate(x.half(), w_local, b_local, w_global, b_global)
    with pytest.raises(ValueError, match="float32"):
        group_gate(x, w_local.bfloat16(), b_local, w_global, b_global)
    with pytest.raises(ValueError, match="one \\[E\\]"):
        group_gate(x, w_local, b_local, w_global, b_global,
                   torch.ones(T, K * Mk, dtype=torch.bool, device="cuda"))
    with pytest.raises(ValueError, match="bool"):
        group_gate(x, w_local, b_local, w_global, b_global,
                   torch.ones(K * Mk, dtype=torch.uint8, device="cuda"))
    # past 16 experts the wide form takes powers of two only (3 groups of 8)
    wide = torch.randn(3, d, 8, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="E <= 256"):
        group_gate(x, wide, torch.zeros(3, 8, device="cuda"), w_global[:, :3].contiguous(),
                   b_global[:3])


def _kv_write_case(gen, kind, dtype, KV, hd, P=40, ps=16, pps=4, R=3):
    """Block-stacked int8 leaves of random codes and f16 scales and the
    arguments of one layer write: a ring write of 3 slots (one past a ring
    wrap, one whose table is partly garbage) or a chunk of C = 16 rows with
    padding; an all-zero token and one whose f16 scale underflows."""
    leaves = torch.randint(-127, 128, (2, R, P + 1, ps, KV, hd), generator=gen,
                           device="cuda", dtype=torch.int8)
    scales = torch.rand(2, R, P + 1, ps, generator=gen, device="cuda").half()
    table = torch.tensor([[3, 0, 7, 5], [9, 2, P, P], [1, 4, 6, 8]], dtype=torch.int32,
                         device="cuda")
    B = table.shape[0]
    if kind == "ring":
        C, valid = 1, None
        positions = torch.tensor([100, 20, 61], dtype=torch.int32, device="cuda")
    else:
        C = 16
        start = torch.tensor([0, 16, 48], dtype=torch.int32, device="cuda")
        positions = (start[:, None] + torch.arange(C, device="cuda")[None]).int()
        valid = (torch.arange(C, device="cuda")[None]
                 < torch.tensor([16, 9, 5], device="cuda")[:, None])
    k, v = (torch.randn(B, C, KV, hd, generator=gen, device="cuda").to(dtype) * 3
            for _ in range(2))
    k[1, 0] = 0
    v[2, 0] *= 1e-7
    args = (table, positions, ps) + (() if valid is None else (valid,))
    return leaves, scales, k, v, args


# (2, 128): qwen2-vl; (8, 120): h2o-danube-3-4b, a line of KV * hd = 960
@pytest.mark.parametrize("KV,hd", [(12, 64), (8, 128), (2, 16), (2, 128), (8, 120)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["ring", "chunk"])
def test_paged_write_quant_kernel(gen, kind, dtype, KV, hd):
    """One launch a layer write into views of block-stacked leaves: codes
    and scales bit-equal to the plain writers' (on the card and on the CPU)
    outside the written block's garbage row, also from a second launch; the
    kvcache writers take the same single launch."""
    leaves, scales, k, v, args = _kv_write_case(gen, kind, dtype, KV, hd)
    P = leaves.shape[2] - 1

    def run(write, device="cuda"):
        lc, sc = leaves.clone().to(device), scales.clone().to(device)
        a = [t.to(device) if isinstance(t, torch.Tensor) else t for t in args]
        write(lc[0, 1], lc[1, 1], sc[0, 1], sc[1, 1], k.to(device), v.to(device), *a)
        lc[:, 1, P], sc[:, 1, P] = 0, 0  # the garbage row takes one of several writes
        return lc.cpu(), sc.cpu()

    before = paged_write_quant.launches
    got = run(paged_write_quant)
    assert paged_write_quant.launches == before + 1
    for want in (run(paged_write_quant_plain), run(paged_write_quant_plain, "cpu"),
                 run(paged_write_quant)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if kind == "ring":
        writer = kvcache.paged_ring_write_quant
    else:  # valid before page_size, as the reference orders them
        def writer(*a):
            return kvcache.paged_write_tokens_quant(*a[:-2], a[-1], a[-2])
    before = paged_write_quant.launches, quantize_rows.launches
    via = run(writer)
    assert (paged_write_quant.launches, quantize_rows.launches) == (before[0] + 1, before[1])
    assert torch.equal(via[0], got[0]) and torch.equal(via[1], got[1])


def test_paged_write_quant_raises(gen):
    leaves, scales, k, v, (table, positions, ps, valid) = _kv_write_case(
        gen, "chunk", torch.bfloat16, 12, 64)
    pools = (leaves[0, 1], leaves[1, 1], scales[0, 1], scales[1, 1])
    wide = torch.zeros(*leaves.shape[2:-1], 128, dtype=torch.int8, device="cuda")[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        paged_write_quant(wide, *pools[1:], k, v, table, positions, ps, valid)
    with pytest.raises(ValueError, match="contiguous"):
        paged_write_quant(*pools, k.transpose(0, 1).contiguous().transpose(0, 1), v, table,
                          positions, ps, valid)
    for bad in (dict(positions=positions.long()), dict(table=table.long()),
                dict(valid=valid.int()), dict(k=k.half(), v=v.half()),
                dict(pool_ks=pools[2].float())):
        kw = dict(pool_k=pools[0], pool_v=pools[1], pool_ks=pools[2], pool_vs=pools[3], k=k,
                  v=v, table=table, positions=positions, page_size=ps, valid=valid)
        kw.update(bad)
        with pytest.raises(ValueError, match="dtypes"):
            paged_write_quant(**kw)
    with pytest.raises(ValueError, match="shapes"):
        paged_write_quant(*pools, k, v, table, positions[:, :8].contiguous(), ps, valid)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_grouped_mlp_kernel(gen, gated, dtype, tol):
    E, d, f = 4, 96, 200  # f not a multiple of the 64-column hidden tile
    sizes = torch.tensor([3, 0, 9, 1], dtype=torch.int32, device="cuda")
    xs = torch.randn(int(sizes.sum()) + 2, d, generator=gen, device="cuda").to(dtype)
    wi = (torch.randn(E, d, f, generator=gen, device="cuda") / d ** 0.5).to(dtype)
    wg = (torch.randn(E, d, f, generator=gen, device="cuda") / d ** 0.5).to(dtype) if gated else None
    wo = (torch.randn(E, f, d, generator=gen, device="cuda") / f ** 0.5).to(dtype)
    act = "silu" if gated else "gelu"
    got = grouped_mlp(xs, sizes, wi, wg, wo, act)
    want = grouped_mlp_plain(xs, sizes, wi, wg, wo, act)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * scale)
    assert bool((got[-2:] == 0).all())
    with pytest.raises(ValueError, match="dtype"):
        grouped_mlp(xs, sizes, wi.float() if dtype == torch.bfloat16 else wi.bfloat16(),
                    wg, wo, act)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_mlp(xs.t().contiguous().t(), sizes, wi, wg, wo, act)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype,store_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.float32, 3e-2),
    (torch.bfloat16, torch.bfloat16, 3e-2),
])
def test_grouped_mlp_resident_kernel(gen, gated, dtype, store_dtype, tol):
    """Permuted slab ids, an empty slot, rows on the garbage slot (exact 0),
    and the same bits as ``grouped_mlp`` over the gathered slabs (a row's
    arithmetic does not depend on the slab it is read through)."""
    N, d, f = 6, 96, 200
    store = {k: (torch.randn(N + 1, *shape, generator=gen, device="cuda") / shape[0] ** 0.5)
             .to(store_dtype) for k, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    for w in store.values():
        w[N] = 0  # the garbage slab
    wg = store["wg"] if gated else None
    ids = torch.tensor([4, 1, 2, N], dtype=torch.int32, device="cuda")  # slot 3 = garbage
    sizes = torch.tensor([3, 0, 9, 2], dtype=torch.int32, device="cuda")
    xs = torch.randn(int(sizes.sum()), d, generator=gen, device="cuda").to(dtype)
    act = "silu" if gated else "gelu"
    before = grouped_mlp_resident.launches
    got = grouped_mlp_resident(xs, sizes, store["wi"], wg, store["wo"], ids, act)
    assert grouped_mlp_resident.launches == before + 1
    want = grouped_mlp_resident_plain(xs, sizes, store["wi"], wg, store["wo"], ids, act)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * scale)
    assert bool((got[-2:] == 0).all())
    idx = ids.long()
    dense = grouped_mlp(xs, sizes, store["wi"][idx].to(dtype),
                        None if wg is None else wg[idx].to(dtype), store["wo"][idx].to(dtype), act)
    assert torch.equal(got[:-2], dense[:-2])
    with pytest.raises(ValueError, match="int32"):
        grouped_mlp_resident(xs, sizes, store["wi"], wg, store["wo"], ids.long(), act)
    with pytest.raises(ValueError, match="dtype"):  # a store narrower than the rows
        grouped_mlp_resident(xs.float(), sizes, store["wi"].bfloat16(), None,
                             store["wo"].bfloat16(), ids, act)


def _split_case(gen, shape, C, kind):
    """The streaming engine's 4-slot group (12 heads of 64, 16-token pages,
    a 32-page ring) or a GQA case (8 query heads on 2 kv heads of 32, an
    8-page ring); mapped pages permuted, the rest of each table garbage,
    the C rows ending at each slot's anchor."""
    B, H, KV, hd, pps, lengths = (
        (4, 12, 12, 64, 32, [37, 118, 199, 231]) if shape == "stream"
        else (3, 8, 2, 32, 8, [5, 60, 127]))
    ps, P = 16, B * pps
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(C)).view(B, pps)
    table = torch.full((B, pps), P, dtype=torch.int32)
    for b, ln in enumerate(lengths):
        mapped = min(pps, ln // ps + 1)
        table[b, :mapped] = perm[b, :mapped].int()
    ln = torch.tensor(lengths, dtype=torch.int32)
    q_pos = (ln[:, None] - (C - 1) + torch.arange(C, dtype=torch.int32)[None]).clamp_min(0)
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    q = torch.randn(B, C, H, hd, generator=gen, device="cuda").to(dt)
    pk = torch.randn(P + 1, ps, KV, hd, generator=gen, device="cuda").to(dt)
    pv = torch.randn(P + 1, ps, KV, hd, generator=gen, device="cuda").to(dt)
    scales = (None, None)
    if kind == "int8":
        (pk, ks), (pv, vs) = quantize_kv_tokens(pk), quantize_kv_tokens(pv)
        scales = (ks, vs)
    return q, pk, pv, scales, table.cuda(), q_pos.int().cuda(), ln.cuda()


@pytest.mark.parametrize("shape", ["stream", "gqa"])
@pytest.mark.parametrize("C", [1, 16, 32])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2), ("int8", 2e-2)])
def test_paged_attention_split_counts(gen, shape, C, window, kind, tol):
    """Every split count from 1 to the table's length, on the CUDA-core
    body (f32 and int8 pools, bf16 below 16 rows) and the tensor-core body
    (bf16 pools, C*G >= 16): within the plain version's tolerance, and a
    second launch gives the same bits."""
    q, pk, pv, (ks, vs), table, q_pos, lengths = _split_case(gen, shape, C, kind)
    want = paged_attention_plain(q, pk, pv, table, q_pos, lengths, window=window,
                                 k_scale=ks, v_scale=vs)
    for S in range(1, table.shape[1] + 1):
        got = pa_ops._launch(q, pk, pv, ks, vs, table, q_pos, lengths, window, splits=S)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"splits={S}: {m}")
        again = pa_ops._launch(q, pk, pv, ks, vs, table, q_pos, lengths, window, splits=S)
        assert torch.equal(again, got), f"splits={S}: two launches differ"


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2), ("int8", 2e-2)])
def test_paged_attention_verify_chunks(gen, C, kind, tol):
    """Speculative decode's end and verify chunks: C = k rows a slot of the
    streaming engine's 4-slot group (dense and int8 pools), through the
    wrapper, within the plain version's tolerance; two launches equal."""
    q, pk, pv, (ks, vs), table, q_pos, lengths = _split_case(gen, "stream", C, kind)
    want = paged_attention_plain(q, pk, pv, table, q_pos, lengths, k_scale=ks, v_scale=vs)
    if kind == "int8":
        def run():
            return paged_attention_quant(q, pk, pv, ks, vs, table, q_pos, lengths)
    else:
        def run():
            return paged_attention(q, pk, pv, table, q_pos, lengths)
    got = run()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(run(), got)


def _serving_shape_run(gen, C, kind, tol, H, KV, hd, window=None, splits=()):
    """8 slots of ``H`` query heads on ``KV`` kv heads of ``hd``, 16-token
    pages, 16-page rings, one slot past a wrap, the C rows ending at each
    slot's anchor: through the wrappers, one launch counted, within the
    plain version's tolerance, a second launch the same bits; then each
    split count of ``splits`` through ``_launch``."""
    B, ps, pps = 8, 16, 16
    lengths = torch.tensor([0, 15, 16, 47, 100, 199, 231, 300], dtype=torch.int32)
    P = B * pps
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(C)).view(B, pps)
    table = torch.full((B, pps), P, dtype=torch.int32)
    for b, ln in enumerate(lengths.tolist()):
        mapped = min(pps, ln // ps + 1)
        table[b, :mapped] = perm[b, :mapped].int()
    q_pos = (lengths[:, None] - (C - 1) + torch.arange(C, dtype=torch.int32)[None]).clamp_min(0)
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    q = torch.randn(B, C, H, hd, generator=gen, device="cuda").to(dt)
    pk = torch.randn(P + 1, ps, KV, hd, generator=gen, device="cuda").to(dt)
    pv = torch.randn(P + 1, ps, KV, hd, generator=gen, device="cuda").to(dt)
    table, q_pos, lengths = table.cuda(), q_pos.int().cuda(), lengths.cuda()
    ks = vs = None
    if kind == "int8":
        (pk, ks), (pv, vs) = quantize_kv_tokens(pk), quantize_kv_tokens(pv)
        wrapper = paged_attention_quant

        def run():
            return paged_attention_quant(q, pk, pv, ks, vs, table, q_pos, lengths,
                                         window=window)
    else:
        wrapper = paged_attention

        def run():
            return paged_attention(q, pk, pv, table, q_pos, lengths, window=window)
    want = paged_attention_plain(q, pk, pv, table, q_pos, lengths, window=window,
                                 k_scale=ks, v_scale=vs)
    before = wrapper.launches
    got = run()
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(run(), got)
    for S in splits:
        got = pa_ops._launch(q, pk, pv, ks, vs, table, q_pos, lengths, window, splits=S)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"splits={S}: {m}")


@pytest.mark.parametrize("C", [1, 5, 32])
@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2), ("int8", 2e-2)])
def test_paged_attention_qwen2_vl_shapes(gen, C, kind, tol):
    """qwen2-vl-2b's serving shapes: 8 slots, 12 query heads on 2 kv heads
    of 128 (G = 6), 16-token pages, 16-page rings, one slot past a wrap.
    Decode (C * G = 6 rows) and a 5-row verify chunk (30 rows) and a
    32-row prompt chunk (192 rows): bf16 pools of 16 rows or more take the
    tensor-core body at HD = 128, the rest the CUDA cores; split_plan gives
    16 splits (one a table entry) at B * KV = 16.  Through the wrappers, one launch counted,
    within the plain version's tolerance; a second launch gives the same
    bits."""
    assert pa_ops.split_plan(8, 2, 16) == 16
    _serving_shape_run(gen, C, kind, tol, 12, 2, 128)


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("C", [1, 5, 32])
@pytest.mark.parametrize("kind,tol", [("f32", 1e-5), ("bf16", 2e-2), ("int8", 2e-2)])
def test_paged_attention_head_dim_120(gen, C, kind, tol, window):
    """h2o-danube-3-4b's serving shapes: 32 query heads on 8 kv heads of
    120 (G = 4), computed at a width of 128 over rows of stride 120.  Decode
    (4 rows a kv head) on the CUDA cores, a 5-row chunk (20 rows) and a
    32-row chunk (128 rows) on the tensor cores in bf16 (the CUDA cores
    for f32 and int8 pools), with and without a window; every output
    column within the plain version's tolerance, at the planned split
    count and at 1, 3 and 16 splits."""
    assert 120 in pa_ops.HEAD_DIMS
    _serving_shape_run(gen, C, kind, tol, 32, 8, 120, window=window, splits=(1, 3, 16))


FFN_SIZES = [  # 4 groups; totals 2, 63, 64, 65 and 1024 around the tensor-core rule's 64
    [0, 0, 0, 0], [0, 1, 62, 0], [0, 64, 0, 0], [1, 64, 0, 0], [63, 0, 1, 1], [0, 65, 0, 0],
    [1024, 0, 0, 0],
]


@pytest.mark.parametrize("sizes", FFN_SIZES)
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_grouped_mlp_paths(gen, sizes, gated, dtype, tol):
    """Both paths of ``ffn_plan`` (bf16 at n >= 64 on the tensor cores):
    within tolerance of the plain version, rows past sum(group_sizes)
    exactly 0, and a second launch gives the same bits."""
    E, d, f = 4, 96, 200
    n = sum(sizes) + 2
    xs = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    wi = (torch.randn(E, d, f, generator=gen, device="cuda") / d ** 0.5).to(dtype)
    wg = (torch.randn(E, d, f, generator=gen, device="cuda") / d ** 0.5).to(dtype) if gated else None
    wo = (torch.randn(E, f, d, generator=gen, device="cuda") / f ** 0.5).to(dtype)
    act = "silu" if gated else "gelu"
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    got = grouped_mlp(xs, gs, wi, wg, wo, act)
    want = grouped_mlp_plain(xs, gs, wi, wg, wo, act)
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * scale)
    assert bool((got[-2:] == 0).all())
    assert torch.equal(grouped_mlp(xs, gs, wi, wg, wo, act), got)


@pytest.mark.parametrize("d", [1032, 1100, 5120])  # 129 and 138 column groups; llama4-scout
@pytest.mark.parametrize("sizes", [[3, 0, 4, 1], [30, 0, 41, 1]])  # both paths in bf16
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_grouped_mlp_wide_d_model(gen, d, sizes, dtype, tol):
    """Widths past 1024 (the streaming block's output columns in passes of
    its 128 threads; d = 1100 takes the scalar loads), gated SiLU with a
    short hidden width: the grouped wrapper and the resident one over f32
    and int8 stores within tolerance of their plain versions, garbage-slot
    rows exactly 0, and the same bits from a second launch."""
    E, f = 4, 264
    w = {k: torch.randn(E, *shape, generator=gen, device="cuda") / shape[0] ** 0.5
         for k, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    for t in w.values():
        t[E - 1] = 0  # the resident store's garbage slab
    n = sum(sizes)
    xs = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    ids = torch.tensor([2, 0, 1, E - 1], dtype=torch.int32, device="cuda")
    wd = {k: t.to(dtype) for k, t in w.items()}
    q = {k: quantize_slab(t) for k, t in w.items()}
    qkw = dict(wi_scale=q["wi"][1], wg_scale=q["wg"][1], wo_scale=q["wo"][1])
    calls = [
        (lambda: grouped_mlp(xs, gs, wd["wi"], wd["wg"], wd["wo"], "silu"),
         grouped_mlp_plain(xs, gs, wd["wi"], wd["wg"], wd["wo"], "silu")),
        (lambda: grouped_mlp_resident(xs, gs, w["wi"], w["wg"], w["wo"], ids, "silu"),
         grouped_mlp_resident_plain(xs, gs, w["wi"], w["wg"], w["wo"], ids, "silu")),
        (lambda: grouped_mlp_resident_quant(xs, gs, q["wi"][0], q["wg"][0], q["wo"][0], ids,
                                            "silu", **qkw),
         grouped_mlp_resident_quant_plain(xs, gs, q["wi"][0], q["wg"][0], q["wo"][0], ids,
                                          "silu", **qkw)),
    ]
    for i, (call, want) in enumerate(calls):
        got = call()
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol * scale,
                                   msg=lambda m: f"call {i}: {m}")
        if i:
            assert bool((got[n - sizes[-1]:] == 0).all())
        assert torch.equal(call(), got)


@pytest.mark.parametrize("sizes", [[2, 0, 1, 1], [0, 62, 1, 0], [1, 64, 0, 0],
                                   [63, 0, 1, 1], [0, 1023, 0, 1]])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("store", ["f32", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resident_and_grouped_give_equal_bits(gen, sizes, gated, store, dtype):
    """A row routed to the same expert gets the same bits through the
    resident wrapper (f32 store cast on read, int8 store dequantized then
    cast) and through ``grouped_mlp`` over the slabs gathered and converted
    beforehand, on both paths; garbage-slot rows exactly 0."""
    N, d, f = 6, 96, 200
    w = {k: torch.randn(N + 1, *shape, generator=gen, device="cuda") / shape[0] ** 0.5
         for k, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    for t in w.values():
        t[N] = 0  # the garbage slab
    if not gated:
        del w["wg"]
    ids = torch.tensor([4, 1, 2, N], dtype=torch.int32, device="cuda")
    idx = ids.long()
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    n = sum(sizes)
    xs = torch.randn(n, d, generator=gen, device="cuda").to(dtype)
    act = "silu" if gated else "gelu"
    if store == "f32":
        got = grouped_mlp_resident(xs, gs, w["wi"], w.get("wg"), w["wo"], ids, act)
        dense = {k: t[idx].to(dtype) for k, t in w.items()}
    else:
        q = {k: quantize_slab(t) for k, t in w.items()}
        got = grouped_mlp_resident_quant(
            xs, gs, q["wi"][0], q["wg"][0] if gated else None, q["wo"][0], ids, act,
            wi_scale=q["wi"][1], wg_scale=q["wg"][1] if gated else None, wo_scale=q["wo"][1])
        dense = {k: (c[idx].float() * sc[idx][:, None, :]).to(dtype) for k, (c, sc) in q.items()}
    want = grouped_mlp(xs, gs, dense["wi"], dense.get("wg"), dense["wo"], act)
    live = n - sizes[-1]
    assert torch.equal(got[:live], want[:live])
    assert bool((got[live:] == 0).all())


@pytest.mark.parametrize("name", ["switch-base", "llama4-scout-17b-16e"])
def test_stream_engine_on_card_matches_cpu(gen, name):
    """Greedy tokens of the streaming engine on the f32 smoke model at the
    middle split with the codec on: the pooled end tier launches the
    resident kernel on the card and gives the CPU's tokens (both draw the
    same default codec: a CPU generator and a QR on the CPU)."""
    cfg = smoke_config(get_config(name)).replace(num_layers=4, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 500, size=int(rng.integers(4, 40))).astype(np.int32)
               for _ in range(5)]
    tokens = {}
    for dev in ("cpu", "cuda"):
        eng = EndCloudServingEngine(
            Model(cfg, device=dev), to_device(params, dev), end_profile=PROFILES["a100"],
            cloud_profile=PROFILES["a100"], max_batch=4, max_len=64, force_split=1,
            compression_rank=cfg.d_model // 2, timing="modeled", prefill_chunk=8,
        )
        before = grouped_mlp_resident.launches
        reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        tokens[dev] = [r.generated for r in reqs]
        assert eng.end_pool.pages_in_use == eng.cloud_pool.pages_in_use == 0
        if dev == "cuda":
            assert grouped_mlp_resident.launches > before
    assert tokens["cuda"] == tokens["cpu"]


@pytest.mark.parametrize("name", ["switch-base", "llama4-scout-17b-16e"])
def test_dispatch_codec_engines_on_card_match_cpu(gen, name):
    """The MoE dispatch codec (rank d_model // 2 on the expert dispatch), f32
    smoke model: the paged serving engine and the streaming engine at the
    middle split (pooled end tier) launch the roundtrip twice a gate launch
    on the card, the boundary codec's projections never (the engines get
    no boundary codec here), and give the CPU's tokens."""
    cfg = smoke_config(get_config(name)).replace(
        num_layers=4, dtype="float32",
        compression=CompressionConfig(rank=64, boundaries=("dispatch",), recon_weight=0.05))
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 500, size=int(rng.integers(4, 40))).astype(np.int32)
               for _ in range(5)]
    counters = (lowrank_roundtrip_loss, group_gate, lowrank_encode)
    tokens = {}
    for dev in ("cpu", "cuda"):
        for kind in ("serving", "stream"):
            model, p = Model(cfg, device=dev), to_device(params, dev)
            if kind == "serving":
                eng = ServingEngine(model, p, max_batch=4, max_len=64, prefill_chunk=8)
            else:
                eng = EndCloudServingEngine(
                    model, p, end_profile=PROFILES["a100"], cloud_profile=PROFILES["a100"],
                    max_batch=4, max_len=64, force_split=1, timing="modeled", prefill_chunk=8)
            before = [c.launches for c in counters]
            reqs = [Request(i, q, max_new_tokens=6) for i, q in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            tokens[dev, kind] = [r.generated for r in reqs]
            rt, gate, enc = (c.launches - b for c, b in zip(counters, before))
            if dev == "cuda":
                assert rt > 0 and rt == 2 * gate and enc == 0
    assert tokens["cuda", "serving"] == tokens["cpu", "serving"]
    assert tokens["cuda", "stream"] == tokens["cpu", "stream"]


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "llama4-scout-17b-16e"])
def test_stream_engine_int8_streams_on_card_match_cpu(gen, name):
    """The streaming engine with all three int8 streams on, f32 smoke model,
    middle split, codec on: the int8 kernels launch on the card (the
    boundary's through the codec's fused forms, so no standalone
    dequantize) and give the CPU's tokens."""
    cfg = smoke_config(get_config(name)).replace(num_layers=4, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 500, size=int(rng.integers(4, 40))).astype(np.int32)
               for _ in range(5)]
    counters = (quantize_rows, lowrank_encode_quant, lowrank_decode_quant,
                paged_attention_quant, dequantize_rows)
    tokens = {}
    for dev in ("cpu", "cuda"):
        # counted from before the engine's build, which writes the first slabs
        before = [c.launches for c in counters] + [grouped_mlp_resident_quant.launches]
        eng = EndCloudServingEngine(
            Model(cfg, device=dev), to_device(params, dev), end_profile=PROFILES["a100"],
            cloud_profile=PROFILES["a100"], max_batch=4, max_len=64, force_split=2,
            compression_rank=cfg.d_model // 2, timing="modeled", prefill_chunk=8,
            quantize_kv=True, quantize_experts=True, quantize_boundary=True,
        )
        reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        tokens[dev] = [r.generated for r in reqs]
        assert eng.end_pool.pages_in_use == eng.cloud_pool.pages_in_use == 0
        after = [c.launches for c in counters] + [grouped_mlp_resident_quant.launches]
        if dev == "cuda":
            # quantize_rows: the slab writes (an int8 store only with experts)
            assert (after[0] > before[0]) == (cfg.moe is not None)
            assert all(a > b for a, b in zip(after[1:4], before[1:4]))
            assert after[4] == before[4] and (after[5] > before[5]) == (cfg.moe is not None)
    assert tokens["cuda"] == tokens["cpu"]


def _serve_spec(cfg, params, dev, **kw):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 500, size=int(rng.integers(4, 40))).astype(np.int32)
               for _ in range(5)]
    eng = EndCloudServingEngine(
        Model(cfg, device=dev), to_device(params, dev), end_profile=PROFILES["a100"],
        cloud_profile=PROFILES["a100"], max_batch=4, max_len=64, force_split=2,
        timing="modeled", prefill_chunk=8, spec_k=4, link_rtt_s=0.05, **kw)
    reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.end_pool.pages_in_use == eng.cloud_pool.pages_in_use == 0
    return [r.generated for r in reqs], eng.metrics()


SPEC_KEYS = ("spec_plan_k", "spec_k_eff", "spec_rounds", "spec_drafted", "spec_accepted",
             "spec_rollbacks", "n_host_syncs", "n_stage_steps", "bytes_up")


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "llama4-scout-17b-16e"])
@pytest.mark.parametrize("quant", [False, True])
def test_spec_engine_on_card_matches_cpu(gen, name, quant):
    """Speculative decode on the f32 smoke model (middle split, k = 4
    planned): draft installs launch flash attention and the verify chunks
    paged attention on the card; tokens and the speculative counters equal
    the CPU's, with and without the int8 KV pages and boundary."""
    cfg = smoke_config(get_config(name)).replace(num_layers=4, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    kw = dict(quantize_kv=True, quantize_boundary=True) if quant else {}
    before = flash_attention_fwd.launches, paged_attention.launches + paged_attention_quant.launches
    card, mc = _serve_spec(cfg, params, "cuda", **kw)
    after = flash_attention_fwd.launches, paged_attention.launches + paged_attention_quant.launches
    host, mh = _serve_spec(cfg, params, "cpu", **kw)
    assert after[0] > before[0] and after[1] > before[1]
    assert mc["spec_rounds"] > 0
    assert card == host
    assert {k: mc[k] for k in SPEC_KEYS} == {k: mh[k] for k in SPEC_KEYS}


@pytest.mark.parametrize("quant", [False, True])
def test_preemption_on_card_matches_cpu(gen, quant):
    """Two low-priority requests decode in both slots, an interactive one
    spills the younger: on the card and on the CPU the same victim, spill
    bytes and tokens, and the tokens of a run without preemption."""
    cfg = smoke_config(get_config("tinyllama-1.1b")).replace(num_layers=4, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, 500, size=n).astype(np.int32) for n in (12, 14, 9)]
    out = {}
    for dev, preempt in (("cuda", True), ("cpu", True), ("cuda", False)):
        eng = EndCloudServingEngine(
            Model(cfg, device=dev), to_device(params, dev), end_profile=PROFILES["a100"],
            cloud_profile=PROFILES["a100"], max_batch=2, max_len=64, force_split=2,
            timing="modeled", preemption=preempt, quantize_kv=quant)
        a1, a2 = (Request(i, prompts[i], max_new_tokens=12, priority=2) for i in range(2))
        eng.submit(a1)
        eng.submit(a2)
        while len(a1.generated) < 3 or len(a2.generated) < 3:
            eng.step()
        eng.submit(Request(2, prompts[2], max_new_tokens=12, priority=0))
        done = eng.run()
        m = eng.metrics()
        assert m["kv_pages_in_use"] == 0 and m["preemptions"] == m["preempt_restores"]
        out[dev, preempt] = ({r.request_id: r.generated for r in done}, a2.n_preemptions,
                             m["preempt_spill_bytes"])
    assert out["cuda", True][1] == 1 and out["cuda", True][2] > 0
    assert out["cuda", True] == out["cpu", True]
    assert out["cuda", True][0] == out["cuda", False][0]


@pytest.mark.parametrize("name", ["switch-base", "llama4-scout-17b-16e", "qwen2-vl-2b"])
def test_engine_on_card_matches_cpu(gen, name):
    """Greedy tokens of the f32 smoke model: kernels on the card, plain
    versions on the CPU, the same weights."""
    cfg = smoke_config(get_config(name)).replace(num_layers=4, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, device=dev)
        eng = ServingEngine(model, to_device(params, dev), max_batch=4, max_len=64,
                            prefill_chunk=8)
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, 500, size=int(rng.integers(4, 30))).astype(np.int32),
                        max_new_tokens=6) for i in range(9)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        assert eng.pool.pages_in_use == 0
        tokens[dev] = [r.generated for r in reqs]
    assert tokens["cuda"] == tokens["cpu"]


def test_vlm_prefill_on_card_matches_cpu(gen):
    """Smoke qwen2-vl-2b in f32: 16 patch embeddings on a 4 x 4 grid then
    text, ``Model.prefill`` (flash attention on the card) and 6 greedy
    ``decode_step`` s: logits within 1e-4 of the CPU's, equal tokens."""
    cfg = smoke_config(get_config("qwen2-vl-2b")).replace(num_layers=4, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    P, T = cfg.vision_patches, 20
    i = np.arange(P)
    pos = np.concatenate([np.stack([0 * i, i // 4, i % 4]),
                          np.broadcast_to(4 + np.arange(T), (3, T))], axis=1)
    batch = {"tokens": rng.integers(0, 500, size=(2, T)).astype(np.int32),
             "patch_embeds": rng.standard_normal((2, P, cfg.d_model)).astype(np.float32),
             "positions": np.broadcast_to(pos, (2, 3, P + T)).astype(np.int32)}
    out = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, device=dev)
        p = to_device(params, dev)
        before = flash_attention_fwd.launches
        logits, cache = model.prefill(p, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                                      max_len=P + T + 6)
        seq = [logits]
        for _ in range(6):
            logits, cache = model.decode_step(p, logits.argmax(-1).int()[:, None], cache)
            seq.append(logits)
        out[dev] = torch.stack(seq).cpu()
        if dev == "cuda":
            assert flash_attention_fwd.launches == before + cfg.num_layers
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)
    assert torch.equal(out["cuda"].argmax(-1), out["cpu"].argmax(-1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window,q_offset", [
    (2, 64, 64, 4, 4, 32, True, None, 0),
    (2, 200, 200, 8, 2, 64, True, 64, 0),  # ragged S, GQA, window tile skip
    (1, 100, 100, 4, 1, 128, False, None, 0),
    (2, 70, 70, 4, 2, 64, False, 20, 0),
    (1, 40, 150, 4, 2, 32, True, 30, 110),  # queries at the end of the keys
    (1, 8, 16, 2, 2, 32, True, 4, 16),  # rows with no visible key -> 0
    (2, 256, 256, 4, 4, 128, True, None, 0),  # hd 128 over four causal q tiles
    (2, 130, 130, 4, 2, 32, True, None, 0),  # hd 32, ragged tail tiles
    (1, 64, 300, 8, 2, 64, True, None, 236),  # Skv > Sq, queries at the end of the keys
    (2, 190, 190, 8, 2, 64, True, 40, 0),  # GQA G = 4 with a window
    (2, 301, 301, 12, 2, 128, True, None, 0),  # qwen2-vl: 256 patches + 45 text, G = 6
    (1, 45, 301, 12, 2, 128, True, None, 256),  # G = 6, queries at the end of the keys
    # h2o-danube-3-4b: 32 heads on 8 kv heads of 120, computed at 128 over stride 120
    (2, 256, 256, 32, 8, 120, True, None, 0),
    (2, 256, 256, 32, 8, 120, True, 64, 0),  # with a window
    (1, 45, 301, 32, 8, 120, True, None, 256),  # queries at the end of the keys
    (2, 100, 100, 8, 2, 120, False, None, 0),  # ragged, not causal
    # whisper-base: cross-attention (decoder rows on 1500 frames) and the
    # bidirectional encoder, 8 heads of 64, not causal
    (1, 64, 1500, 8, 8, 64, False, None, 0),
    (2, 1500, 1500, 8, 8, 64, False, None, 0),
])
def test_flash_attention_kernel(gen, dtype, B, Sq, Skv, H, KV, hd, causal, window, q_offset):
    q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    assert flash_attention_fwd.launches == before + 1
    # same tiles, sums in another order; bf16: p and the output round once
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention_fwd(q, k.float() if dtype == torch.bfloat16 else k.bfloat16(), v, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, **kw)


def test_encdec_on_card_matches_cpu(gen):
    """Smoke whisper-base in f32 (2 decoder blocks of self- and
    cross-attention over a 2-layer bidirectional encoder of 64 frames):
    ``Model.prefill`` (flash attention on the card: the encoder's, the
    decoder's causal and the cross-attention, one launch each a layer) and
    6 greedy ``decode_step`` s over the dense rings and the cross cache (no
    kernel): logits within 1e-4 of the CPU's, equal tokens, equal caches."""
    cfg = smoke_config(get_config("whisper-base")).replace(num_layers=2, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 500, size=(2, 20)).astype(np.int32),
             "frame_embeds": rng.standard_normal(
                 (2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}
    out, caches = {}, {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, device=dev)
        p = to_device(params, dev)
        before = flash_attention_fwd.launches
        logits, cache = model.prefill(p, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                                      max_len=32)
        if dev == "cuda":
            assert flash_attention_fwd.launches == before + cfg.encoder_layers + 2 * cfg.num_layers
        seq = [logits]
        for _ in range(6):
            logits, cache = model.decode_step(p, logits.argmax(-1).int()[:, None], cache)
            seq.append(logits)
        if dev == "cuda":
            assert flash_attention_fwd.launches == before + cfg.encoder_layers + 2 * cfg.num_layers
        out[dev] = torch.stack(seq).cpu()
        caches[dev] = {n: t.cpu() for n, t in cache["blocks"]["pos0"].items()}
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)
    assert torch.equal(out["cuda"].argmax(-1), out["cpu"].argmax(-1))
    assert sorted(caches["cuda"]) == ["k", "v", "xk", "xv"]
    for n, t in caches["cuda"].items():
        torch.testing.assert_close(t, caches["cpu"][n], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_rows_without_a_visible_key(gen, dtype):
    """The card counterpart of ``test_torch_flash_attention.py``'s: the kernel
    leaves a row that sees no key at 0, and the consumer fills it with the
    mean of V, as on the CPU; every other row agrees with the CPU's."""
    from repro_torch.models.attention import flash_attention

    q = torch.randn(1, 8, 4, 32, generator=gen, device="cuda").to(dtype)
    k = torch.randn(1, 16, 2, 32, generator=gen, device="cuda").to(dtype)
    v = torch.randn(1, 16, 2, 32, generator=gen, device="cuda").to(dtype)
    for window, q_offset, blind in ((4, 16, torch.arange(8) + 16 - 4 >= 15),
                                    (None, -3, torch.arange(8) - 3 < 0)):
        kw = dict(causal=True, window=window, q_offset=q_offset)
        raw = flash_attention_fwd(q, k, v, **kw)
        assert bool((raw[:, blind] == 0).all())
        got = flash_attention(q, k, v, **kw)
        want = flash_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
        tol = 1e-5 if dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [4, 32, 1000])
def test_lowrank_project_stream_widths(gen, dtype, T):
    """Encode and decode at the streaming engine's widths (d = 768, r =
    384) and row counts (its decode group step, its prefill chunk, and a
    ragged 1000): each against its plain version, and two launches give the
    same bits."""
    d, r = 768, 384
    x = torch.randn(T, d, generator=gen, device="cuda").to(dtype)
    q = torch.linalg.qr(torch.randn(d, r, generator=gen, device="cuda"))[0]
    enc, dec = q.to(dtype).contiguous(), q.T.to(dtype).contiguous()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    counts = (lowrank_encode.launches, lowrank_decode.launches)
    z = lowrank_encode(x, enc)
    xh = lowrank_decode(z, dec)
    assert (lowrank_encode.launches, lowrank_decode.launches) == (counts[0] + 1, counts[1] + 1)
    torch.testing.assert_close(z.float(), lowrank_project_plain(x, enc).float(), **tol)
    torch.testing.assert_close(xh.float(), lowrank_project_plain(z, dec).float(), **tol)
    assert torch.equal(lowrank_encode(x, enc), z) and torch.equal(lowrank_decode(z, dec), xh)


def test_bf16_kernels_take_unaligned_operands(gen):
    """Operands that start 2 bytes past a 16-byte boundary (contiguous views
    into a larger buffer) take the bf16 kernels' scalar loads, not cp.async."""

    def unaligned(*shape):
        buf = torch.randn(1 + int(np.prod(shape)), generator=gen, device="cuda").bfloat16()
        t = buf[1:].view(*shape)
        assert t.is_contiguous() and t.data_ptr() % 16 == 2
        return t

    q, k, v = unaligned(2, 100, 4, 64), unaligned(2, 100, 2, 64), unaligned(2, 100, 2, 64)
    want = flash_attention_plain(q, k, v, causal=True, window=None)
    torch.testing.assert_close(flash_attention_fwd(q, k, v).float(), want.float(),
                               rtol=2 ** -7, atol=2 ** -7)
    x, w = unaligned(40, 96), unaligned(96, 48)
    torch.testing.assert_close(lowrank_encode(x, w).float(),
                               lowrank_project_plain(x, w).float(), rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("odd", ["width", "alignment"])
def test_bf16_projection_scalar_path_is_deterministic(gen, odd):
    """The bf16 projection's scalar loads (k not a multiple of 8, or an
    operand not 16-byte aligned) fill the ring with plain stores that other
    warps' wgmma read: a hundred launches give the bits of the first, which
    agree with the plain version.  Several K steps, so every ring slot is
    filled and refilled."""
    if odd == "width":
        x = torch.randn(200, 770, generator=gen, device="cuda").bfloat16()
        w = torch.randn(770, 90, generator=gen, device="cuda").bfloat16()
    else:
        buf = torch.randn(1 + 200 * 768, generator=gen, device="cuda").bfloat16()
        x = buf[1:].view(200, 768)
        assert x.data_ptr() % 16 == 2
        w = torch.randn(768, 384, generator=gen, device="cuda").bfloat16()
    first = lowrank_encode(x, w)
    ref = lowrank_project_plain(x, w).float()
    torch.testing.assert_close(first.float(), ref, rtol=2 ** -7,
                               atol=2 ** -6 * ref.abs().median().item())
    for _ in range(100):
        assert torch.equal(lowrank_encode(x, w), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,r", [(1024, 768, 384), (37, 96, 24), (1, 64, 64), (37, 90, 22),
                                   (1024, 1536, 384), (4, 1536, 384)])  # qwen2-vl's width
def test_lowrank_kernels(gen, dtype, T, d, r):
    x = torch.randn(T, d, generator=gen, device="cuda").to(dtype)
    q = torch.linalg.qr(torch.randn(d, r, generator=gen, device="cuda"))[0]
    enc, dec = q.to(dtype).contiguous(), q.T.to(dtype).contiguous()
    # f32 sums in another order; bf16 outputs round once (one ulp)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    counts = (lowrank_encode.launches, lowrank_decode.launches, lowrank_roundtrip.launches)
    z = lowrank_encode(x, enc)
    torch.testing.assert_close(z.float(), lowrank_project_plain(x, enc).float(), **tol)
    xh = lowrank_decode(z, dec)
    torch.testing.assert_close(xh.float(), lowrank_project_plain(z, dec).float(), **tol)
    xr, err = lowrank_roundtrip(x, enc, dec)
    xr_p, err_p = lowrank_roundtrip_plain(x, enc, dec)
    torch.testing.assert_close(xr.float(), xr_p.float(), **tol)
    torch.testing.assert_close(err, err_p, rtol=1e-4, atol=1e-6)
    assert (lowrank_encode.launches, lowrank_decode.launches, lowrank_roundtrip.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)
    again, err2 = lowrank_roundtrip(x, enc, dec)
    assert torch.equal(again, xr) and torch.equal(err2, err)  # deterministic, no atomics
    with pytest.raises(ValueError, match="dtype"):
        lowrank_encode(x, enc.float() if dtype == torch.bfloat16 else enc.bfloat16())


def _roundtrip_case(gen, T, d, r, dtype):
    x = torch.randn(T, d, generator=gen, device="cuda").to(dtype)
    q = torch.linalg.qr(torch.randn(d, r, generator=gen, device="cuda"))[0]
    return x, q.to(dtype).contiguous(), q.T.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,d,r", [
    (1, 768, 384), (4, 768, 384), (8, 768, 384), (32, 768, 384), (1000, 768, 384),
    (1024, 768, 384), (8, 768, 512), (1000, 768, 512),  # 6 and 8 column tiles a cluster
    (4, 768, 100), (37, 96, 24), (37, 90, 22),  # the scalar loads (r or d not a multiple of 8)
    (130, 768, 256),  # 4 blocks a cluster, 3 row tiles, the last ragged
])
def test_roundtrip_loss_kernel(gen, dtype, T, d, r):
    """The consumer's roundtrip against its plain version: X̂ within one
    rounding (f32: 1e-5; bf16: 2^-7 and 2^-7 max|X̂|, Z rounded once more
    between the products), the error sum against the plain sum over the
    kernel's own X̂ (the reduction: rtol 1e-5) and against the plain
    version's (f32 1e-5; bf16 1e-3: a few X̂ values one ulp apart), the
    mean the sum over T*d, one launch counted."""
    x, enc, dec = _roundtrip_case(gen, T, d, r, dtype)
    before = lowrank_roundtrip_loss.launches
    xh, sq, mean = lowrank_roundtrip_loss(x, enc, dec)
    assert lowrank_roundtrip_loss.launches == before + 1
    torch.cuda.synchronize()
    xp, sqp, _ = lowrank_roundtrip_loss_plain(x, enc, dec)
    assert xh.dtype == dtype and xh.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(xh, xp, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(xh.float(), xp.float(), rtol=2 ** -7,
                                   atol=2 ** -7 * xp.float().abs().max().item())
    own = (x.float() - xh.float()).square().sum()
    torch.testing.assert_close(sq, own, rtol=1e-5, atol=0)
    torch.testing.assert_close(sq, sqp, rtol=1e-5 if dtype == torch.float32 else 1e-3, atol=0)
    torch.testing.assert_close(mean, sq / (T * d), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roundtrip_loss_relaunch_bits(gen, dtype):
    """100 launches at T = 4 (the streaming group) and two at T = 1000
    (many clusters: the ticket picks the last block, whichever it is) give
    the same bits."""
    for T, n in ((4, 100), (1000, 2)):
        x, enc, dec = _roundtrip_case(gen, T, 768, 384, dtype)
        xh, sq, mean = lowrank_roundtrip_loss(x, enc, dec)
        first = (xh.clone(), sq.clone(), mean.clone())
        for _ in range(n):
            xh, sq, mean = lowrank_roundtrip_loss(x, enc, dec)
            assert torch.equal(xh, first[0]) and torch.equal(sq, first[1])
            assert torch.equal(mean, first[2])


def test_roundtrip_padded_rows_add_nothing(gen):
    """A 4-row tile's 60 padded rows: rows of x past T that hold large
    values in memory (a view's tail) are never read, and X̂ of the live
    rows and the error match a copy of the 4 rows alone."""
    x, enc, dec = _roundtrip_case(gen, 64, 768, 384, torch.bfloat16)
    x[4:] = 1e4
    head = x[:4].clone()
    xh, sq, _ = lowrank_roundtrip_loss(x[:4], enc, dec)
    xh2, sq2, _ = lowrank_roundtrip_loss(head, enc, dec)
    assert torch.equal(xh, xh2) and torch.equal(sq, sq2)
    # 4 rows of unit variance lose about half their energy to a rank-384
    # codec (~1.5e3); the 60 rows of 1e4 would add ~1e11
    assert sq.item() < 1e5


def test_roundtrip_plan_composes_wide_ranks(gen):
    """r = 640 spans 10 column tiles: roundtrip_loss_1d composes encode,
    decode and a PyTorch error sum; the fused wrapper refuses it."""
    x, enc, dec = _roundtrip_case(gen, 8, 768, 640, torch.bfloat16)
    names = (lowrank_encode, lowrank_decode, lowrank_roundtrip_loss)
    before = [f.launches for f in names]
    xh, loss = comp.roundtrip_loss_1d({"enc": enc, "dec": dec}, x)
    assert [f.launches - b for f, b in zip(names, before)] == [1, 1, 0]
    assert torch.equal(xh, lowrank_decode(lowrank_encode(x, enc), dec))
    torch.testing.assert_close(loss, (x.float() - xh.float()).square().mean())
    with pytest.raises(ValueError, match="column tiles"):
        lowrank_roundtrip_loss(x, enc, dec)


def test_roundtrip_refused_cluster_raises(gen):
    """The portable 8 blocks and the bf16 split's 12 (a non-portable
    cluster) co-schedule; 16 column tiles (their shared memory past the
    block's limit) raise."""
    assert lowrank_ops.roundtrip_clusters(torch.bfloat16, 6, 2) > 0
    for dtype in (torch.bfloat16, torch.float32):
        assert lowrank_ops.roundtrip_clusters(dtype, 8) > 0
        with pytest.raises(RuntimeError, match="co-schedules no cluster"):
            lowrank_ops.roundtrip_clusters(dtype, 16)


@pytest.mark.parametrize("rank", [0, 32])
def test_pipeline_on_card_matches_cpu(gen, rank):
    """The f32 smoke pipeline (jetson-orin end, a100 cloud): kernels on the
    card, plain versions on the CPU, the same weights and codec."""
    cfg = smoke_config(get_config("llama4-scout-17b-16e")).replace(num_layers=4, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.arange(2 * 48, dtype=torch.int32).view(2, 48) % 500
    out = {}
    for dev in ("cpu", "cuda"):
        pipe = EndCloudPipeline(Model(cfg, device=dev), to_device(params, dev),
                                end_profile=PROFILES["jetson-orin"],
                                cloud_profile=PROFILES["a100"], compression_rank=rank)
        before = flash_attention_fwd.launches
        logits, m = pipe.run_batch(tokens)
        if dev == "cuda":
            assert flash_attention_fwd.launches == before + cfg.num_layers
        out[dev] = (logits.float().cpu(), m)
    (lc, mc), (lg, mg) = out["cpu"], out["cuda"]
    for key in ("split", "compressed", "boundary_bytes", "t_comm_s"):
        assert mg[key] == mc[key], key
    assert mg["compressed"] == (rank > 0)
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)


# -- the int8 boundary folded into the codec, and the standalone quantizers ----------


def _codec_quant_case(gen, T, d, r, dtype):
    """Rows of x (an all-zero row and one whose Z is so small that its f16
    scale underflows to 0 first) and an orthonormal codec in ``dtype``."""
    x = torch.randn(T, d, generator=gen, device="cuda") * 3
    x[0] = 0
    if T > 1:
        x[1] *= 1e-7
    q = torch.linalg.qr(torch.randn(d, r, generator=gen, device="cuda"))[0]
    return x.to(dtype), q.to(dtype).contiguous(), q.T.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("r", [384, 512, 100])  # 6 and 8 column tiles; the scalar path
@pytest.mark.parametrize("T", [1, 4, 32, 128, 1024])
@pytest.mark.parametrize("d", [768, 1536])  # switch-base's and qwen2-vl's widths
def test_codec_quant_fused_kernels(gen, d, T, r, dtype):
    """The fused boundary forms bit-equal to the composed kernels (codes,
    scales and x^), each launch counted once, a second launch equal, and
    within the codec's tolerance of the plain composition."""
    x, enc, dec = _codec_quant_case(gen, T, d, r, dtype)
    before = (lowrank_encode_quant.launches, lowrank_decode_quant.launches)
    q, s = lowrank_encode_quant(x, enc)
    xh = lowrank_decode_quant(q, s, dec)
    assert (lowrank_encode_quant.launches, lowrank_decode_quant.launches) == (
        before[0] + 1, before[1] + 1)
    cq, cs = quantize_rows(lowrank_encode(x, enc), scale_dtype=torch.float16)
    assert torch.equal(q, cq) and torch.equal(s, cs)
    assert torch.equal(xh, lowrank_decode(dequantize_rows(q, s, dtype=dtype), dec))
    assert float(s[0]) == 0.0 and (T == 1 or float(s[1]) == 0.0)
    again = lowrank_encode_quant(x, enc)
    assert torch.equal(again[0], q) and torch.equal(again[1], s)
    assert torch.equal(lowrank_decode_quant(q, s, dec), xh)
    # the plain composition: Z from f32 sums in another order (one ulp in
    # bf16, so a code may sit one step off), x^ of the same codes
    z = lowrank_project_plain(x, enc).float()
    step = s.float()
    near = (q.float() * step - z).abs() <= 1.5 * step + 2 ** -7 * z.abs()
    assert bool(near[s[:, 0] > 0].all())  # rows whose f16 scale underflowed hold no values
    want = lowrank_decode_quant_plain(q, s, dec).float()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(
        rtol=2 ** -7, atol=2 ** -6 * want.abs().median().item())
    torch.testing.assert_close(xh.float(), want, **tol)


def _tie_rows(rows, n, dtype):
    """Rows whose amax is 127 (scale 1): round-half ties, values 2^-20 past
    them (within the kernels' margin: they divide) and 2^-18 past them
    (outside it: they code from the reciprocal), each sign."""
    halves = torch.arange(n, device="cuda") % 254 - 127 + 0.5  # -126.5 .. 126.5
    nudge = torch.tensor([0.0, 2 ** -20, 2 ** -18, -(2 ** -18)], device="cuda")
    x = torch.stack([halves * ((1 + nudge[i % 4]) if dtype == torch.float32 else 1.0)
                     for i in range(rows)])
    x[:, 0] = 127.0
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_codec_quant_fused_ties(gen, dtype):
    """An encode that passes x's first r columns through exactly (E = the
    first r columns of the identity), so Z holds round-half ties and
    near-ties: the fused codes equal the composed kernels'."""
    d, r = 768, 384
    x = torch.randn(8, d, generator=gen, device="cuda").to(dtype)
    x[:, :r] = _tie_rows(8, r, dtype)
    enc = torch.eye(d, device="cuda")[:, :r].contiguous().to(dtype)
    q, s = lowrank_encode_quant(x, enc)
    cq, cs = quantize_rows(lowrank_encode(x, enc), scale_dtype=torch.float16)
    assert torch.equal(s, cs) and bool((s == 1).all())
    assert torch.equal(q, cq)


def test_codec_quant_plan_composes_wide_ranks(gen):
    """r = 640 spans 10 column tiles: the compression functions compose the
    standalone kernels, each counted, the fused wrappers refuse it."""
    x, enc, dec = _codec_quant_case(gen, 8, 768, 640, torch.bfloat16)
    params = {"enc": enc, "dec": dec}
    names = (lowrank_encode, quantize_rows, dequantize_rows, lowrank_decode,
             lowrank_encode_quant, lowrank_decode_quant)
    before = [f.launches for f in names]
    q, s = comp.encode_quantized_1d(params, x)
    xh = comp.decode_quantized_1d(params, q, s, torch.bfloat16)
    assert [f.launches - b for f, b in zip(names, before)] == [1, 1, 1, 1, 0, 0]
    cq, cs = quantize_rows(lowrank_encode(x, enc), scale_dtype=torch.float16)
    assert torch.equal(q, cq) and torch.equal(s, cs)
    assert torch.equal(xh, lowrank_decode(dequantize_rows(q, s, dtype=torch.bfloat16), dec))
    with pytest.raises(ValueError, match="column tiles"):
        lowrank_encode_quant(x, enc)
    with pytest.raises(ValueError, match="column tiles"):
        lowrank_decode_quant(q, s, dec)


def test_codec_quant_refused_cluster_raises(gen):
    """The portable cluster sizes co-schedule; 16 blocks a cluster (not
    allowed without the non-portable attribute) raises."""
    for dtype in (torch.bfloat16, torch.float32):
        assert lowrank_ops.encode_quant_clusters(dtype, 8) > 0
        with pytest.raises(RuntimeError, match="co-schedules no cluster"):
            lowrank_ops.encode_quant_clusters(dtype, 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("outer,mat", [*((o, m) for o in (1, 6, 19) for m in ("wi", "wg", "wo")),
                                       (1, "scout wo")])
def test_quantize_columns_slab_shapes(gen, outer, mat, dtype):
    """The column form at the slab store's shapes (switch-base's wi / wo,
    a gated slab's wg, llama4-scout's wo, whose slices do not fit in shared
    memory) and batches of slabs: codes and scales bit-equal to the plain
    version's, an all-zero column included, one launch a call."""
    shape = {"wi": (768, 3072), "wg": (768, 3072), "wo": (3072, 768), "scout wo": (8192, 5120)}[mat]
    x = (torch.randn(outer, *shape, generator=gen, device="cuda") * 0.02).to(dtype)
    x[0, :, 5] = 0
    x[-1, :, 6:10] = _tie_rows(4, shape[0], dtype).T  # ties and near-ties down the columns
    before = quantize_rows.launches
    q, s = quantize_rows(x, axis=-2)
    assert quantize_rows.launches == before + 1
    rq, rs = quantize_rows_plain(x, axis=-2)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    cluster, staged = cols_plan(outer, *shape, x.element_size(),
                                torch.cuda.get_device_properties(0).multi_processor_count)
    assert 1 <= cluster <= 8 and staged == (mat != "scout wo")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [384, 768, 4096, 8192, 100])
def test_quantize_rows_widths(gen, n, dtype):
    """Row lines kept in registers (a whole number of 16-byte loads, at
    most 16 a lane) and the generic form (longer lines, a bf16 width of
    100, rows that start off a 16-byte boundary): codes and scales
    bit-equal to the plain version's, exact round-half ties and values a
    rounding away from them included (where the kernel divides)."""
    x = (torch.randn(37, n, generator=gen, device="cuda") * 3).to(dtype)
    x[0] = 0
    x[1] *= 1e-7
    halves = torch.arange(n, device="cuda") % 254 - 127 + 0.5  # -126.5 .. 126.5
    x[2] = (halves * (1 + (torch.arange(n, device="cuda") % 2) * 2 ** -20)).to(dtype)
    x[2, 0] = 127.0  # scale 1: every other value an exact tie, the rest just past one
    step = float(torch.tensor(3 / 127).half())  # an f16 scale that is no power of two
    x[3] = (halves * step).to(dtype)
    x[3, 0] = 127 * step
    for t in (x, x.view(-1)[1:1 + 36 * n].view(36, n)):
        q, s = quantize_rows(t, scale_dtype=torch.float16)
        rq, rs = quantize_rows_plain(t, scale_dtype=torch.float16)
        assert torch.equal(q, rq) and torch.equal(s, rs)


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sdt", [torch.float32, torch.float16])
@pytest.mark.parametrize("rows,n", [(1, 384), (4, 384), (37, 768), (5, 100), (3, 45), (2, 16)])
def test_dequantize_rows_widths(gen, rows, n, sdt, out):
    """One warp a row, 16 codes a load where the row allows: bit-equal to
    the plain version at ragged widths and row counts, and misaligned."""
    x = torch.randn(rows, n, generator=gen, device="cuda") * 3
    q, s = quantize_rows(x, scale_dtype=sdt)
    before = dequantize_rows.launches
    assert torch.equal(dequantize_rows(q, s, dtype=out), dequantize_rows_plain(q, s, dtype=out))
    assert dequantize_rows.launches == before + 1
    buf = torch.empty(rows * n + 1, dtype=torch.int8, device="cuda")
    qm = buf[1:].view(rows, n)
    qm.copy_(q)
    assert torch.equal(dequantize_rows(qm, s, dtype=out), dequantize_rows_plain(q, s, dtype=out))


@pytest.mark.parametrize("name", ["switch-base", "llama4-scout-17b-16e"])
def test_fleet_driven_on_card_matches_cpu(gen, name):
    """A two-lane fleet over one shared cloud pool (two interior splits),
    driven by ``loadgen.drive`` on a ``VirtualClock`` with a seeded schedule
    that oversubscribes it, f32 smoke model: tokens, the placement log and
    every request's stamps equal the CPU's, both lanes held cloud rows at
    once, and the pools drain."""
    from repro_torch.serving import FleetServingEngine, VirtualClock, loadgen

    cfg = smoke_config(get_config(name)).replace(num_layers=6, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cpu", "cuda"):
        fleet = FleetServingEngine(
            Model(cfg, device=dev), to_device(params, dev), end_profiles=[PROFILES["a100"]] * 2,
            cloud_profile=PROFILES["a100"], cloud_servers=1, max_batch=2, max_len=128,
            force_splits=[1, 2], compression_rank=cfg.d_model // 2, timing="modeled",
            prefill_chunk=8, clock=VirtualClock(), expert_peer_gbps=5.0)
        before = grouped_mlp_resident.launches
        most_live, step = [0], fleet.step

        def counted(fleet=fleet, step=step):
            out = step()
            most_live[0] = max(most_live[0], sum(
                fleet.cloud_pool.mapped_for(range(l._cloud_base, l._cloud_base + l.max_batch)) > 0
                for l in fleet.lanes))
            return out

        fleet.step = counted
        sched = loadgen.build_schedule(loadgen.poisson_arrivals(12, 1e4, seed=3),
                                       (loadgen.INTERACTIVE, loadgen.BATCH), seed=4)
        reqs = loadgen.drive(fleet, sched)
        runs[dev] = ([r.generated for r in reqs],
                     [(p["request_id"], p["device"]) for p in fleet.placed],
                     [(r.submit_time, r.first_token_time, r.finish_time) for r in reqs])
        assert all(r.done for r in reqs) and most_live[0] == 2
        assert fleet.metrics()["kv_pages_in_use"] == 0
        if dev == "cuda":
            assert grouped_mlp_resident.launches > before
    assert runs["cuda"][:2] == runs["cpu"][:2]
    for a, b in zip(runs["cuda"][2], runs["cpu"][2]):
        assert a == pytest.approx(b, abs=1e-9, rel=0)


def test_fleet_chaos_on_card_matches_cpu(gen):
    """The two-lane fleet of ``test_fleet_driven_on_card_matches_cpu`` with
    the exact boundary under a declared schedule (flaky uploads on lane 0;
    lane 1, at split 2, dies while it decodes and recovers), driven by
    ``loadgen.drive``: in f32 the fire log, the placement log, the fault
    counters, every request's stamps and tokens equal the CPU's; the slots
    migrate onto lane 0 at split 1, and the pools and the park drain."""
    from repro_torch.serving import FleetServingEngine, VirtualClock, loadgen
    from repro_torch.serving.faults import ChaosInjector, FaultEvent, FaultSchedule

    cfg = smoke_config(get_config("switch-base")).replace(num_layers=6, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    keys = ("lane_failures", "lane_recoveries", "migrations", "migration_restores",
            "migration_spill_bytes", "transfer_retries", "n_placed", "tokens", "splits")
    runs = {}
    for dev in ("cpu", "cuda"):
        fleet = FleetServingEngine(
            Model(cfg, device=dev), to_device(params, dev), end_profiles=[PROFILES["a100"]] * 2,
            cloud_profile=PROFILES["a100"], cloud_servers=1, max_batch=2, max_len=128,
            force_splits=[1, 2], compression_rank=0, timing="modeled", prefill_chunk=8,
            clock=VirtualClock(), expert_peer_gbps=5.0)
        inj = ChaosInjector(FaultSchedule([
            FaultEvent(0.0005, "transfer_flaky", device=0, count=2),
            FaultEvent(0.0015, "lane_crash", device=1),
            FaultEvent(0.003, "lane_recover", device=1)]), fleet)
        sched = loadgen.build_schedule(loadgen.poisson_arrivals(12, 1e4, seed=3),
                                       (loadgen.INTERACTIVE, loadgen.BATCH), seed=4)
        reqs = loadgen.drive(fleet, sched)
        m = fleet.metrics()
        runs[dev] = ([r.generated for r in reqs],
                     [(p["request_id"], p["device"]) for p in fleet.placed],
                     inj.fire_log(), {k: m[k] for k in keys},
                     [(r.submit_time, r.first_token_time, r.finish_time) for r in reqs])
        ids = [r.request_id for r in fleet.finished]
        assert all(r.done for r in reqs) and len(ids) == len(set(ids)) == 12
        assert m["kv_pages_in_use"] == 0 and not fleet._migrating and inj.pending == 0
        assert m["migrations"] == m["migration_restores"] >= 1 and m["transfer_retries"] == 2
    assert runs["cuda"][:4] == runs["cpu"][:4]
    for a, b in zip(runs["cuda"][4], runs["cpu"][4]):
        assert a == pytest.approx(b, abs=1e-9, rel=0)


# -- the Mamba-2 SSM layer and the dense-ring ServingEngine ----------------------------


def test_ssm_layer_prefill_and_decode_chain_on_card_matches_cpu(gen):
    """mamba2 smoke's layer in f32: the full-sequence forward over 64
    tokens (two 32-token chunks), a 48-token prefill (state and conv
    tails) and 16 decode steps on the card against the same on the CPU,
    at the reference test's tolerances (1e-4, the chain 3e-4)."""
    from repro_torch.models import ssm

    cfg = smoke_config(get_config("mamba2-130m"))
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        pd, xd = to_device(p, dev), x.to(dev)
        full = ssm.apply_ssm(pd, xd, cfg)
        y, (state, conv) = ssm.apply_ssm(pd, xd[:, :32], cfg, return_state=True)
        ys = [y]
        for t in range(32, 48):
            y, (state, conv) = ssm.apply_ssm_decode(pd, xd[:, t:t + 1], cfg, state, conv)
            ys.append(y)
        out[dev] = [t.cpu() for t in (full, torch.cat(ys, 1), state, *conv)]
    (fc, cc, sc, *tc), (fg, cg, sg, *tg) = out["cpu"], out["cuda"]
    torch.testing.assert_close(fg, fc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cg, cc, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(cg, fc[:, :48], rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(sg, sc, rtol=3e-4, atol=3e-4)
    for a, b in zip(tg, tc):
        torch.testing.assert_close(a, b, rtol=3e-4, atol=3e-4)


def test_dense_engine_on_card_matches_cpu(gen):
    """mamba2 smoke at 4 layers in f32 through the dense-ring
    ``ServingEngine`` (4 slots, 1- and 2-token prompts among 7): the
    card's greedy tokens equal the CPU's; no kernel launches (the SSD and
    conv are plain PyTorch)."""
    cfg = smoke_config(get_config("mamba2-130m")).replace(num_layers=4, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 500, size=n).astype(np.int32) for n in (2, 9, 1, 32, 17, 64, 5)]
    toks = {}
    for dev in ("cpu", "cuda"):
        eng = ServingEngine(Model(cfg, device=dev), to_device(params, dev), max_batch=4,
                            max_len=80)
        reqs = [Request(i, p, max_new_tokens=8) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        before = (flash_attention_fwd.launches, group_gate.launches, paged_attention.launches)
        eng.run()
        assert not eng.paged and eng.metrics()["requests_finished"] == len(prompts)
        assert (flash_attention_fwd.launches, group_gate.launches,
                paged_attention.launches) == before
        toks[dev] = [r.generated for r in reqs]
    assert toks["cuda"] == toks["cpu"]


def test_hybrid_pipeline_on_card_matches_cpu(gen):
    """jamba smoke at two blocks (16 layers: SSM, attention and top-2 MoE)
    in f32 through ``EndCloudPipeline`` (jetson-orin end, a100 cloud, rank
    64: split 1 of 2 with the codec): the card's logits equal the CPU's
    within 1e-4, flash attention launched once an attention layer, the
    gate once a MoE layer."""
    cfg = smoke_config(get_config("jamba-1.5-large-398b")).replace(num_layers=16,
                                                                  dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.arange(2 * 64, dtype=torch.int32).view(2, 64) * 7 % 500
    out = {}
    for dev in ("cpu", "cuda"):
        pipe = EndCloudPipeline(Model(cfg, device=dev), to_device(params, dev),
                                end_profile=PROFILES["jetson-orin"],
                                cloud_profile=PROFILES["a100"], compression_rank=64)
        before = (flash_attention_fwd.launches, group_gate.launches, lowrank_encode.launches)
        logits, m = pipe.run_batch(tokens)
        if dev == "cuda":
            n_attn = sum(s.kind == "attn" for s in cfg.layer_pattern) * cfg.block_repeat
            n_moe = sum(s.moe for s in cfg.layer_pattern) * cfg.block_repeat
            assert (flash_attention_fwd.launches, group_gate.launches,
                    lowrank_encode.launches) == (before[0] + n_attn, before[1] + n_moe,
                                                 before[2] + 1)
        out[dev] = (logits.float().cpu(), m)
    (lc, mc), (lg, mg) = out["cpu"], out["cuda"]
    assert (mg["split"], mg["compressed"]) == (mc["split"], mc["compressed"]) == (1, True)
    for key in ("boundary_bytes", "t_comm_s"):
        assert mg[key] == mc[key], key
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)


def _bwd_case(gen, dtype, B, Sq, Skv, H, KV, hd, causal, window, q_offset):
    """Inputs of a flash backward: q, k, v, the upstream dO, and the
    forward's output (rows without a key filled) and log-sum-exp from the
    kernel."""
    from repro_torch.kernels.flash_attention.ops import fill_rows_without_a_key

    q, dout = (torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dtype) for _ in "qo")
    k, v = (torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(dtype) for _ in "kv")
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   return_lse=True)
    fill_rows_without_a_key(out, v, causal, window, q_offset)
    return q, k, v, dout, out, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window,q_offset", [
    (4, 256, 256, 12, 12, 64, True, None, 0),  # switch-base's training shape
    (2, 256, 256, 32, 8, 120, True, 64, 0),  # h2o-danube: hd 120, a window
    (2, 200, 200, 8, 2, 32, True, None, 0),  # ragged tiles, G = 4
    (1, 40, 150, 4, 2, 128, True, 30, 110),  # queries at the end of the keys
    (2, 64, 300, 4, 4, 64, False, None, 0),  # cross-shaped, not causal
    (1, 64, 128, 4, 2, 64, True, 32, 100),  # rows that see no key (the wrapper's terms)
])
def test_flash_attention_bwd_kernel(gen, dtype, B, Sq, Skv, H, KV, hd, causal, window,
                                    q_offset):
    """dQ, dK, dV of the backward kernel against its plain version (the
    reference's ``_bwd``) on the same inputs, and the forward's log-sum-exp
    against the plain forward's.  Tolerances, of each gradient's largest
    |value|: f32 1e-4 (sums in another order); bf16 2e-2 (the outputs
    round to bf16, and dQ's dS rounds to bf16 before its product, as in
    ``_bwd``, where a sum in another order can flip a rounding)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_bwd_plain

    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, dout, out, lse = _bwd_case(gen, dtype, B, Sq, Skv, H, KV, hd, **kw)
    _, lse_plain = flash_attention_plain(q, k, v, return_lse=True, **kw)
    seen = lse_plain > -1e29
    assert torch.equal(seen, lse > -1e29)
    torch.testing.assert_close(lse[seen], lse_plain[seen], rtol=1e-5, atol=1e-4)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(dout, q, k, v, out, lse, **kw)
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(dout, q, k, v, out, lse, **kw)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rel * scale, f"{name}: max |diff| {err} vs {rel} x {scale}"
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(dout.transpose(1, 2).contiguous().transpose(1, 2), q, k, v, out,
                            lse, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_relaunches_give_equal_bits(gen, dtype):
    """Two passes in a fixed order and no atomics: 20 relaunches give the
    first launch's bits (what lets an f32 run resumed from a checkpoint
    reproduce the steps of the run that did not stop)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    kw = dict(causal=True, window=None, q_offset=0)
    args = _bwd_case(gen, dtype, 2, 256, 256, 8, 2, 64, **kw)
    q, k, v, dout, out, lse = args
    first = flash_attention_bwd(dout, q, k, v, out, lse, **kw)
    for _ in range(20):
        again = flash_attention_bwd(dout, q, k, v, out, lse, **kw)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


def test_train_step_on_card_matches_cpu(gen):
    """One f32 AdamW train step of smoke switch-base (2 blocks) on the card
    against the CPU from the same params and batch: the forward through
    the flash, gate and expert-FFN kernels, the backward through their
    autograd Functions (the flash backward kernel).  Routes (the routing
    statistics) equal, loss and grad norm within 1e-5 relative, every
    gradient leaf within 1e-4 of its largest |value|, and none all 0 on
    the card where the CPU's is not.  Params after the step: Adam's first
    update is about ``lr · g / (|g| + eps)``, which turns a gradient
    element near eps = 1e-8 (most of whose bits are then rounding) into
    any update up to lr; so every element within lr, and all but 1% of a
    leaf's within 1e-5 + 1e-5 |p|."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.launch import steps
    from repro_torch.training import optimizer as opt_mod

    cfg = smoke_config(get_config("switch-base")).replace(num_layers=4, dtype="float32")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)}
    ocfg = opt_mod.OptimizerConfig(lr=1e-3, warmup_steps=1)
    got = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, device=dev)
        p = opt_mod.tree_map(lambda t: t.to(dev, copy=True), params)  # the step updates in place
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = (flash_attention_fwd.launches, flash_attention_bwd.launches,
                  group_gate.launches, grouped_mlp.launches)
        _, metrics, grads = steps.loss_and_grads(steps.make_loss_fn(model), p, b)
        if dev == "cuda":  # 4 layers, 2 of them MoE; each block recomputed once
            assert (flash_attention_fwd.launches - before[0], flash_attention_bwd.launches
                    - before[1], group_gate.launches - before[2],
                    grouped_mlp.launches - before[3]) == (8, 4, 4, 4)
        opt = opt_mod.init_optimizer("adamw", p)
        p, opt, m2 = steps.make_train_step(model, ocfg)(p, opt, b)
        got[dev] = (metrics, to_device(grads, "cpu"), to_device(p, "cpu"), m2)
    (mc, gc, pc, sc), (mg, gg, pg, sg) = got["cpu"], got["cuda"]
    assert torch.equal(mc["expert_frac"], mg["expert_frac"].cpu())
    for key in ("loss", "ce_loss", "aux_loss"):
        torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=1e-5, atol=0)
    torch.testing.assert_close(sg["grad_norm"].cpu(), sc["grad_norm"], rtol=1e-5, atol=0)
    for a, b in zip(opt_mod.tree_leaves(gg), opt_mod.tree_leaves(gc)):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * scale
        assert a.abs().max().item() > 0 or scale == 0  # no leaf left without a gradient
    for a, b in zip(opt_mod.tree_leaves(pg), opt_mod.tree_leaves(pc)):
        diff = (a.float() - b.float()).abs()
        assert diff.max().item() <= ocfg.lr
        assert (diff > 1e-5 + 1e-5 * b.abs()).float().mean().item() <= 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,r", [(1024, 768, 384), (8, 768, 384), (256, 4096, 1024)])
def test_roundtrip_function_on_card(gen, T, d, r, dtype):
    """The dispatch codec's ``RoundtripLossFn`` on the card (its forward the
    fused roundtrip kernel to rank 512, the encode and decode kernels
    beyond) against autograd of the plain version on the same inputs: X̂,
    and dX, dE, dD (E and D f32 masters cast to the rows' type, as the
    MoE layer casts them) within 1e-5 (f32) or 2^-6 (bf16: the kernel's
    X̂ one ulp off where its sums run in another order) of each one's
    largest |value|; the launch counters rise by the kernels the plan
    names."""
    from repro_torch.kernels.lowrank import roundtrip_loss, roundtrip_plan

    x = torch.randn(T, d, generator=gen, device="cuda")
    e = torch.linalg.qr(torch.randn(d, r, generator=gen, device="cuda"))[0].contiguous()
    dec = e.T.contiguous() + 0.01 * torch.randn(r, d, generator=gen, device="cuda")
    up = torch.randn(T, d, generator=gen, device="cuda").to(dtype)

    def run(fn):
        xs, es, ds = (t.to(dtype) if t is x else t.clone() for t in (x, e, dec))
        for t in (xs, es, ds):
            t.requires_grad_(True)
        x_hat, _, mean = fn(xs, es.to(dtype), ds.to(dtype))
        ((x_hat * up).float().sum() + 0.05 * mean).backward()
        return x_hat, (xs.grad, es.grad, ds.grad)

    counters = (lowrank_roundtrip_loss, lowrank_encode, lowrank_decode)
    before = [c.launches for c in counters]
    got_hat, got = run(roundtrip_loss)
    fused = roundtrip_plan(r) == "fused"
    assert [c.launches - b for c, b in zip(counters, before)] == ([1, 0, 0] if fused
                                                                 else [0, 1, 1])
    assert type(got_hat.grad_fn).__name__ == "RoundtripLossFnBackward"
    want_hat, want = run(lowrank_roundtrip_loss_plain)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -6
    for name, g, w in zip(("x_hat", "dx", "denc", "ddec"), (got_hat, *got), (want_hat, *want)):
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rel * scale, f"{name}: max |diff| {err} vs {rel} x {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv", [(1500, 1500), (256, 1500)])  # encoder; cross
def test_flash_attention_function_whisper_shapes(gen, dtype, Sq, Skv):
    """``attention.flash_attention`` under grad (``FlashAttentionFn``: the
    forward kernel with its log-sum-exp, the backward kernel) at whisper's
    non-causal encoder [4, 1500, 8, 64] and its cross-attention 256 on
    1500, against the plain forward and backward (the reference's
    ``_bwd``) on the same inputs: output, dq, dk, dv within 1e-4 (f32) or
    2e-2 (bf16) of each one's largest |value|."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_bwd_plain
    from repro_torch.models.attention import flash_attention

    q, dout = (torch.randn(4, Sq, 8, 64, generator=gen, device="cuda").to(dtype) for _ in "qo")
    k, v = (torch.randn(4, Skv, 8, 64, generator=gen, device="cuda").to(dtype) for _ in "kv")
    before = flash_attention_fwd.launches, flash_attention_bwd.launches
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = flash_attention(qs, ks, vs, causal=False)
    out.backward(dout)
    assert (flash_attention_fwd.launches - before[0],
            flash_attention_bwd.launches - before[1]) == (1, 1)
    want_out, lse = flash_attention_plain(q, k, v, causal=False, return_lse=True)
    want = flash_attention_bwd_plain(dout, q, k, v, want_out, lse, causal=False, window=None,
                                     q_offset=0)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("out", "dq", "dk", "dv"), (out, qs.grad, ks.grad, vs.grad),
                          (want_out, *want)):
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rel * scale, f"{name}: max |diff| {err} vs {rel} x {scale}"


@pytest.mark.parametrize("name", ["mamba2-130m", "switch-base codec", "whisper-base"])
def test_train_step_7b_on_card_matches_cpu(gen, name):
    """One f32 train step on the card against the CPU from the same params
    and batch: mamba2 smoke (the SSM in plain PyTorch: no kernel launches),
    switch-base smoke with a rank-32 dispatch codec (the roundtrip kernel
    inside ``RoundtripLossFn``, 2 launches a MoE layer, doubled by the
    recomputation) and whisper-base smoke (encoder and cross-attention
    through the flash kernels).  Loss, ``recon_loss`` and grad norm within
    1e-5 relative, every gradient leaf within 1e-4 of its largest |value|
    and none all 0 on the card only; the params after the step as
    ``test_train_step_on_card_matches_cpu`` holds them."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.launch import steps
    from repro_torch.training import optimizer as opt_mod

    cfg = smoke_config(get_config(name.split()[0])).replace(dtype="float32")
    if name.endswith("codec"):
        cfg = cfg.replace(num_layers=4, compression=CompressionConfig(
            rank=32, boundaries=("dispatch",), recon_weight=0.05))
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)}
    if cfg.encoder_decoder:
        batch["frame_embeds"] = rng.standard_normal(
            (2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    counters = (flash_attention_fwd, flash_attention_bwd, group_gate, grouped_mlp,
                lowrank_roundtrip_loss)
    want_launches = {"mamba2-130m": (0, 0, 0, 0, 0), "switch-base codec": (8, 4, 4, 4, 8),
                     "whisper-base": (6, 4, 0, 0, 0)}[name]
    ocfg = opt_mod.OptimizerConfig(lr=1e-3, warmup_steps=1)
    got = {}
    for dev in ("cpu", "cuda"):
        model = Model(cfg, device=dev)
        p = opt_mod.tree_map(lambda t: t.to(dev, copy=True), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = [c.launches for c in counters]
        _, metrics, grads = steps.loss_and_grads(steps.make_loss_fn(model), p, b)
        if dev == "cuda":
            assert tuple(c.launches - n for c, n in zip(counters, before)) == want_launches
        opt = opt_mod.init_optimizer(cfg.optimizer, p)
        p, opt, m2 = steps.make_train_step(model, ocfg)(p, opt, b)
        got[dev] = (metrics, to_device(grads, "cpu"), to_device(p, "cpu"), m2)
    (mc, gc, pc, sc), (mg, gg, pg, sg) = got["cpu"], got["cuda"]
    for key in ("loss", "ce_loss", "recon_loss"):
        if key in mc:
            torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=1e-5, atol=0)
    assert ("recon_loss" in mc) == name.endswith("codec")
    torch.testing.assert_close(sg["grad_norm"].cpu(), sc["grad_norm"], rtol=1e-5, atol=0)
    for a, b in zip(opt_mod.tree_leaves(gg), opt_mod.tree_leaves(gc)):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * scale
        assert a.abs().max().item() > 0 or scale == 0
    for a, b in zip(opt_mod.tree_leaves(pg), opt_mod.tree_leaves(pc)):
        diff = (a.float() - b.float()).abs()
        assert diff.max().item() <= ocfg.lr
        assert (diff > 1e-5 + 1e-5 * b.abs()).float().mean().item() <= 0.01


def test_resident_ffn_refuses_a_gradient(gen):
    """The resident expert FFN (the end tier's serving kernel) has no
    backward: asked for a gradient on the card it raises instead of
    returning an output without one."""
    xs = torch.randn(4, 32, generator=gen, device="cuda", requires_grad=True)
    store_wi = torch.randn(3, 32, 64, generator=gen, device="cuda")
    store_wo = torch.randn(3, 64, 32, generator=gen, device="cuda")
    sizes = torch.tensor([2, 2], dtype=torch.int32, device="cuda")
    ids = torch.tensor([0, 2], dtype=torch.int32, device="cuda")
    with pytest.raises(NotImplementedError, match="no backward"):
        grouped_mlp_resident(xs, sizes, store_wi, None, store_wo, ids, "gelu")
    with torch.no_grad():
        assert grouped_mlp_resident(xs, sizes, store_wi, None, store_wo, ids, "gelu").shape == (4, 32)


# ------------------------------------------------- the GELU tail (queue C1)


def test_gelu_tail_on_card(gen):
    """The expert FFN kernel's GELU and the backward's derivative on the
    card at the saturated tail: exactly 0 (relu(x)) where the plain
    version's are, past XLA's f32 tanh saturation (|u| >= 7.9988117),
    where CUDA's tanhf is not yet +-1."""
    from repro_torch.models.layers import ACTIVATION_GRADS, ACTIVATIONS

    x = torch.cat([torch.linspace(-9.0, -4.0, 4001), torch.linspace(4.0, 9.0, 4001),
                   torch.linspace(-100.0, 100.0, 2001)])
    for how in ("grad", "act"):
        fn = (ACTIVATION_GRADS if how == "grad" else ACTIVATIONS)["gelu"]
        cpu, card = fn(x), fn(x.cuda()).cpu()
        torch.testing.assert_close(card, cpu, rtol=1e-5, atol=4e-6)
        zero = cpu == 0
        assert zero.sum() > 1000 and bool((card[zero] == 0).all()), how
    # the kernel: one row per x value through an identity-like FFN (d = f =
    # 8: wi picks x into hidden unit 0, wo reads it back), f32 and bf16
    n, d = x.numel(), 8
    wi = torch.zeros(1, d, d, device="cuda")
    wi[0, 0, 0] = 1.0
    wo = wi.clone()
    xs = torch.zeros(n, d, device="cuda")
    xs[:, 0] = x.cuda()
    gs = torch.tensor([n], dtype=torch.int32, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        got = grouped_mlp(xs.to(dt), gs, wi.to(dt), None, wo.to(dt), "gelu")[:, 0].float().cpu()
        want = grouped_mlp_plain(xs.to(dt).cpu(), gs.cpu(), wi.to(dt).cpu(), None,
                                 wo.to(dt).cpu(), "gelu")[:, 0].float()
        far = (x < -4.9) | (x > 4.9)  # away from the edge's last ulps
        assert bool((got[far & (want == 0)] == 0).all()), dt
        pos = x > 4.9  # the kernel's relu(x), F.gelu's within an ulp of x
        torch.testing.assert_close(got[pos], want[pos], rtol=2 ** -23, atol=0)
        torch.testing.assert_close(got, want, rtol=1e-2 if dt == torch.bfloat16 else 1e-5,
                                   atol=1e-5)


# --------------------------------------------------- expert parallelism


def test_spawn_ranks_backend_rule(gen):
    """gloo on the CPU; nccl when each rank has a card; gloo over CUDA
    tensors when ranks share a card (nccl refuses two ranks on one)."""
    from repro_torch.launch.mesh import backend_for

    cards = torch.cuda.device_count()
    backend, devices = backend_for(cards, "cuda")
    assert backend == "nccl" and devices == [torch.device("cuda", r) for r in range(cards)]
    backend, devices = backend_for(cards + 1, "cuda")
    assert backend == "gloo" and devices[cards] == torch.device("cuda", 0)
    assert backend_for(2, "cpu")[0] == "gloo"


def test_ep_bodies_on_card_match_cpu(gen, tmp_path):
    """The a2a and tp bodies (codec off and on, with drops, the a2a -> tp
    fallback) at smoke size over two gloo ranks sharing the card against
    the same bodies over two gloo ranks on the CPU: outputs within 1e-4
    (the kernels against their plain versions), aux within 1e-5, the same
    bodies run, every rank's output equal."""
    import _torch_ep_ranks as ranks
    from repro_torch.core import moe as tmoe
    from repro_torch.launch.mesh import spawn_ranks

    cfg = smoke_config(get_config(ranks.NAME))
    data = {}
    for c in (0, 1):
        ccfg = cfg.replace(compression=CompressionConfig(rank=ranks.CODEC_RANK,
                                                         boundaries=("dispatch",)) if c else None)
        p = tmoe.init_moe(torch.Generator().manual_seed(3), ccfg)
        data.update(ranks.flatten(_np_tree(p), f"params_{c}/"))
    rng = np.random.default_rng(0)
    cases = []
    for name, impl, cf, codec, B in [("a2a", "a2a", 8.0, False, 4), ("tp", "tp", 8.0, False, 4),
                                     ("a2a codec drops", "a2a", 1.0, True, 4),
                                     ("tp codec drops", "tp", 1.0, True, 4),
                                     ("a2a->tp T=3", "a2a", 8.0, False, 3)]:
        cases.append(dict(name=name, impl=impl, mesh=[1, 2], cf=cf, codec=codec, train=True))
        data[f"x_{name}"] = rng.standard_normal((B, 1 if B == 3 else 16, cfg.d_model)).astype(
            np.float32)
    path = str(tmp_path / "data.npz")
    np.savez(path, **data)
    card = spawn_ranks((1, 2), ranks.moe_cases, path, cases, device="cuda", timeout_s=300)
    cpu = spawn_ranks((1, 2), ranks.moe_cases, path, cases, device="cpu", timeout_s=300)
    for case in cases:
        name = case["name"]
        (y, aux, bodies), (yc, auxc, bodiesc) = card[0][name], cpu[0][name]
        np.testing.assert_array_equal(card[1][name][0], y)
        assert bodies == bodiesc == ((0, 1) if "tp" in name else (1, 0)), name
        np.testing.assert_allclose(y, yc, rtol=1e-4, atol=1e-4, err_msg=name)
        assert set(aux) == set(auxc)
        for k in aux:
            np.testing.assert_allclose(aux[k], auxc[k], rtol=1e-5, atol=1e-5, err_msg=f"{name} {k}")


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.detach().cpu().numpy()
            for k, v in tree.items()}


# ------------------------------------- training on a mesh (ROADMAP item 8b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_codec_encode_decode_function_on_card(gen, dtype):
    """``encode_1d`` / ``decode_1d`` asked for a gradient on the card go
    through ``ProjectFn`` (the kernels forward, ``torch.matmul`` backward):
    Z, X̂, dX, dE, dD against autograd of the plain products on the same
    inputs, within 1e-5 (f32) or 2^-6 (bf16) of each one's largest |value|;
    one encode and one decode launch."""
    T, d, r = 96, 768, 384
    x = torch.randn(T, d, generator=gen, device="cuda")
    e = torch.linalg.qr(torch.randn(d, r, generator=gen, device="cuda"))[0].contiguous()
    dec = e.T.contiguous()
    cz = torch.randn(T, r, generator=gen, device="cuda")
    cx = torch.randn(T, d, generator=gen, device="cuda")

    def run(plain):
        xs = x.to(dtype).requires_grad_(True)
        p = {"enc": e.clone().requires_grad_(True), "dec": dec.clone().requires_grad_(True)}
        if plain:
            z = lowrank_project_plain(xs, p["enc"].to(dtype))
            xh = lowrank_project_plain(z, p["dec"].to(dtype))
        else:
            z = comp.encode_1d(p, xs)
            xh = comp.decode_1d(p, z)
        ((z.float() * cz).sum() + (xh.float() * cx).sum()).backward()
        return z, xh, xs.grad, p["enc"].grad, p["dec"].grad

    before = (lowrank_encode.launches, lowrank_decode.launches)
    got = run(False)
    assert (lowrank_encode.launches - before[0], lowrank_decode.launches - before[1]) == (1, 1)
    want = run(True)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -6
    for what, a, b in zip(("z", "x_hat", "dx", "denc", "ddec"), got, want):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= rel * scale, what


def test_kernels_without_a_backward_refuse_a_gradient(gen):
    """A CUDA tensor that wants a gradient never leaves a kernel wrapper
    without one: the wrappers that have no backward raise (and run under
    ``no_grad``)."""
    x = torch.randn(8, 64, generator=gen, device="cuda", requires_grad=True)
    e = torch.randn(64, 32, generator=gen, device="cuda")
    dec = torch.randn(32, 64, generator=gen, device="cuda")
    calls = [
        lambda: quantize_rows(x),
        lambda: lowrank_encode_quant(x, e),
        lambda: lowrank_roundtrip(x, e, dec),
        lambda: lowrank_roundtrip_loss(x, e, dec),
        lambda: flash_attention_fwd(x.view(1, 8, 2, 32), x.detach().view(1, 8, 2, 32),
                                    x.detach().view(1, 8, 2, 32)),
    ]
    q, pk, pv, table, q_pos, lengths = _attention_case(gen, torch.float32)
    calls.append(lambda: paged_attention(q.requires_grad_(True), pk, pv, table, q_pos, lengths))
    for call in calls:
        with pytest.raises(NotImplementedError, match="no backward"):
            call()
        with torch.no_grad():
            call()


def test_train_mesh_on_card_matches_one_process(gen):
    """Two f32 steps of smoke switch-base (2 blocks, a2a) on a (2, 2) mesh
    of 4 gloo ranks sharing the card (the collectives' forwards and
    backwards over CUDA tensors) against the one-process card run from the
    same params and batch: every step's loss within 1e-5 relative, its
    grad norm within 1e-4, nothing dropped (capacity factor 8), the params
    after (every element within lr a step, all but 1% of a leaf's within
    1e-5 + 1e-5 |p|).  The load-balance weight is 0 here: on a mesh that
    term is the mean of each shard's product of means (the reference's),
    which no one-process run computes; the reference parity of the whole
    loss is held on the CPU (``test_torch_train_mesh.py``)."""
    import dataclasses

    import _torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn_ranks

    cfg = smoke_config(get_config("switch-base")).replace(num_layers=4, dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0,
                                              router_aux_weight=0.0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (8, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    one, p_one = ranks.one_process_steps(cfg, "cuda", batch, 2)
    mesh = spawn_ranks((2, 2), ranks.mesh_steps, cfg.replace(moe_impl="a2a"), batch, 2,
                       device="cuda", policy="tp", timeout_s=300)
    for steps_r, p_r in mesh:
        for (loss, gnorm, dropped), (loss1, gnorm1, _) in zip(steps_r, one):
            assert abs(loss - loss1) <= 1e-5 * abs(loss1)
            assert abs(gnorm - gnorm1) <= 1e-4 * abs(gnorm1)
            assert dropped == 0.0
        for k, w in p_one.items():
            diff = np.abs(p_r[k] - w)
            assert diff.max() <= 2 * ranks.OPT["lr"], k
            assert (diff > 1e-5 + 1e-5 * np.abs(w)).mean() <= 0.01, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,ep,H,KV,hd", [
    (2, 256, 2, 12, 12, 64),  # switch-base under seqp on (2, 2): a rank's rows
    (2, 128, 4, 64, 4, 128),  # qwen3-moe under serve_seqp on (1, 4): G = 16
])
def test_flash_attention_at_sequence_parallel_offsets(gen, dtype, B, S, ep, H, KV, hd):
    """Sequence-parallel attention's shapes: each rank r's ``S/ep`` queries
    at ``q_offset = r·S/ep`` over all ``S`` keys, causal; the forward
    kernel against its plain version (tolerances of
    ``test_flash_attention_kernel``'s: f32 2^-16 of each element and 2^-14
    of the median |output|, bf16 2^-7 and 2^-6) and the backward kernel's
    dQ, dK, dV against the plain backward's (f32 1e-4, bf16 2e-2 of each
    gradient's largest |value|), at every rank's offset."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_bwd_plain

    Sq = S // ep
    f32 = dtype == torch.float32
    for r in range(ep):
        kw = dict(causal=True, window=None, q_offset=r * Sq)
        q, k, v, dout, out, lse = _bwd_case(gen, dtype, B, Sq, S, H, KV, hd, **kw)
        ref = flash_attention_plain(q, k, v, **kw)
        rtol, arel = (2 ** -16, 2 ** -14) if f32 else (2 ** -7, 2 ** -6)
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=arel * ref.float().abs().median().item())
        got = flash_attention_bwd(dout, q, k, v, out, lse, **kw)
        want = flash_attention_bwd_plain(dout, q, k, v, out, lse, **kw)
        rel = 1e-4 if f32 else 2e-2
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g.float() - w.float()).abs().max().item()
            assert err <= rel * w.float().abs().max().item(), (r, name, err)


def test_gather_rs_backward_on_gloo_over_cuda_tensors(gen):
    """The sequence-parallel K/V gather (``collectives.all_gather_rs``) on 4
    gloo ranks sharing the card: its backward sums every rank's share of
    the gradient and hands each its chunk; ``all_gather``'s keeps its own."""
    import _torch_seqp_ranks as ranks
    from repro_torch.launch.mesh import spawn_ranks

    n = 4
    total = sum(q + 1 for q in range(n)) * np.arange(1, 2 * n + 1, dtype=np.float32)
    out = spawn_ranks((2, 2), ranks.gather_rs_module, device="cuda", policy="seqp",
                      timeout_s=120)
    for r, (rs, plain) in enumerate(out):
        np.testing.assert_array_equal(rs, total[2 * r : 2 * r + 2])
        np.testing.assert_array_equal(
            plain, (r + 1) * np.arange(1, 2 * n + 1, dtype=np.float32)[2 * r : 2 * r + 2])


def test_seqp_train_mesh_on_card_matches_one_process(gen):
    """``test_train_mesh_on_card_matches_one_process`` under ``seqp``: two
    f32 steps of smoke switch-base on (2, 2), sequence-parallel attention
    (the flash kernels at each rank's offset, the K/V gathers) and the a2a
    body on pre-sharded tokens, against the one-process card run: losses
    within 1e-5 relative, grad norms within 1e-4, nothing dropped, the
    params after within lr a step (all but 1% within 1e-5 + 1e-5 |p|)."""
    import dataclasses

    import _torch_mesh_ranks as ranks
    from repro_torch.launch.mesh import spawn_ranks

    cfg = smoke_config(get_config("switch-base")).replace(num_layers=4, dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0,
                                              router_aux_weight=0.0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (8, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    one, p_one = ranks.one_process_steps(cfg, "cuda", batch, 2)
    mesh = spawn_ranks((2, 2), ranks.mesh_steps, cfg.replace(moe_impl="a2a"), batch, 2,
                       device="cuda", policy="seqp", timeout_s=300)
    for steps_r, p_r in mesh:
        for (loss, gnorm, dropped), (loss1, gnorm1, _) in zip(steps_r, one):
            assert abs(loss - loss1) <= 1e-5 * abs(loss1)
            assert abs(gnorm - gnorm1) <= 1e-4 * abs(gnorm1)
            assert dropped == 0.0
        for k, w in p_one.items():
            diff = np.abs(p_r[k] - w)
            assert diff.max() <= 2 * ranks.OPT["lr"], k
            assert (diff > 1e-5 + 1e-5 * np.abs(w)).mean() <= 0.01, k
