"""The port's paged attention against the reference's
``kernels/paged_attention/ref.py::paged_attention_ref``.

On the CPU the port's wrapper runs its plain version, so these cases check
the algorithm the CUDA kernel implements (page-table walk, ring masking,
page skip, zero-l guard) on the reference's own inputs: ragged lengths, a
1-token slot, ring wrap, a window smaller than the ring, C > 1 with
padding, a poisoned garbage page, and all-garbage rows.  Inputs are made
with numpy from a seed and handed to both packages.  The CUDA kernel
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.models import kvcache as jkv
from repro_torch.models import attention as tattn
from repro_torch.models import kvcache as tkv

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

# f32 on both sides; the two online softmaxes differ only in the order of
# their sums
TOL = dict(rtol=2e-5, atol=2e-5)


def _case(lengths, *, ps=4, pps=4, num_pages=14, KV=2, hd=32, seed=0):
    """Pools and tables built through the reference allocator: slot b holds
    positions [0, lengths[b]], untouched entries are garbage."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    pool = jkv.PagePool(num_pages, ps, pps, n_slots=B)
    for b, ln in enumerate(lengths):
        pool.reserve(b, jkv.pages_needed(int(ln) + 1, ps, pps))
        pool.map_range(b, 0, int(ln) + 1)
    table = np.array(pool.device_rows(range(B)))
    pool_k = rng.standard_normal((num_pages + 1, ps, KV, hd)).astype(np.float32)
    pool_v = rng.standard_normal((num_pages + 1, ps, KV, hd)).astype(np.float32)
    return pool_k, pool_v, table


def _both(q, pool_k, pool_v, table, q_positions, lengths, window):
    want = paged_attention_ref(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(table), jnp.asarray(q_positions, jnp.int32),
        jnp.asarray(lengths, jnp.int32), window=window,
    )
    t = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt)  # noqa: E731
    got = tattn.paged_chunk_attention(
        t(q), t(pool_k), t(pool_v), t(table, torch.int32),
        t(q_positions, torch.int32), t(lengths, torch.int32), window=window,
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("window", [None, 7])
def test_decode_ragged_lengths(window):
    """Slot 0 holds exactly one token past its prefill (position 1)."""
    lengths = np.asarray([1, 5, 9, 15])
    pool_k, pool_v, table = _case(lengths)
    q = np.random.default_rng(1).standard_normal((4, 1, 4, 32)).astype(np.float32)
    got, want = _both(q, pool_k, pool_v, table, lengths[:, None], lengths, window)
    np.testing.assert_allclose(got, want, **TOL)


def test_single_token_slot():
    """A slot whose only key is position 0 attends to exactly that key."""
    lengths = np.asarray([0, 6])
    pool_k, pool_v, table = _case(lengths, seed=9)
    q = np.random.default_rng(10).standard_normal((2, 1, 4, 32)).astype(np.float32)
    got, want = _both(q, pool_k, pool_v, table, lengths[:, None], lengths, None)
    np.testing.assert_allclose(got, want, **TOL)
    # G = 2 query heads share kv head h // 2: slot 0's output is its one V row
    v0 = pool_v[table[0, 0], 0]  # [KV, hd]
    np.testing.assert_allclose(got[0, 0], np.repeat(v0, 2, axis=0), **TOL)


@pytest.mark.parametrize("window", [None, 9])
def test_chunk_with_padding_rows(window):
    """C > 1 chunks at ragged offsets; slot 3 holds 2 valid rows and 2
    padding rows, which are computed too and must agree as well."""
    C = 4
    start = np.asarray([0, 2, 6, 12])
    n_valid = np.asarray([4, 4, 4, 2])
    last = start + n_valid - 1
    pool_k, pool_v, table = _case(last, seed=2)
    q = np.random.default_rng(3).standard_normal((4, C, 4, 32)).astype(np.float32)
    positions = start[:, None] + np.arange(C)[None, :]
    got, want = _both(q, pool_k, pool_v, table, positions, last, window)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("window", [None, 10])
def test_ring_wrap(window):
    """Positions past the ring capacity reuse the slot's pages in place."""
    ps, pps = 4, 4
    lengths = np.asarray([21, 37, 16])
    B = len(lengths)
    pool = jkv.PagePool(12, ps, pps, n_slots=B)
    for b in range(B):
        pool.reserve(b, pps)
        pool.map_range(b, 0, int(lengths[b]) + 1)
    table = np.array(pool.device_rows(range(B)))
    rng = np.random.default_rng(4)
    pool_k = rng.standard_normal((13, ps, 2, 32)).astype(np.float32)
    pool_v = rng.standard_normal((13, ps, 2, 32)).astype(np.float32)
    q = rng.standard_normal((B, 1, 4, 32)).astype(np.float32)
    got, want = _both(q, pool_k, pool_v, table, lengths[:, None], lengths, window)
    np.testing.assert_allclose(got, want, **TOL)


def test_poisoned_garbage_page_and_all_garbage_rows():
    """A poisoned garbage page changes no output, and a slot whose table is
    all garbage comes back exactly 0."""
    lengths = np.asarray([3, 9])
    pool_k, pool_v, table = _case(lengths, seed=5)
    q = np.random.default_rng(6).standard_normal((2, 1, 4, 32)).astype(np.float32)
    base, _ = _both(q, pool_k, pool_v, table, lengths[:, None], lengths, None)
    pk, pv = pool_k.copy(), pool_v.copy()
    pk[-1] = 1e4
    pv[-1] = 1e4
    got, want = _both(q, pk, pv, table, lengths[:, None], lengths, None)
    np.testing.assert_array_equal(got, base)
    np.testing.assert_allclose(got, want, **TOL)
    all_garbage = np.full_like(table, pool_k.shape[0] - 1)
    zero, want0 = _both(q, pk, pv, all_garbage, lengths[:, None], lengths, None)
    np.testing.assert_array_equal(zero, 0.0)
    np.testing.assert_array_equal(want0, 0.0)


def test_paged_gather_and_ring_positions_match_reference():
    """The test-only dense ring view and the ring position math."""
    lengths = np.asarray([3, 17, 30])
    pool_k, _, table = _case(lengths, seed=11, num_pages=14)
    got = tkv.paged_gather(torch.as_tensor(pool_k), torch.as_tensor(table)).numpy()
    want = np.asarray(jkv.paged_gather(jnp.asarray(pool_k), jnp.asarray(table)))
    np.testing.assert_array_equal(got, want)
    W = table.shape[1] * pool_k.shape[1]
    np.testing.assert_array_equal(
        tkv.ring_key_positions(torch.as_tensor(lengths), W).numpy(),
        np.asarray(jkv.ring_key_positions(jnp.asarray(lengths), W)),
    )


def test_decode_attention_is_the_c1_chunk():
    lengths = np.asarray([2, 11])
    pool_k, pool_v, table = _case(lengths, seed=12)
    q = np.random.default_rng(13).standard_normal((2, 1, 4, 32)).astype(np.float32)
    t = torch.as_tensor
    ln = t(lengths, dtype=torch.int32)
    args = (t(q), t(pool_k), t(pool_v), t(table, dtype=torch.int32))
    np.testing.assert_array_equal(
        tattn.paged_decode_attention(*args, ln).numpy(),
        tattn.paged_chunk_attention(*args, ln[:, None], ln).numpy(),
    )


# ---------------------------------------------------------------------------
# The CUDA kernel's layout, emulated on the CPU: the split plan, and each
# slot's page sweep split over blocks (and each block's over its 4 warps),
# every part an online softmax over its own pages, merged in a fixed order.

from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402


@pytest.mark.parametrize("B,KV,pps,want", [
    (8, 12, 16, 3),   # the serving engine's decode: 96 sweeps
    (4, 12, 32, 6),   # the streaming engine's 4-slot group, 512-token rings
    (4, 12, 16, 6),   # the same group on 256-token rings
    (1, 12, 16, 16),  # a prefill chunk: one split a table entry
    (3, 2, 4, 4),
    (64, 12, 16, 1),  # enough sweeps to fill the card alone
])
def test_split_plan(B, KV, pps, want):
    S = pa_ops.split_plan(B, KV, pps)
    assert S == want and 1 <= S <= pps
    assert S == pps or B * KV * S >= pa_ops.SPLIT_TARGET_BLOCKS
    assert S == 1 or B * KV * (S - 1) < pa_ops.SPLIT_TARGET_BLOCKS


@pytest.mark.parametrize("dtype,quantized,rows,ps,want", [
    (torch.bfloat16, False, 16, 16, True),   # a 16-token prefill chunk
    (torch.bfloat16, False, 32, 16, True),
    (torch.bfloat16, False, 8, 16, False),   # decode: the CUDA cores
    (torch.bfloat16, True, 32, 16, False),   # int8 pools stay exact
    (torch.float32, False, 32, 16, False),
    (torch.bfloat16, False, 32, 4, False),   # pages of fewer than 16 tokens
])
def test_tensor_core_rule(dtype, quantized, rows, ps, want):
    assert pa_ops.uses_tensor_cores(dtype, quantized, rows, ps) is want


def _merge(states):
    """Partial (m, l, acc) states merged in list order."""
    M = torch.stack([m for m, _, _ in states]).amax(dim=0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        f = torch.exp(m - M)
        L = L + l * f
        A = A + acc * f[:, None]
    return M, L, A


def _split_merge(q, pool_k, pool_v, table, q_positions, lengths, window, splits, warps=4):
    """The kernel's algorithm in f32: split s of S takes the table entries
    s, s + S, ...; warp w of a split the split's entries w, w + 4, ...; each
    warp an online softmax over its entries with the reference's skip rule
    (garbage entries and pages with no visible pair of the slot's C rows)
    and -1e30 masks; the warps' states merged, then the splits' in order,
    and the l == 0 guard."""
    q, pool_k, pool_v = (torch.as_tensor(a, dtype=torch.float32) for a in (q, pool_k, pool_v))
    table, q_positions, lengths = (torch.as_tensor(np.asarray(a), dtype=torch.long)
                                   for a in (table, q_positions, lengths))
    B, C, H, hd = q.shape
    P1, ps, KV, _ = pool_k.shape
    pps = table.shape[1]
    G, W = H // KV, pps * ps
    out = torch.zeros(B, C, H, hd)
    for b in range(B):
        ln = int(lengths[b])
        qp = q_positions[b]
        for h in range(KV):
            qs = q[b, :, h * G:(h + 1) * G].reshape(C * G, hd)  # rows r = c*G + g
            parts = []
            for s in range(splits):
                entries = list(range(s, pps, splits))
                states = []
                for w in range(warps):
                    m = torch.full((C * G,), pa_ops.NEG_INF)
                    l = torch.zeros(C * G)
                    acc = torch.zeros(C * G, hd)
                    for j in entries[w::warps]:
                        phys = int(table[b, j])
                        kp = ln - torch.remainder(ln - (j * ps + torch.arange(ps)), W)
                        vis = (kp[None, :] <= qp[:, None]) & (kp[None, :] >= 0)
                        if window is not None:
                            vis &= kp[None, :] > qp[:, None] - window
                        if phys == P1 - 1 or not bool(vis.any()):
                            continue
                        sc = qs @ pool_k[phys, :, h].T / hd ** 0.5
                        sc = torch.where(vis.repeat_interleave(G, dim=0), sc, pa_ops.NEG_INF)
                        m_new = torch.maximum(m, sc.amax(dim=1))
                        corr = torch.exp(m - m_new)
                        p = torch.exp(sc - m_new[:, None])
                        l = l * corr + p.sum(dim=1)
                        acc = acc * corr[:, None] + p @ pool_v[phys, :, h]
                        m = m_new
                    states.append((m, l, acc))
                parts.append(_merge(states))
            _, L, A = _merge(parts)
            o = A / torch.where(L == 0, torch.ones_like(L), L)[:, None]
            out[b, :, h * G:(h + 1) * G] = o.reshape(C, G, hd)
    return out.numpy()


def _plain(q, pool_k, pool_v, table, q_positions, lengths, window):
    t = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt)  # noqa: E731
    return pa_ops.paged_attention_plain(
        t(q), t(pool_k), t(pool_v), t(table, torch.int32), t(q_positions, torch.int32),
        t(lengths, torch.int32), window=window).numpy()


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("splits", [1, 2, 3, 4])
def test_split_and_merge_decode(window, splits):
    """Ragged lengths and a ring wrap (G = 2): at every split count the
    split sweep gives the plain version's output."""
    lengths = np.asarray([1, 5, 9, 15])
    pool_k, pool_v, table = _case(lengths)
    q = np.random.default_rng(21).standard_normal((4, 1, 4, 32)).astype(np.float32)
    args = (q, pool_k, pool_v, table, lengths[:, None], lengths, window)
    np.testing.assert_allclose(_split_merge(*args, splits), _plain(*args), **TOL)


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("splits", [1, 3])
def test_split_and_merge_chunk_with_rows_that_see_no_key(window, splits):
    """A 4-row chunk with G = 2 over ragged slots, a row at position -1
    (no visible key, on pages that are live for the other rows: it takes
    the reference's p = 1 over their masked keys in both versions), and a
    slot whose table is all garbage (exact 0)."""
    C = 4
    start = np.asarray([0, 2, 6, 12])
    n_valid = np.asarray([4, 4, 4, 2])
    last = start + n_valid - 1
    pool_k, pool_v, table = _case(last, seed=22)
    table[3] = pool_k.shape[0] - 1
    q = np.random.default_rng(23).standard_normal((4, C, 4, 32)).astype(np.float32)
    positions = start[:, None] + np.arange(C)[None, :]
    positions[1, 0] = -1
    args = (q, pool_k, pool_v, table, positions, last, window)
    got = _split_merge(*args, splits)
    np.testing.assert_allclose(got, _plain(*args), **TOL)
    np.testing.assert_array_equal(got[3], 0.0)


@pytest.mark.parametrize("window", [None, 5])
def test_split_with_only_dead_pages(window):
    """One split a table entry: the splits past a short slot's pages see
    only garbage entries, and with a 5-token window the mapped pages
    behind it hold no visible key; both contribute m = -1e30, l = 0."""
    ps, pps = 4, 8
    lengths = np.asarray([2, 30, 9])
    B = len(lengths)
    pool = jkv.PagePool(20, ps, pps, n_slots=B)
    for b in range(B):
        pool.reserve(b, jkv.pages_needed(int(lengths[b]) + 1, ps, pps))
        pool.map_range(b, 0, int(lengths[b]) + 1)
    table = np.array(pool.device_rows(range(B)))
    rng = np.random.default_rng(24)
    pool_k = rng.standard_normal((21, ps, 2, 32)).astype(np.float32)
    pool_v = rng.standard_normal((21, ps, 2, 32)).astype(np.float32)
    q = rng.standard_normal((B, 1, 4, 32)).astype(np.float32)
    args = (q, pool_k, pool_v, table, lengths[:, None], lengths, window)
    assert pa_ops.split_plan(B, 2, pps) == pps
    np.testing.assert_allclose(_split_merge(*args, pps), _plain(*args), **TOL)


@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("quant", [False, True])
def test_head_dim_120(quant, window):
    """h2o-danube-3-4b's head dim (d_model 3840 over 32 heads), which the
    CUDA kernel computes at a width of 128 over rows of stride 120: the
    plain version against the reference at C = 1 and a 4-row chunk with
    padding rows, over dense f32 pools and over int8 pools with f16
    per-token scales (G = 4, as h2o's 32 heads on 8)."""
    assert 120 in pa_ops.HEAD_DIMS
    hd, KV, H = 120, 2, 8
    for C, start, seed in ((1, np.asarray([1, 5, 9, 15]), 7),
                           (4, np.asarray([0, 2, 6, 12]), 8)):
        last = start + C - 1
        pool_k, pool_v, table = _case(last, KV=KV, hd=hd, seed=seed)
        rng = np.random.default_rng(seed)
        q = rng.standard_normal((4, C, H, hd)).astype(np.float32)
        positions = start[:, None] + np.arange(C)[None, :]
        scales = {}
        if quant:
            pool_k = rng.integers(-127, 128, pool_k.shape).astype(np.int8)
            pool_v = rng.integers(-127, 128, pool_v.shape).astype(np.int8)
            scales = {n: (rng.random(pool_k.shape[:2]) / 127).astype(np.float16)
                      for n in ("k_scale", "v_scale")}
        want = paged_attention_ref(
            jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(table),
            jnp.asarray(positions, jnp.int32), jnp.asarray(last, jnp.int32), window=window,
            **{n: jnp.asarray(s) for n, s in scales.items()})
        t = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt)  # noqa: E731
        got = tattn.paged_chunk_attention(
            t(q), t(pool_k), t(pool_v), t(table, torch.int32), t(positions, torch.int32),
            t(last, torch.int32), window=window, **{n: t(s) for n, s in scales.items()})
        assert got.shape == (4, C, H, hd)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
