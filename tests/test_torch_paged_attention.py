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
