"""The port's paged KV cache against the reference's ``models/kvcache.py``:
the same ``PagePool`` op sequences give the same tables and counters, and
the paged writes give the same pools."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models import kvcache as jkv
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import kvcache as tkv

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)


def _ops(seed):
    """A random admit / map / append / free sequence over 3 slots."""
    rng = np.random.default_rng(seed)
    ops, live = [], {}
    for _ in range(60):
        slot = int(rng.integers(0, 3))
        if slot not in live:
            ops.append(("reserve", slot, int(rng.integers(1, 5))))
            live[slot] = 0
        elif rng.random() < 0.15:
            ops.append(("free", slot))
            del live[slot]
        elif rng.random() < 0.5:
            n = int(rng.integers(1, 9))
            ops.append(("map_range", slot, live[slot], live[slot] + n))
            live[slot] += n
        else:
            ops.append(("append", slot, live[slot]))
            live[slot] += 1
    return ops


def _apply(pool, op):
    try:
        getattr(pool, op[0])(*op[1:])
        return None
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_page_pool_op_sequences_give_the_same_tables(seed):
    jp = jkv.PagePool(10, 4, 4, n_slots=3)
    tp = tkv.PagePool(10, 4, 4, n_slots=3)
    for op in _ops(seed):
        assert _apply(tp, op) == _apply(jp, op), op
        np.testing.assert_array_equal(tp.table, jp.table)
        assert (tp.pages_in_use, tp.pages_reserved, tp.pages_available, tp.peak_in_use) == (
            jp.pages_in_use, jp.pages_reserved, jp.pages_available, jp.peak_in_use)
        assert tp.utilization == jp.utilization
        for n in (1, 3):
            assert tp.can_reserve(n) == jp.can_reserve(n)
    active = np.asarray([True, False, True])
    np.testing.assert_array_equal(
        tp.device_rows(range(3), active=active, device="cpu").numpy(),
        np.asarray(jp.device_rows(range(3), active=active)),
    )
    assert tp.device_rows([1], device="cpu").dtype == torch.int32


def test_page_pool_invariants():
    pool = tkv.PagePool(num_pages=8, page_size=4, pages_per_slot=4, n_slots=3)
    pool.reserve(0, tkv.pages_needed(10, 4, 4))
    pool.map_range(0, 0, 7)
    assert pool.pages_in_use == 2 and pool.pages_reserved == 1
    with pytest.raises(ValueError, match="reservation"):
        pool.append(0, 8), pool.append(0, 12)
    pool.free(0)
    pool.reserve(0, 4)
    for pos in range(40):  # ring reuse: wrapping revisits mapped entries
        pool.append(0, pos)
    assert pool.pages_in_use == 4
    with pytest.raises(ValueError, match="already holds"):
        pool.reserve(0, 1)
    pool.reserve(1, 4)
    with pytest.raises(ValueError, match="exhausted"):
        pool.reserve(2, 1)
    pool.free(0)
    with pytest.raises(ValueError, match="double free"):
        pool.free(0)


@pytest.mark.parametrize("name,max_len,ps,chunk", [
    ("switch-base", 64, 16, 32), ("tinyllama-1.1b", 100, 8, 16), ("switch-base", 20, 4, 8),
])
def test_geometry_matches_reference(name, max_len, ps, chunk):
    jcfg, cfg = jsmoke(jget(name)), smoke_config(get_config(name))
    assert tkv.page_geometry(cfg, max_len, ps, chunk) == jkv.page_geometry(jcfg, max_len, ps, chunk)
    assert tkv.pattern_is_pageable(cfg) == jkv.pattern_is_pageable(jcfg)
    for n in (1, 15, 16, 17, 300):
        assert tkv.pages_needed(n, ps, 4) == jkv.pages_needed(n, ps, 4)


def test_paged_writes_match_reference():
    cfg = smoke_config(get_config("switch-base")).replace(dtype="float32")
    jcfg = jsmoke(jget("switch-base")).replace(dtype="float32")
    rng = np.random.default_rng(0)
    P, ps, KV, hd = 6, 4, cfg.num_kv_heads, cfg.head_dim
    tb = tkv.init_paged_blocks(cfg, 1, P, ps, torch.float32, "cpu")
    jb = jkv.init_paged_blocks(jcfg, 1, P, ps, jnp.float32)
    assert {k: {n: tuple(v.shape) for n, v in e.items()} for k, e in tb.items()} == {
        k: {n: tuple(v.shape) for n, v in e.items()} for k, e in jb.items()}
    assert tkv.paged_block_bytes(tb) == jkv.paged_block_bytes(jb)
    table = np.asarray([[2, 0, 6], [4, 6, 6]], np.int32)  # 6 = garbage
    pk = rng.standard_normal((P + 1, ps, KV, hd)).astype(np.float32)
    pv = rng.standard_normal((P + 1, ps, KV, hd)).astype(np.float32)
    # chunk write with padding rows, then a decode write
    k = rng.standard_normal((2, 5, KV, hd)).astype(np.float32)
    v = rng.standard_normal((2, 5, KV, hd)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [1, 2, 3, 4, 5]], np.int32)
    valid = np.asarray([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], bool)
    jk, jv = jkv.paged_write_tokens(jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(table), jnp.asarray(pos),
                                    jnp.asarray(valid), ps)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tkv.paged_write_tokens(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(table), torch.from_numpy(pos),
                           torch.from_numpy(valid), ps)
    # the garbage row takes whichever padding write lands last: compare the rest
    np.testing.assert_array_equal(tk.numpy()[:P], np.asarray(jk)[:P])
    np.testing.assert_array_equal(tv.numpy()[:P], np.asarray(jv)[:P])
    ln = np.asarray([5, 3], np.int32)
    k1 = rng.standard_normal((2, 1, KV, hd)).astype(np.float32)
    jk, jv = jkv.paged_ring_write(jk, jv, jnp.asarray(k1), jnp.asarray(k1),
                                  jnp.asarray(table), jnp.asarray(ln), ps)
    tkv.paged_ring_write(tk, tv, torch.from_numpy(k1), torch.from_numpy(k1),
                         torch.from_numpy(table), torch.from_numpy(ln), ps)
    np.testing.assert_array_equal(tk.numpy()[:P], np.asarray(jk)[:P])
    np.testing.assert_array_equal(tv.numpy()[:P], np.asarray(jv)[:P])
