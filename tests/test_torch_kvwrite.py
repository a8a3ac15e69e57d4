"""The int8 KV pools' layer write (``models/kvcache.py``'s writers, on the
card one launch of ``kernels.quant.paged_write_quant``) and the group
gate's wrapper on the CPU, where each runs its plain version.

- the writers against the reference's ``paged_ring_write_quant``
  and ``paged_write_tokens_quant`` (``models/kvcache.py``) on numpy inputs
  from a seed: ring writes past a wrap, chunks with padding rows, tokens
  that are all zero or so small that their f16 scale underflows to 0, bf16
  and f32 k/v, pools that are views of a block-stacked leaf; codes and
  scales bit-equal outside the garbage row (which takes one of several
  padding writes, in an order neither side fixes);
- the port's two writers are ``paged_write_quant_plain`` on the CPU;
- a CPU tensor runs the plain version and counts no launch (the gate and
  the write alike), and another device that is not CUDA raises (the
  write's launch raises on a CPU tensor too);
- the gate's launch plan (kernel form, tokens and threads a block, loop
  depth) as the wrapper computes it for the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as jkv
from repro_torch.kernels.group_gate import group_gate, group_gate_plain
from repro_torch.kernels.group_gate.ops import launch_plan
from repro_torch.kernels.quant import paged_write_quant
from repro_torch.models import kvcache as tkv
from repro_torch.models.kvcache import paged_write_quant_plain

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _case(seed: int, kind: str, R: int = 3, P: int = 10, ps: int = 4, KV: int = 2,
          hd: int = 8, pps: int = 4):
    """Block-stacked int8 leaves of random codes and f16 scales, a page table
    (one slot's entries partly garbage), k/v [B, C, KV, hd] with an all-zero
    token and an f16-underflow token, and the positions (and valid rows) of a
    ring write past a wrap (``kind == "ring"``) or of a padded chunk."""
    rng = np.random.default_rng(seed)
    leaves = rng.integers(-127, 128, (2, R, P + 1, ps, KV, hd)).astype(np.int8)
    scales = rng.random((2, R, P + 1, ps)).astype(np.float16)
    table = np.asarray([[3, 0, 7, 5], [9, 2, P, P], [1, 4, 6, 8]], np.int32)
    B = table.shape[0]
    if kind == "ring":
        C, valid = 1, None
        positions = np.asarray([37, 5, 14], np.int32)  # slot 0 past a 16-token ring
    else:
        C = 5
        start = np.asarray([0, 2, 11], np.int32)
        positions = start[:, None] + np.arange(C, dtype=np.int32)[None]
        valid = np.arange(C)[None] < np.asarray([5, 3, 4])[:, None]
    k, v = (rng.standard_normal((B, C, KV, hd)).astype(np.float32) * 3 for _ in range(2))
    k[1, 0] = 0.0  # an all-zero token: scale 1e-8 -> f16 0, codes 0
    v[2, 0] = v[2, 0] * np.float32(1e-7)  # amax / 127 under f16's smallest value
    return leaves, scales, table, positions, valid, k, v


def _outside_garbage(leaves, scales, P):
    """Every row of every block but the written block's garbage row."""
    keep = np.ones(leaves.shape[1:3], bool)
    keep[1, P] = False
    return leaves[:, keep], scales[:, keep]


@pytest.mark.parametrize("kind", ["ring", "chunk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_write_quant_equals_reference(kind, dtype, seed):
    leaves, scales, table, positions, valid, k, v = _case(seed, kind)
    P = leaves.shape[2] - 1
    jk, jv = (jnp.asarray(a).astype(dtype) for a in (k, v))
    args = [jnp.asarray(a) for a in (leaves[0, 1], leaves[1, 1], scales[0, 1], scales[1, 1])]
    if kind == "ring":
        want = jkv.paged_ring_write_quant(*args, jk, jv, jnp.asarray(table),
                                          jnp.asarray(positions), 4)
    else:
        want = jkv.paged_write_tokens_quant(*args, jk, jv, jnp.asarray(table),
                                            jnp.asarray(positions), jnp.asarray(valid), 4)
    # the port writes in place into views of its block-stacked leaves
    tl, ts = torch.from_numpy(leaves.copy()), torch.from_numpy(scales.copy())
    pools = (tl[0, 1], tl[1, 1], ts[0, 1], ts[1, 1])
    tk, tv = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (k, v))
    t = torch.from_numpy
    before = paged_write_quant.launches
    if kind == "ring":
        got = tkv.paged_ring_write_quant(*pools, tk, tv, t(table), t(positions), 4)
    else:
        got = tkv.paged_write_tokens_quant(*pools, tk, tv, t(table), t(positions), t(valid), 4)
    assert paged_write_quant.launches == before  # the plain version: no launch
    assert all(g is p for g, p in zip(got, pools))
    wl, ws = leaves.copy(), scales.copy()
    for i, w in enumerate(want):
        (wl if i < 2 else ws)[i % 2, 1] = np.asarray(w)
    gl, gs = _outside_garbage(tl.numpy(), ts.numpy(), P)
    el, es = _outside_garbage(wl, ws, P)
    np.testing.assert_array_equal(gl, el)
    np.testing.assert_array_equal(gs, es)
    # the edge tokens stored f16 scale 0 on both sides
    phys = lambda b, c: (table[b, (positions.reshape(3, -1)[b, c] // 4) % 4],  # noqa: E731
                         positions.reshape(3, -1)[b, c] % 4)
    assert ts[0, 1][phys(1, 0)].item() == 0.0 and ts[1, 1][phys(2, 0)].item() == 0.0
    assert bool((tl[0, 1][phys(1, 0)] == 0).all())


@pytest.mark.parametrize("kind", ["ring", "chunk"])
def test_kvcache_writers_are_the_write_entry(kind):
    """``paged_ring_write_quant`` / ``paged_write_tokens_quant`` of the port
    give what ``paged_write_quant_plain`` gives, bit for bit, everywhere."""
    leaves, scales, table, positions, valid, k, v = _case(2, kind)
    t = torch.from_numpy
    outs = []
    for write in ("kvcache", "plain"):
        tl, ts = t(leaves.copy()), t(scales.copy())
        pools = (tl[0, 0], tl[1, 0], ts[0, 0], ts[1, 0])
        tk, tv = t(k).bfloat16(), t(v).bfloat16()
        if write == "plain":
            paged_write_quant_plain(*pools, tk, tv, t(table), t(positions), 4,
                                    None if valid is None else t(valid))
        elif kind == "ring":
            tkv.paged_ring_write_quant(*pools, tk, tv, t(table), t(positions), 4)
        else:
            tkv.paged_write_tokens_quant(*pools, tk, tv, t(table), t(positions), t(valid), 4)
        outs.append((tl, ts))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_cpu_routes_to_plain_and_other_devices_raise():
    rng = np.random.default_rng(3)
    K, d, Mk, T = 4, 32, 2, 6
    p = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((K, d, Mk), (K, Mk), (d, K), (K,))]
    x = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    mask = torch.tensor([1, 0, 0, 0, 1, 1, 0, 1], dtype=torch.bool)
    for m in (None, mask, mask[None].expand(T, -1)):  # a per-token mask too
        before = group_gate.launches
        got = group_gate(x, *p, m)
        want = group_gate_plain(x, *p, m)
        assert group_gate.launches == before
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="unsupported device"):
        group_gate(x.to("meta"), *(t.to("meta") for t in p))
    leaves, scales, table, positions, _, k, _ = _case(4, "ring")
    meta = [torch.from_numpy(a).to("meta") for a in
            (leaves[0, 0], leaves[1, 0], scales[0, 0], scales[1, 0], k, k, table, positions)]
    with pytest.raises(ValueError, match="unsupported device"):
        tkv.paged_ring_write_quant(*meta, 4)
    cpu = [torch.from_numpy(a) for a in
           (leaves[0, 0], leaves[1, 0], scales[0, 0], scales[1, 0], k, k, table, positions)]
    with pytest.raises(ValueError, match="unsupported device"):
        paged_write_quant(*cpu, 4)  # the launch alone takes CUDA tensors only


@pytest.mark.parametrize("T,d,K,Mk,ptrs,want", [
    (4, 768, 4, 2, (0, 256), (1, 1, 512, 0)),  # switch-base decode: vector weight loads
    (8, 5120, 4, 4, (0, 0), (2, 1, 512, 1)),  # llama4-scout: 10 elements a thread
    (256, 768, 4, 2, (0, 0), (1, 1, 512, 0)),  # a token a block up to 256 tokens
    (1024, 768, 4, 2, (0, 0), (1, 4, 256, 1)),  # then tiles of 4 (256 blocks)
    (4096, 5120, 4, 4, (0, 0), (2, 16, 256, 1)),  # tiles take at most 256 threads
    (8, 768, 4, 2, (8, 0), (0, 1, 512, 0)),  # w_local not 16-byte aligned: generic form
    (8, 768, 4, 4, (0, 4), (0, 1, 512, 0)),  # w_global not 16-byte aligned
    (8, 96, 2, 4, (0, 0), (0, 1, 96, 0)),  # another (K, Mk): generic form
    (3, 16, 8, 2, (0, 0), (0, 1, 32, 0)),
    (8, 4096, 16, 8, (0, 0), (3, 1, 512, 0)),  # qwen3-moe, 128 experts: the wide form
    (1024, 4096, 16, 8, (0, 0), (3, 1, 512, 0)),  # a token a block at any T
    (8, 96, 4, 8, (0, 0), (3, 1, 512, 0)),  # 32 experts
    (8, 96, 16, 1, (0, 0), (3, 1, 512, 0)),  # 16 groups of 1
])
def test_gate_launch_plan(T, d, K, Mk, ptrs, want):
    assert launch_plan(T, d, K, Mk, ptrs) == want
