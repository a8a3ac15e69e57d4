"""whisper-base's encoder-decoder through the port's ``Model`` against the
reference's, on the reference's weights carried across by the bridge and
numpy-seeded inputs, at smoke size with 2 decoder blocks (2 encoder layers,
64 frames, d_model 128, 4 heads on 2 kv heads of 32):

- ``apply_encoder`` (f32 at 1e-5; bf16 at 2^-5 of max|ref|: the two
  frameworks round to bf16 at other places, a few ulps at |x| ~ 4);
- ``_cross_attention_full`` (decoder queries against 64 encoder frames);
- ``Model.prefill``'s logits and every cache leaf (``k``, ``v``, ``xk``,
  ``xv``), then 8 greedy ``decode_step`` s: tokens equal, logits within
  1e-5 of max (f32 summed in other orders);
- the reference's own smoke check (``tests/test_models_smoke.py``): the
  port's prefill against the reference's ``train_logits(train=False)``
  last row at rtol = atol = 3e-3, in f32 (in bf16 the frameworks' other
  rounding points alone move the logits by ~2.5e-2);
- ``kvcache.init_cache``'s leaves (shapes and types) against the
  reference's; ``install_slot``, ``split_cache`` and ``merge_cache`` carry
  the cross cache;
- the engines refuse cross-attention patterns, as the reference's cannot
  serve them (its ``ServingEngine`` passes no ``frame_embeds``, its
  ``EndCloudPipeline`` no encoder output).

The reference's calls are jitted (eager JAX compiles op by op).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models import kvcache as jkv
from repro.models import transformer as jtr
from repro.models.model import build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import hardware as thw
from repro_torch.models import kvcache as tkv
from repro_torch.models import transformer as ttr
from repro_torch.models.model import Model
from repro_torch.serving import EndCloudPipeline, ServingEngine

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

NAME = "whisper-base"
B, T, MAX_LEN, STEPS = 2, 16, 32, 8


def _np(a):
    return np.asarray(a, np.float32)


def _pair(dtype: str):
    """(reference model, its params, batch), (port model, the same params
    bridged, batch) at ``dtype``."""
    jcfg = jsmoke(jget(NAME)).replace(num_layers=2, dtype=dtype)
    cfg = smoke_config(get_config(NAME)).replace(num_layers=2, dtype=dtype)
    jm = build_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "frame_embeds": jnp.asarray(frames).astype(dtype)}
    tb = {"tokens": torch.from_numpy(tokens),
          "frame_embeds": torch.from_numpy(frames).to(getattr(torch, dtype))}
    return (jm, jp, jb), (Model(cfg, device="cpu"), tp, tb)


@pytest.fixture(scope="module")
def f32():
    return _pair("float32")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference(dtype, f32):
    (jm, jp, jb), (tm, tp, tb) = f32 if dtype == "float32" else _pair(dtype)
    want = _np(jax.jit(lambda p, f: jtr.apply_encoder(p, f, jm.cfg, jm.topo))(
        jp, jb["frame_embeds"]))
    got = ttr.apply_encoder(tp, tb["frame_embeds"], tm.cfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == tb["frame_embeds"].shape
    atol = 1e-5 if dtype == "float32" else 2 ** -5 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_cross_attention_matches_reference(f32):
    """Decoder rows [B, T, d] against the encoder's 64 frames through block
    0's cross params: the output and the (k, v) the cache keeps."""
    (jm, jp, _), (tm, tp, _) = f32
    rng = np.random.default_rng(1)
    h = rng.standard_normal((B, T, tm.cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, tm.cfg.encoder_seq_len, tm.cfg.d_model)).astype(np.float32)
    jcross = jax.tree.map(lambda a: a[0], jp["blocks"]["pos0"]["cross"])
    want, (wk, wv) = jax.jit(lambda p, h, e: jtr._cross_attention_full(p, h, e, jm.cfg))(
        jcross, jnp.asarray(h), jnp.asarray(enc))
    tcross = ttr.block_params(tp["blocks"], 0)["pos0"]["cross"]
    got, (k, v) = ttr._cross_attention_full(tcross, torch.from_numpy(h), torch.from_numpy(enc),
                                            tm.cfg)
    for g, w in ((got, want), (k, wk), (v, wv)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=1e-5)


def test_prefill_then_greedy_decode_match_reference(f32):
    """The cache's leaves and the logits after the prefill, then 8 greedy
    steps: tokens equal, logits within 1e-5 of max|ref| (f32 summed in
    other orders)."""
    (jm, jp, jb), (tm, tp, tb) = f32
    lj, cj = jax.jit(lambda p, b: jm.prefill(p, b, max_len=MAX_LEN))(jp, jb)
    with torch.no_grad():
        lt, ct = tm.prefill(tp, tb, max_len=MAX_LEN)
    want = dict(_leaves(cj["blocks"]))
    got = dict(_leaves(ct["blocks"]))
    assert sorted(got) == sorted(want) == ["pos0/k", "pos0/v", "pos0/xk", "pos0/xv"]
    for name, leaf in got.items():
        assert tuple(leaf.shape) == want[name].shape
        np.testing.assert_allclose(leaf.numpy(), _np(want[name]), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert ct["lengths"].tolist() == np.asarray(cj["lengths"]).tolist() == [T] * B
    step = jax.jit(jm.decode_step)
    for i in range(STEPS + 1):
        ref = _np(lj)
        np.testing.assert_allclose(lt.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f"step {i}")
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        assert lt.argmax(-1).tolist() == tok.tolist(), f"step {i}"
        if i < STEPS:
            lj, cj = step(jp, jnp.asarray(tok)[:, None], cj)
            with torch.no_grad():
                lt, ct = tm.decode_step(tp, torch.from_numpy(tok)[:, None], ct)
    assert ct["lengths"].tolist() == [T + STEPS] * B
    # the cross cache is read, never written, by the decode steps
    np.testing.assert_allclose(ct["blocks"]["pos0"]["xk"].numpy(),
                               _np(cj["blocks"]["pos0"]["xk"]), rtol=0, atol=1e-5)


def test_prefill_matches_reference_full_forward(f32):
    """The reference's own smoke check, across packages: the port's prefill
    logits against the reference's ``train_logits(train=False)`` last row."""
    (jm, jp, jb), (tm, tp, tb) = f32
    full, _ = jax.jit(lambda p, b: jm.train_logits(p, b, train=False))(jp, jb)
    with torch.no_grad():
        lt, _ = tm.prefill(tp, tb, max_len=MAX_LEN)
    np.testing.assert_allclose(lt.numpy(), _np(full[:, -1]), rtol=3e-3, atol=3e-3)


def test_init_cache_leaves_match_reference(f32):
    (jm, _, _), (tm, _, _) = f32
    want = jax.eval_shape(lambda: jkv.init_cache(jm.cfg, 3, 40, jnp.bfloat16))
    got = tkv.init_cache(tm.cfg, 3, 40, torch.bfloat16, "cpu")
    w, g = dict(_leaves(want["blocks"])), dict(_leaves(got["blocks"]))
    assert sorted(g) == sorted(w)
    for name, leaf in g.items():
        assert tuple(leaf.shape) == w[name].shape and leaf.dtype == torch.bfloat16, name
        assert not bool(leaf.any())
    assert tuple(got["lengths"].shape) == want["lengths"].shape
    assert got["lengths"].dtype == torch.int32


def test_cache_moves_carry_the_cross_leaves(f32):
    """``install_slot`` copies a request's prefill cache (its cross cache
    too) into a slot of a batched cache, and ``split_cache`` /
    ``merge_cache`` carry ``xk``/``xv`` with the rings, as the reference's
    do."""
    (jm, jp, jb), (tm, tp, tb) = f32
    one = {k: v[:1] for k, v in tb.items()}
    with torch.no_grad():
        _, c1 = tm.prefill(tp, one, max_len=MAX_LEN)
    jc1 = jax.jit(lambda p, b: jm.prefill(p, b, max_len=MAX_LEN))(
        jp, {k: v[:1] for k, v in jb.items()})[1]
    batch = tkv.init_cache(tm.cfg, 3, MAX_LEN, torch.float32, "cpu")
    tkv.install_slot(batch, 1, c1)
    want = jkv.install_slot(jkv.init_cache(jm.cfg, 3, MAX_LEN, jnp.float32), 1, jc1)
    w = dict(_leaves(want["blocks"]))
    for name, leaf in _leaves(batch["blocks"]):
        np.testing.assert_allclose(leaf.numpy(), _np(w[name]), rtol=0, atol=1e-5, err_msg=name)
    assert batch["lengths"].tolist() == np.asarray(want["lengths"]).tolist() == [0, T, 0]
    end, cloud = tkv.split_cache(batch, 1)
    assert end["blocks"]["pos0"]["xk"].shape[0] == 1 and cloud["blocks"]["pos0"]["xv"].shape[0] == 1
    merged = tkv.merge_cache(end, cloud)
    for (name, a), (_, b) in zip(_leaves(merged["blocks"]), _leaves(batch["blocks"])):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("engine", ["ServingEngine", "EndCloudPipeline"])
def test_engines_refuse_cross_attention(engine, f32):
    _, (tm, tp, _) = f32
    with pytest.raises(NotImplementedError, match="frame_embeds|encoder output"):
        if engine == "ServingEngine":
            ServingEngine(tm, tp, max_batch=2, max_len=MAX_LEN)
        else:
            EndCloudPipeline(tm, tp, end_profile=thw.PROFILES["jetson-orin"],
                             cloud_profile=thw.PROFILES["a100"])
