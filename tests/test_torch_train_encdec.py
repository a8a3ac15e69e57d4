"""Training whisper-base's encoder-decoder in the port, against the
reference in f32 on the CPU (smoke size: 2 encoder layers on 64 frames, d
128, 4 heads on 2 kv heads of 32): the bidirectional encoder's gradients
(frames and every encoder weight), cross-attention's (decoder queries
against the encoder's output, Sq != Skv, not causal: both through
``FlashAttentionFn``), and ``make_train_step`` with ``frame_embeds`` in the
batch and ``grad_accum=2`` (the frames split along the batch with the
tokens).  Also ``attention.chunk_attention``, the dense-ring chunk oracle
the reference's paged tests compare against.  Reference weights reach the
port through the numpy bridge; reference calls are jitted.

Tolerances: gradients within 1e-4 of each leaf's largest |value| (f32
summed in other orders; the train step's as
``tests/test_torch_train_step.py`` states them); ``chunk_attention`` f32
within 1e-5, bf16 within 2^-7 of its largest |value| (p rounded to bf16
before the value product on both sides, summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import _leaf_close, _ref_params, steps_equal_the_reference

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.distributed.topology import single_device_topology
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.training import optimizer as opt_mod

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

NAME = "whisper-base"


def _cfgs(**kw):
    return (jsmoke(jget(NAME)).replace(dtype="float32", **kw),
            smoke_config(get_config(NAME)).replace(dtype="float32", **kw))


def _requires_grad(tree):
    for leaf in opt_mod.tree_leaves(tree):
        leaf.requires_grad_(True)
    return tree


def test_encoder_gradients_equal_the_reference():
    """``apply_encoder`` under grad (non-causal flash attention through its
    autograd Function, RoPE at frame positions, the dense FFN, the
    encoder's norm): the gradients of a functional of its output with
    respect to the frames and every encoder weight against ``jax.grad``
    of the reference's; the CPU launches no kernel."""
    jcfg, cfg = _cfgs()
    jp = _ref_params(jcfg)
    topo = single_device_topology()
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal(frames.shape).astype(np.float32)
    enc = {"encoder": jp["encoder"]}
    jg = jax.jit(jax.grad(lambda p, f: (jtr.apply_encoder(p, f, jcfg, topo) * r).sum(),
                          argnums=(0, 1)))(enc, frames)
    tp = _requires_grad(params_from_numpy(enc, "cpu"))
    tf = torch.from_numpy(frames).requires_grad_(True)
    before = flash_attention_fwd.launches, flash_attention_bwd.launches
    (ttr.apply_encoder(tp, tf, cfg) * torch.from_numpy(r)).sum().backward()
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == before
    _leaf_close(tf.grad, jg[1], "frames")
    for path, want in jax.tree_util.tree_flatten_with_path(jg[0])[0]:
        g = tp
        for key in path:
            g = g[key.key]
        _leaf_close(g.grad, want, jax.tree_util.keystr(path))


def test_cross_attention_gradients_equal_the_reference():
    """``_cross_attention_full``: 16 decoder queries on 64 encoder frames;
    the gradients of a functional of its output and of the projected
    frames (the cross cache's k, v) with respect to the queries' input,
    the encoder's output and the four projections."""
    jcfg, cfg = _cfgs()
    pos = next(f"pos{i}" for i, s in enumerate(jcfg.layer_pattern) if s.cross_attn)
    jp = jax.tree.map(lambda v: v[0], _ref_params(jcfg)["blocks"][pos]["cross"])
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    ro = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)

    def jloss(p, hh, ee):
        o, (k, v) = jtr._cross_attention_full(p, hh, ee, jcfg)
        return (o * ro).sum() + (k * v).sum()

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jp, h, enc)
    tp = _requires_grad(params_from_numpy(jp, "cpu"))
    th, te = (torch.from_numpy(a).requires_grad_(True) for a in (h, enc))
    o, (k, v) = ttr._cross_attention_full(tp, th, te, cfg)
    ((o * torch.from_numpy(ro)).sum() + (k * v).sum()).backward()
    _leaf_close(th.grad, jg[1], "h")
    _leaf_close(te.grad, jg[2], "enc_out")
    for key, want in jg[0].items():
        _leaf_close(tp[key].grad, want, key)


def test_encdec_train_step_equals_the_reference():
    """Two steps of ``make_train_step`` on whisper-base smoke with two
    microbatches: the reference's dummy batch carries ``frame_embeds``
    [4, 64, 128], split along dim 0 with the tokens; every gradient leaf
    (decoder, cross-attention, encoder), every metric and the params
    after each step."""
    jcfg, cfg = _cfgs(grad_accum=2)
    steps_equal_the_reference("whisper-base grad_accum=2", jcfg, cfg, n_steps=2)


@pytest.mark.parametrize("window,dtype", [(None, "float32"), (9, "float32"),
                                          (None, "bfloat16")])
def test_chunk_attention_equals_the_reference(window, dtype):
    """C = 4 queries a slot at ragged absolute positions against a dense
    ring of 24 slots holding positions past a wrap and unwritten slots
    (position -1), GQA 4 heads on 2: the reference's ``chunk_attention``;
    and its C = 1 case is ``decode_attention``."""
    rng = np.random.default_rng(2)
    B, C, H, KV, hd, S = 3, 4, 4, 2, 32, 24
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    start = np.array([0, 5, 27])
    qpos = (start[:, None] + np.arange(C)[None]).astype(np.int32)
    last = qpos[:, -1]
    # the ring position each slot holds: the latest p <= last with p % S == slot
    slots = np.arange(S)[None]
    kpos = (last[:, None] - (last[:, None] - slots) % S).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn.chunk_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                                 jnp.asarray(qpos), jnp.asarray(kpos), window=window)
    got = tattn.chunk_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                torch.from_numpy(qpos), torch.from_numpy(kpos), window=window)
    assert got.dtype == tdt and tuple(got.shape) == (B, C, H, hd)
    _leaf_close(got.float(), np.asarray(want, np.float32), "chunk_attention",
                1e-5 if dtype == "float32" else 2 ** -7)
    one = tattn.chunk_attention(*(torch.from_numpy(a).to(tdt) for a in (q[:, :1], k, v)),
                                torch.from_numpy(qpos[:, :1]), torch.from_numpy(kpos),
                                window=window)
    dec = tattn.decode_attention(*(torch.from_numpy(a).to(tdt) for a in (q[:, :1], k, v)),
                                 torch.from_numpy(qpos[:, 0]), torch.from_numpy(kpos),
                                 window=window)
    assert torch.equal(one, dec)
