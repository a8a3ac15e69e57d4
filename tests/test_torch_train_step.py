"""The port's train step against the reference's, in f32 on the CPU: the
gate's and the expert FFN's autograd Functions (the backward the card runs
around their kernels) against autograd of their plain versions and
``jax.grad`` of the reference's ``gating.gate`` and ``moe_sorted``;
``make_train_step`` against the reference's on three smoke configs, with
AdamW, Adafactor and ``grad_accum=2`` (``steps_equal_the_reference``, which
the codec, SSM and encoder-decoder files share);
``Model.train_logits(train=False)``; the loss falling over 8 steps, on
every pattern the reference's smoke test trains (training on a mesh:
``test_torch_train_mesh.py``).
Reference weights reach the port through the numpy bridge; reference
calls are jitted.

Tolerances:
- gradients and metrics: 1e-4 of a leaf's largest |value| (1e-5 relative
  for the losses and the grad norm): the same f32 products, summed in
  another order;
- params after each step: Adam's first update is ``lr · g / (|g| + eps)``,
  which turns a gradient element near eps = 1e-8 (most of whose bits are
  then rounding) into any update up to lr, and Adafactor's update of a
  vector leaf is ``g / |g|``; so every element within ``lr`` a step taken,
  and all but 1% of a leaf's within 1e-5 + 1e-5 |p|.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import gating as jgating
from repro.core import moe as jmoe
from repro.data import pipeline as jpipeline
from repro.launch.steps import make_loss_fn as jmake_loss_fn
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.model import build_model, make_dummy_batch
from repro.training.optimizer import OptimizerConfig as JOptimizerConfig
from repro.training.optimizer import init_optimizer as jinit_optimizer
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import gating, moe
from repro_torch.data import pipeline
from repro_torch.kernels.expert_mlp import ops as ffn_ops
from repro_torch.kernels.expert_mlp import grouped_mlp, grouped_mlp_plain
from repro_torch.kernels.group_gate import group_gate, group_gate_plain
from repro_torch.launch import steps
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.trainer import Trainer, TrainerConfig

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=100)


def _cfgs(name, **kw):
    return (jsmoke(jget(name)).replace(dtype="float32", **kw),
            smoke_config(get_config(name)).replace(dtype="float32", **kw))


def _ref_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(seed)))


def _leaf_close(got, want, what, rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-30), f"{what}: max |diff| {err}"


def _tree_close(got, want, what, rel=1e-4):
    """Every leaf of the reference's tree ``want`` (numpy) against the
    port's nested dict ``got``."""
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for key in path:
            g = g[key.key]
        _leaf_close(g, leaf, f"{what} {jax.tree_util.keystr(path)}", rel)
        n += 1
    assert n == len(opt_mod.tree_leaves(got))


def _params_close(got, want, lr_steps):
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for key in path:
            g = g[key.key]
        diff = np.abs(g.numpy() - np.asarray(leaf))
        what = jax.tree_util.keystr(path)
        assert diff.max() <= lr_steps, f"params {what}: max |diff| {diff.max()}"
        assert (diff > 1e-5 + 1e-5 * np.abs(leaf)).mean() <= 0.01, f"params {what}"


# ---------------------------------------------------------------- the gate


GATE_MASKS = {"no mask": None, "a masked expert": [1, 1, 0, 1, 1, 1, 1, 1],
              "a dead group": [1, 1, 0, 0, 1, 1, 1, 1]}


@pytest.mark.parametrize("mask", sorted(GATE_MASKS))
def test_gate_function_backward(mask):
    """The gate's gradients (x and its four parameters) through
    ``GroupGateFn`` on the CPU: against autograd of ``group_gate_plain`` for
    a functional of probs and p_group, and against ``jax.grad`` of the
    reference's ``gating.gate`` for one of probs, p_group, the top-k
    combine weights and ``aux_loss`` (switch-base smoke: 8 experts in 4
    groups; a masked expert gets zero gradient, a dead group's none)."""
    jcfg, cfg = _cfgs("switch-base")
    jp = _ref_params(jcfg)["blocks"]["pos1"]["moe"]["gate"]
    jp = {k: v[0] for k, v in jp.items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, cfg.d_model)).astype(np.float32)
    r1 = rng.standard_normal((24, 8)).astype(np.float32)
    r2 = rng.standard_normal((24, 4)).astype(np.float32)
    r3 = rng.standard_normal((24, cfg.moe.top_k)).astype(np.float32)
    m = None if GATE_MASKS[mask] is None else np.array(GATE_MASKS[mask], bool)
    names = ("w_local", "b_local", "w_global", "b_global")

    grads = {}
    for how in ("function", "plain"):
        tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in jp.items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        fn = group_gate if how == "function" else group_gate_plain
        probs, pg = fn(tx, *(tp[k] for k in names), None if m is None else torch.from_numpy(m))
        ((probs * torch.from_numpy(r1)).sum() + (pg * torch.from_numpy(r2)).sum()).backward()
        grads[how] = [tx.grad] + [tp[k].grad for k in names]
    for name, a, b in zip(("x",) + names, grads["function"], grads["plain"]):
        _leaf_close(a, b.numpy(), f"{mask} {name}")
    if m is not None:
        dead = ~m
        w_local = grads["function"][1].permute(1, 0, 2).reshape(cfg.d_model, -1)  # [d, E]
        assert bool((w_local[:, dead] == 0).all())

    def jloss(p, xx):
        out = jgating.gate(p, xx, jcfg.moe, None if m is None else jnp.asarray(m))
        return ((out.probs * r1).sum() + (out.p_group * r2).sum()
                + (out.topk_weight * r3).sum() + out.aux["aux_loss"])

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = gating.gate(tp, tx, cfg.moe, None if m is None else torch.from_numpy(m))
    ((out.probs * torch.from_numpy(r1)).sum() + (out.p_group * torch.from_numpy(r2)).sum()
     + (out.topk_weight * torch.from_numpy(r3)).sum() + out.aux["aux_loss"]).backward()
    _leaf_close(tx.grad, jg[1], f"{mask} x vs reference")
    for k in names:
        _leaf_close(tp[k].grad, jg[0][k], f"{mask} {k} vs reference")


# ------------------------------------------------------------ the expert FFN


FFN_CASES = {"plain gelu": ("switch-base", None), "gated silu": ("llama4-scout-17b-16e", None),
             "an empty expert group": ("switch-base", [1, 1, 1, 0, 1, 1, 1, 1])}


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_expert_ffn_function_backward(case):
    """``moe_sorted``'s gradients (x, wi/wg/wo) through the FFN's
    ``GroupedMLPFn`` and the gate's Function against ``jax.grad`` of the
    reference's ``moe_sorted`` (a functional of y plus ``aux_loss``); and
    the Function alone against autograd of ``grouped_mlp_plain`` on the
    same sorted rows.  switch-base: non-gated tanh GELU; llama4-scout:
    gated SiLU; a masked expert leaves its group empty (zero weight
    gradients)."""
    name, mask = FFN_CASES[case]
    layer = "pos1" if name == "switch-base" else "pos0"
    jcfg, cfg = _cfgs(name)
    jp = jax.tree.map(lambda v: v[0], _ref_params(jcfg)["blocks"][layer]["moe"])
    jp.pop("shared", None)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((20, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((20, cfg.d_model)).astype(np.float32)
    m = None if mask is None else np.array(mask, bool)

    def jloss(p, xx):
        y, aux = jmoe.moe_sorted(p, xx, jcfg, None if m is None else jnp.asarray(m))
        return (y * r).sum() + aux["aux_loss"]

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    tp = params_from_numpy(jp, "cpu")
    for leaf in opt_mod.tree_leaves(tp):
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    before = ffn_ops.grouped_mlp.launches
    y, aux = moe.moe_sorted(tp, tx, cfg, None if m is None else torch.from_numpy(m))
    ((y * torch.from_numpy(r)).sum() + aux["aux_loss"]).backward()
    assert ffn_ops.grouped_mlp.launches == before  # the CPU runs the plain version
    _leaf_close(tx.grad, jg[1], f"{case} x")
    # the expert weights; the gate's leaves are held in
    # test_gate_function_backward: here their gradient from y runs through
    # top-1's renormalized weight p / p = 1, whose derivative is 0 in exact
    # arithmetic and the rounding of 1/p - p/p^2 times dL/dw (~|y . r|)
    # otherwise, noise that differs between the two packages
    for k in ("wi", "wg", "wo"):
        if k in jp:
            _leaf_close(tp[k].grad, jg[0][k], f"{case} {k}")
    if m is not None:
        assert bool((tp["wi"].grad[3] == 0).all()) and bool((tp["wo"].grad[3] == 0).all())

    # the Function alone on sorted rows against autograd of the plain version
    sizes = torch.tensor([3, 0, 5, 4, 0, 6, 1, 1], dtype=torch.int32)
    xs = torch.from_numpy(rng.standard_normal((20, cfg.d_model)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((20, cfg.d_model)).astype(np.float32))
    ws = {k: torch.from_numpy(np.asarray(jp[k])) for k in ("wi", "wg", "wo") if k in jp}
    grads = {}
    for how, fn in (("function", grouped_mlp), ("plain", grouped_mlp_plain)):
        xg = xs.clone().requires_grad_(True)
        wg = {k: w.clone().requires_grad_(True) for k, w in ws.items()}
        (fn(xg, sizes, wg["wi"], wg.get("wg"), wg["wo"], cfg.act) * dy).sum().backward()
        grads[how] = [xg.grad] + [wg[k].grad for k in sorted(wg)]
    for a, b in zip(grads["function"], grads["plain"]):
        _leaf_close(a, b.numpy(), f"{case} GroupedMLPFn")


# -------------------------------------------------------------- train steps


STEP_CASES = {
    "switch-base adamw": ("switch-base", dict(num_layers=4)),
    "tinyllama adamw grad_accum=2": ("tinyllama-1.1b", dict(grad_accum=2)),
    "llama4-scout adafactor": ("llama4-scout-17b-16e", dict(num_layers=2, optimizer="adafactor")),
    # GELU with Adafactor: the factored second moment turns a gradient
    # column the reference has at exactly 0 (its tanh saturated) and the
    # port at ~1e-9 into a step of ~lr, so the tail must be exact
    "switch-base adafactor": ("switch-base", dict(num_layers=2, optimizer="adafactor")),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_equals_the_reference(case):
    """Three steps of ``make_train_step`` from the reference's params on the
    reference's batch: before each step the gradients of the loss (every
    leaf) against ``jax.grad`` of the reference's loss, both at the
    reference's params; after it every
    metric key of the reference's step (the losses, the router's aux and
    routing statistics, ``grad_norm``, ``lr``) and the params.  switch-base
    at 2 blocks (aux summed over blocks, remat), tinyllama with two
    microbatches, llama4-scout (shared expert, gated FFN) and switch-base
    (GELU's saturated tail) with Adafactor."""
    name, kw = STEP_CASES[case]
    steps_equal_the_reference(case, *_cfgs(name, **kw))


def steps_equal_the_reference(case, jcfg, cfg, n_steps=3, seq=32):
    """``n_steps`` of the port's ``make_train_step`` against the
    reference's from the reference's seed-0 params on its dummy batch [4,
    ``seq``] (``frame_embeds`` and patches too where the config has
    them): before each step every gradient leaf at the reference's
    params, after it every metric and the params (the module's
    tolerances)."""
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = jax.tree.map(np.asarray, make_dummy_batch(jcfg, jax.random.PRNGKey(1), 4, seq))
    tb = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jo = jinit_optimizer(cfg.optimizer, jp)
    to = opt_mod.init_optimizer(cfg.optimizer, tp)
    jgrad = jax.jit(jax.value_and_grad(jmake_loss_fn(jm), has_aux=True))
    jstep = jax.jit(jmake_train_step(jm, JOptimizerConfig(name=cfg.optimizer, **OPT)))
    model = Model(cfg, device="cpu")
    tloss = steps.make_loss_fn(model)
    tstep = steps.make_train_step(model, opt_mod.OptimizerConfig(name=cfg.optimizer, **OPT))
    for i in range(n_steps):
        # the gradients at the reference's params (the two runs' params part
        # by Adam's amplified roundings, held below)
        (_, _), jg = jgrad(jp, batch)
        here = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _, _, tg = steps.loss_and_grads(tloss, here, tb)
        _tree_close(tg, jax.tree.map(np.asarray, jg), f"{case} step {i} grads")
        jp, jo, jmetrics = jstep(jp, jo, batch)
        tp, to, tmetrics = tstep(tp, to, tb)
        assert set(jmetrics) == set(tmetrics), case
        for key, want in jmetrics.items():
            rel = 1e-5 if key in ("loss", "ce_loss", "grad_norm", "lr") else 1e-4
            _leaf_close(np.asarray(tmetrics[key], np.float32), want, f"{case} {key}", rel)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        _params_close(tp, jax.tree.map(np.asarray, jp), OPT["lr"] * (i + 1))


def trainer_equals_the_reference(tmp_path, jcfg, cfg, total=4):
    """``Trainer`` for ``total`` steps of the ``lm`` task ([4, 32] at vocab
    512), a checkpoint every 2 steps, against the reference trainer: the
    port's params and optimizer state bridged from the reference's after
    ``initialize()``; every logged loss within 1e-5 relative and grad norm
    within 1e-4 of the reference's."""
    kw = dict(total_steps=total, checkpoint_every=2, log_every=1, async_checkpoint=False)

    def data(mod):
        return itertools.cycle(mod.batches(mod.DataConfig(task="lm", vocab_size=512, seq_len=32),
                                           4, 8))

    jt = JTrainer(jcfg, data(jpipeline), trainer_cfg=JTrainerConfig(
        checkpoint_dir=str(tmp_path / "ref"), **kw)).initialize()
    tt = Trainer(cfg, data(pipeline), device="cpu", trainer_cfg=TrainerConfig(
        checkpoint_dir=str(tmp_path / "port"), **kw)).initialize()
    tt.params = params_from_numpy(jax.tree.map(np.asarray, jt.params), "cpu")
    tt.opt_state = params_from_numpy(jax.tree.map(np.asarray, jt.opt_state), "cpu")
    want, got = jt.run()["log"], tt.run()["log"]
    assert [m["step"] for m in got] == [m["step"] for m in want] == list(range(1, total + 1))
    for a, b in zip(got, want):
        assert np.isfinite(a["loss"])
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * abs(b["grad_norm"]), (a, b)


def test_train_logits_without_training_equals_the_reference():
    """``train_logits(train=False)``: the reference's logits and summed aux
    (router losses and statistics over 2 blocks) for switch-base smoke."""
    jcfg, cfg = _cfgs("switch-base", num_layers=4)
    jm = build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = make_dummy_batch(jcfg, jax.random.PRNGKey(1), 2, 48)
    want_logits, want_aux = jax.jit(lambda p, b: jm.train_logits(p, b, train=False))(jp, batch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    with torch.no_grad():
        logits, aux = Model(cfg, device="cpu").train_logits(
            tp, {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()},
            train=False)
    _leaf_close(logits, want_logits, "logits", 1e-5)
    assert set(aux) == set(want_aux)
    for key, want in want_aux.items():
        _leaf_close(aux[key], want, key)
        assert tuple(aux[key].shape) == np.shape(want)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "llama4-scout-17b-16e",
                                  "qwen3-moe-235b-a22b", "mamba2-130m", "jamba-1.5-large-398b"])
def test_train_step_decreases_loss(name):
    """The reference's ``test_smoke_train_step_decreases_loss`` setting
    (``tests/test_models_smoke.py``): smoke config as the registry gives it
    (bf16 activations), the reference's dummy batch [4, 32], lr 1e-2 after
    one warmup step, 8 steps; every loss finite and the last below the
    first.  qwen3-moe keeps its rank-64 dispatch codec at smoke size (the
    joint eq. 8 term in its loss); mamba2 and jamba hold SSM layers."""
    jcfg = jsmoke(jget(name))
    cfg = smoke_config(get_config(name))
    batch = make_dummy_batch(jcfg, jax.random.PRNGKey(1), 4, 32)
    tb = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    state = opt_mod.init_optimizer(cfg.optimizer, params)
    step = steps.make_train_step(model, opt_mod.OptimizerConfig(
        name=cfg.optimizer, lr=1e-2, warmup_steps=1, decay_steps=100))
    losses = []
    for _ in range(8):
        params, state, metrics = step(params, state, tb)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], f"{name}: loss did not decrease {losses}"
