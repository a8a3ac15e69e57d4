"""Training the Mamba-2 SSM layer in the port, against the reference in
f32 on the CPU: the SSD's gradients (``ssd_chunked`` over chunks and head
blocks, an initial state, two groups; the causal mask's -inf decays give
zero gradients, not NaN), the full layer's (every parameter and x, the
final state and conv tails in the functional), ``make_train_step`` on
mamba2-130m smoke (AdamW) and jamba-1.5-large smoke (SSM, attention and
top-2 MoE in one block; Adafactor), and ``Trainer`` on mamba2 smoke.  The
SSD is plain PyTorch in the port and ``jnp`` in the reference, so both
sides are autodiff; the reference's calls are jitted.

Tolerances: the SSD's and the layer's gradients within 1e-4 of each
one's largest |value| (f32 products summed in other orders, the chunk
recurrence's sums included); the train step's as
``tests/test_torch_train_step.py`` states them.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_ssm import _inputs
from test_torch_train_step import _leaf_close, steps_equal_the_reference, trainer_equals_the_reference

from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.models import ssm as jssm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import ssm
from repro_torch.training import optimizer as opt_mod

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)


def _cfgs(name, **kw):
    return (jsmoke(jget(name)).replace(dtype="float32", **kw),
            smoke_config(get_config(name)).replace(dtype="float32", **kw))


# (chunk, head block, groups, with an initial state)
SSD_CASES = {"chunk 8, blocks of 2": (8, 2, 1, False),
             "chunk 16, blocks of 4, 2 groups, initial state": (16, 4, 2, True),
             "one chunk": (32, 1, 1, False)}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunked_gradients_equal_the_reference(case):
    """Gradients of a functional of y and the final state with respect to
    x, dt, A, B, C (and the initial state) against ``jax.grad`` of the
    reference's ``ssd_chunked``; every one finite."""
    chunk, hb, G, init = SSD_CASES[case]
    ins = list(_inputs(2, 32, 4, 8, G, 8, seed=chunk + hb))
    rng = np.random.default_rng(7)
    if init:
        ins.append(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    ry = rng.standard_normal((2, 32, 4, 8)).astype(np.float32)
    rh = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)

    def jloss(*a):
        y, h = jssm.ssd_chunked(*a[:5], chunk_size=chunk, head_block=hb,
                                initial_state=a[5] if init else None)
        return (y * ry).sum() + (h * rh).sum()

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(ins)))))(*ins)
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in ins]
    y, h = ssm.ssd_chunked(*ts[:5], chunk_size=chunk, head_block=hb,
                           initial_state=ts[5] if init else None)
    ((y * torch.from_numpy(ry)).sum() + (h * torch.from_numpy(rh)).sum()).backward()
    for name, t, w in zip(("x", "dt", "A", "B", "C", "initial state"), ts, want):
        assert bool(torch.isfinite(t.grad).all()), f"{case}: d{name} not finite"
        _leaf_close(t.grad, w, f"{case} d{name}")


def test_ssm_layer_gradients_equal_the_reference():
    """The full layer (mamba2 smoke, the reference's params bridged):
    gradients of a functional of its output, final state and conv tails
    with respect to x and every parameter, against ``jax.grad`` of the
    reference's ``apply_ssm``."""
    jcfg, cfg = _cfgs("mamba2-130m")
    jp = jax.tree.map(np.asarray, jax.jit(jssm.init_ssm, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jcfg, np.float32))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    ro = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        o, (h, (cx, cbc)) = jssm.apply_ssm(p, xx, jcfg, return_state=True)
        return (o * ro).sum() + (h ** 2).sum() + cx.sum() + (cbc ** 2).sum()

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    tp = params_from_numpy(jp, "cpu")
    for leaf in opt_mod.tree_leaves(tp):
        leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    o, (h, (cx, cbc)) = ssm.apply_ssm(tp, tx, cfg, return_state=True)
    ((o * torch.from_numpy(ro)).sum() + (h ** 2).sum() + cx.sum() + (cbc ** 2).sum()).backward()
    _leaf_close(tx.grad, jg[1], "x")
    for k, want in jg[0].items():
        _leaf_close(tp[k].grad, want, k)


STEP_CASES = {"mamba2-130m adamw": ("mamba2-130m", {}),
              "jamba-1.5-large adafactor": ("jamba-1.5-large-398b", {})}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_ssm_train_step_equals_the_reference(case):
    """Two steps of ``make_train_step`` with each block recomputed in the
    backward: every gradient leaf (the SSM's projections, conv, A_log, D,
    dt_bias and norm; jamba's attention, gate and experts), every metric,
    the params after each step."""
    name, kw = STEP_CASES[case]
    steps_equal_the_reference(case, *_cfgs(name, **kw), n_steps=2)


def test_trainer_on_mamba2_equals_the_reference(tmp_path):
    """``Trainer`` on mamba2 smoke: every logged loss and grad norm against
    the reference trainer's."""
    trainer_equals_the_reference(tmp_path, *_cfgs("mamba2-130m"))
