"""Training with the eq. 8 codec in the port, against the reference in f32
on the CPU: the dispatch codec's autograd Function (``RoundtripLossFn``,
around the roundtrip kernel on the card) against ``jax.grad`` of the
reference's ``roundtrip_1d`` then ``recon_loss`` and against autograd of
its plain version, at the fused plan and the composed one (chosen by rank:
600 > 512); ``moe_sorted`` and ``moe_resident`` with a codec under
training (output, aux, grads); ``make_train_step`` on qwen3-moe smoke
(Adafactor, its rank-64 codec) and switch-base with the ec2moe system's
codec at 4 layers; a pipeline-only codec, which never enters the model;
``Trainer`` on qwen3-moe smoke against the reference trainer; and the rest
of ``core/compression.py`` (the 2-D faithful form, ``joint_loss``, the
int8 range codec).  Reference weights reach the port through the numpy
bridge; reference calls are jitted.

Tolerances (``tests/test_torch_train_step.py``'s): gradients and metrics
within 1e-4 of a leaf's largest |value| (1e-5 relative for the losses and
the grad norm), params after a step per element within lr; the
Function against autograd of the plain version 1e-5 of each gradient's
largest |value| in f32 (the same products) and 2^-6 in bf16 (one bf16
rounding of f32 sums taken in another order, carried through two
products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dispatch import _resident_codec_case
from test_torch_train_step import (
    _leaf_close,
    _ref_params,
    steps_equal_the_reference,
    trainer_equals_the_reference,
)

from repro.configs import CompressionConfig as JCompression
from repro.configs import get_config as jget
from repro.configs import smoke_config as jsmoke
from repro.core import compression as jcomp
from repro.core import moe as jmoe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import CompressionConfig, get_config, smoke_config
from repro_torch.core import compression as tcomp
from repro_torch.core import moe as tmoe
from repro_torch.kernels.lowrank import (
    lowrank_roundtrip_loss,
    lowrank_roundtrip_loss_plain,
    roundtrip_loss,
    roundtrip_plan,
)
from repro_torch.kernels.lowrank.ops import lowrank_decode, lowrank_encode
from repro_torch.launch import steps
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt_mod

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

RECON_WEIGHT = 0.05  # the benchmarks' ec2moe system (benchmarks/common.py)


def _codec_cfgs(name, rank, boundaries=("dispatch",), **kw):
    """(reference, port) smoke ``name`` in f32 with a codec of ``rank`` on
    ``boundaries``."""
    return tuple(
        smoke(get(name)).replace(dtype="float32", compression=Compression(
            rank=rank, boundaries=boundaries, recon_weight=RECON_WEIGHT), **kw)
        for smoke, get, Compression in ((jsmoke, jget, JCompression),
                                        (smoke_config, get_config, CompressionConfig)))


# ------------------------------------------------------- the codec Function


FUNCTION_CASES = {"fused": (128, 64, 24), "composed": (640, 600, 12)}  # (d, rank, rows)


@pytest.mark.parametrize("case", sorted(FUNCTION_CASES))
def test_roundtrip_function_backward(case):
    """dX, dE and dD of a functional of X̂, the mean error and the summed
    error through ``RoundtripLossFn``: against ``jax.grad`` of the
    reference's ``roundtrip_1d`` + ``recon_loss`` (the summed error as the
    mean times N) and against autograd of the plain version; the Function
    is entered only with a gradient wanted, and the CPU launches no
    kernel."""
    d, r, n = FUNCTION_CASES[case]
    assert roundtrip_plan(r) == case
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    e = np.linalg.qr(rng.standard_normal((d, r)))[0].astype(np.float32)
    dec = (e.T + 0.1 * rng.standard_normal((r, d))).astype(np.float32)
    up = rng.standard_normal((n, d)).astype(np.float32)
    w1, w2 = 0.7, 0.003

    def jloss(xx, ee, dd):
        sent = jcomp.roundtrip_1d({"enc": ee, "dec": dd}, xx).astype(xx.dtype)
        rec = jcomp.recon_loss(xx, sent)
        return (sent * up).sum() + w1 * rec + w2 * rec * xx.size

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(x, e, dec)
    grads = {}
    before = (lowrank_roundtrip_loss.launches, lowrank_encode.launches,
              lowrank_decode.launches)
    for how in ("function", "plain"):
        ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, e, dec)]
        fn = roundtrip_loss if how == "function" else lowrank_roundtrip_loss_plain
        x_hat, sq, mean = fn(*ts)
        if how == "function":
            assert type(x_hat.grad_fn).__name__ == "RoundtripLossFnBackward"
        ((x_hat * torch.from_numpy(up)).sum() + w1 * mean + w2 * sq).backward()
        grads[how] = [t.grad for t in ts]
    assert (lowrank_roundtrip_loss.launches, lowrank_encode.launches,
            lowrank_decode.launches) == before
    for name, a, b, j in zip("XED", grads["function"], grads["plain"], want):
        _leaf_close(a, b.numpy(), f"{case} d{name} vs plain", 1e-5)
        _leaf_close(a, j, f"{case} d{name} vs reference")
    with torch.no_grad():
        assert roundtrip_loss(*(torch.from_numpy(a) for a in (x, e, dec)))[0].grad_fn is None


def test_roundtrip_function_bf16_rounds_as_the_plain_version():
    """In bf16 (X, E, D in bf16, as the consumer casts its f32 masters) the
    Function's gradients round where autograd of the plain version rounds;
    through the f32 masters' casts the codec's gradients reach f32."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((32, 128)).astype(np.float32))
    e32 = torch.from_numpy(np.linalg.qr(rng.standard_normal((128, 64)))[0].astype(np.float32))
    up = torch.from_numpy(rng.standard_normal((32, 128)).astype(np.float32)).bfloat16()
    grads = {}
    for how, fn in (("function", roundtrip_loss), ("plain", lowrank_roundtrip_loss_plain)):
        xb = x.bfloat16().requires_grad_(True)
        enc, dec = e32.clone().requires_grad_(True), e32.T.contiguous().requires_grad_(True)
        x_hat, _, mean = fn(xb, enc.bfloat16(), dec.bfloat16())
        ((x_hat * up).float().sum() + 0.5 * mean).backward()
        grads[how] = (xb.grad, enc.grad, dec.grad)
    assert grads["function"][0].dtype == torch.bfloat16
    assert grads["function"][1].dtype == grads["function"][2].dtype == torch.float32
    for name, a, b in zip("XED", grads["function"], grads["plain"]):
        _leaf_close(a.float(), b.float().numpy(), f"bf16 d{name}", 2 ** -6)


# ------------------------------------------------------ the MoE layer's codec


def _moe_case(name, rank):
    jcfg, cfg = _codec_cfgs(name, rank)
    pos = next(f"pos{i}" for i, s in enumerate(jcfg.layer_pattern) if s.moe)
    jp = jax.tree.map(lambda v: v[0], _ref_params(jcfg)["blocks"][pos]["moe"])
    jp.pop("shared", None)
    return jcfg, cfg, jp


def _grads_equal(jloss, jp, x, tloss, tp, what, keys):
    """Reference ``jax.grad`` of ``jloss(params, x)`` against the port's
    ``tloss(params, x)`` backward: x and every leaf under ``keys`` of the
    params (the rest held constant)."""
    jg = jax.jit(jax.grad(lambda sub, xx: jloss({**jp, **sub}, xx), argnums=(0, 1)))(
        {k: jp[k] for k in keys}, x)
    for k in keys:
        for leaf in opt_mod.tree_leaves(tp[k]) if isinstance(tp[k], dict) else [tp[k]]:
            leaf.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tloss(tp, tx).backward()
    _leaf_close(tx.grad, jg[1], f"{what} x")
    for path, want in jax.tree_util.tree_flatten_with_path(jg[0])[0]:
        g = tp
        for key in path:
            g = g[key.key]
        _leaf_close(g.grad, want, f"{what} {jax.tree_util.keystr(path)}")


def test_moe_sorted_codec_under_training():
    """``moe_sorted`` with the dispatch codec (switch-base smoke, rank 32),
    ``aux=True``: output, ``recon_loss`` and ``aux_loss`` (which carries
    ``recon_weight · recon_loss``) equal the reference's; the gradients of
    a functional of y plus ``aux_loss`` reach x, the expert weights and the
    codec's ``enc`` / ``dec`` as ``jax.grad``'s do."""
    jcfg, cfg, jp = _moe_case("switch-base", 32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((20, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((20, cfg.d_model)).astype(np.float32)
    want, jaux = jax.jit(lambda p, xx: jmoe.moe_sorted(p, xx, jcfg))(jp, x)
    tp = params_from_numpy(jp, "cpu")
    got, aux = tmoe.moe_sorted(tp, torch.from_numpy(x), cfg, aux=True)
    _leaf_close(got, want, "y", 1e-5)
    assert set(aux) == set(jaux)
    for key in ("recon_loss", "aux_loss"):
        _leaf_close(aux[key], jaux[key], key, 1e-5)

    def jloss(p, xx):
        y, a = jmoe.moe_sorted(p, xx, jcfg)
        return (y * r).sum() + a["aux_loss"]

    def tloss(p, xx):
        y, a = tmoe.moe_sorted(p, xx, cfg, aux=True)
        return (y * torch.from_numpy(r)).sum() + a["aux_loss"]

    # the gate's leaves are held in tests/test_torch_train_step.py: here
    # their gradient from y runs through top-1's p / p, rounding noise only
    _grads_equal(jloss, jp, x, tloss, tp, "moe_sorted", ("wi", "wo", "codec"))
    assert tp["codec"]["enc"].grad.abs().max() > 0


def test_moe_resident_codec_under_training():
    """``moe_resident`` (the pooled end tier's dispatch, two resident
    experts of switch-base smoke beside the garbage slot) with the codec
    and ``aux=True``: output, aux and the gradients of x and the codec
    against the reference's; ``apply_moe(train=True)`` takes the same
    path."""
    jcfg, cfg = _codec_cfgs("switch-base", 32)
    jres, tres = _resident_codec_case(jcfg, [0, 4], seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((16, cfg.d_model)).astype(np.float32)
    want, jaux = jax.jit(lambda p, xx: jmoe.moe_resident(p, xx, jcfg))(jres, x)
    got, aux = tmoe.apply_moe(tres, torch.from_numpy(x), cfg, train=True)
    _leaf_close(got, want, "y", 1e-5)
    for key in ("recon_loss", "aux_loss", "lb_expert", "router_z"):
        _leaf_close(aux[key], jaux[key], key, 1e-5)

    def jloss(p, xx):
        y, a = jmoe.moe_resident(p, xx, jcfg)
        return (y * r).sum() + a["aux_loss"]

    def tloss(p, xx):
        y, a = tmoe.moe_resident(p, xx, cfg, aux=True)
        return (y * torch.from_numpy(r)).sum() + a["aux_loss"]

    _grads_equal(jloss, jres, x, tloss, tres, "moe_resident", ("codec",))


# --------------------------------------------------------------- train steps


CODEC_STEP_CASES = {
    "qwen3-moe adafactor rank 64": lambda: tuple(
        s(g("qwen3-moe-235b-a22b")).replace(dtype="float32")
        for s, g in ((jsmoke, jget), (smoke_config, get_config))),
    "switch-base ec2moe rank 64, 4 layers": lambda: _codec_cfgs("switch-base", 64,
                                                                 num_layers=4),
}


@pytest.mark.parametrize("case", sorted(CODEC_STEP_CASES))
def test_codec_train_step_equals_the_reference(case):
    """Two steps of ``make_train_step`` with the joint eq. 8 term: every
    gradient leaf (the codecs' ``enc`` / ``dec`` of each MoE layer
    included), every metric (``recon_loss`` and the ``aux_loss`` that
    carries it too) and the params after each step."""
    jcfg, cfg = CODEC_STEP_CASES[case]()
    assert cfg.compression.rank == 64 and "dispatch" in cfg.compression.boundaries
    steps_equal_the_reference(case, jcfg, cfg, n_steps=2)


def test_pipeline_codec_trains_as_without_a_codec():
    """A codec on the pipeline boundary only (tinyllama smoke, rank 32) is a
    serving boundary and never enters the model: the train step takes it
    (the reference trains such a config), its loss and gradients equal the
    reference's on that config, and the port's own without compression
    bit for bit."""
    jcfg, cfg = _codec_cfgs("tinyllama-1.1b", 32, boundaries=("pipeline",))
    steps_equal_the_reference("pipeline codec", jcfg, cfg, n_steps=1)
    plain = cfg.replace(compression=None)
    params = Model(plain, device="cpu").init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, 512, (2, 16), generator=torch.Generator().manual_seed(1)),
             "labels": torch.randint(0, 512, (2, 16), generator=torch.Generator().manual_seed(2))}
    runs = [steps.loss_and_grads(steps.make_loss_fn(Model(c, device="cpu")), params, batch)
            for c in (cfg, plain)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(opt_mod.tree_leaves(runs[0][2]), opt_mod.tree_leaves(runs[1][2])):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ Trainer


def test_trainer_with_the_codec_equals_the_reference(tmp_path):
    """``Trainer`` on qwen3-moe smoke (its rank-64 dispatch codec,
    Adafactor): every logged loss and grad norm against the reference
    trainer's (``trainer_equals_the_reference``)."""
    trainer_equals_the_reference(tmp_path, *(
        s(g("qwen3-moe-235b-a22b")).replace(dtype="float32")
        for s, g in ((jsmoke, jget), (smoke_config, get_config))))


# ----------------------------------------- the rest of core/compression.py


def test_2d_codec_equals_the_reference():
    """eq. 8 verbatim, Z = U^T X V and X̂ = U_hat Z V_hat^T, on the
    reference's codec: z and x̂ within 1e-5 of their largest |value|; the
    port's own init is orthonormal, its decoder the encoder, and at r = w
    the error stays below a zero guess's."""
    h, w, c, r = 16, 12, 3, 12
    jp = jcomp.init_lowrank_2d(jax.random.PRNGKey(0), h, w, r)
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, h, w, c)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jz = jcomp.encode_2d(jp, jnp.asarray(x))
    z = tcomp.encode_2d(tp, torch.from_numpy(x))
    assert tuple(z.shape) == (2, r, r, c)
    _leaf_close(z, jz, "z", 1e-5)
    _leaf_close(tcomp.decode_2d(tp, z), jcomp.decode_2d(jp, jz), "x_hat", 1e-5)
    own = tcomp.init_lowrank_2d(torch.Generator().manual_seed(0), h, w, r)
    assert torch.allclose(own["U"].T @ own["U"], torch.eye(r), atol=1e-5)
    assert torch.equal(own["U_hat"], own["U"]) and torch.equal(own["V_hat"], own["V"])
    xt = torch.from_numpy(x)
    err = tcomp.recon_loss(xt, tcomp.decode_2d(own, tcomp.encode_2d(own, xt)))
    assert float(err) < float(tcomp.recon_loss(xt, torch.zeros_like(xt)))


def test_joint_loss_equals_the_reference():
    """``joint_loss`` = recon_weight · ||X − X̂||² + task_weight · L_task,
    at the reference's own case and on random inputs."""
    rng = np.random.default_rng(5)
    cases = [(np.ones((4, 8), np.float32), np.zeros((4, 8), np.float32), 2.0, 1.0, 0.5),
             (rng.standard_normal((6, 16)).astype(np.float32),
              rng.standard_normal((6, 16)).astype(np.float32), 3.25, 0.05, 1.0)]
    for x, x_hat, task, rw, tw in cases:
        want = jcomp.joint_loss(jnp.asarray(x), jnp.asarray(x_hat), jnp.asarray(task),
                                recon_weight=rw, task_weight=tw)
        got = tcomp.joint_loss(torch.from_numpy(x), torch.from_numpy(x_hat), torch.tensor(task),
                               recon_weight=rw, task_weight=tw)
        _leaf_close(got, want, "joint_loss", 1e-6)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("axis", [-1, 0])
def test_int8_range_codec_equals_the_reference(axis):
    """``quantize_int8`` codes and scales bit-equal to the reference's along
    either axis (a zero row takes the 1e-12 floor), the dequantized values
    within half a step of x, and ``dequantize_int8`` bit-equal."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((16, 32)) * rng.uniform(0.01, 10, (16, 1))).astype(np.float32)
    x[3] = 0.0
    jq, js = jcomp.quantize_int8(jnp.asarray(x), axis=axis)
    q, s = tcomp.quantize_int8(torch.from_numpy(x), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    x_hat = tcomp.dequantize_int8(q, s, torch.float32)
    np.testing.assert_array_equal(x_hat.numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js, jnp.float32)))
    assert (np.abs(x - x_hat.numpy()) <= s.numpy() * 0.5 + 1e-6).all()
    assert tcomp.dequantize_int8(q, s).dtype == torch.bfloat16
