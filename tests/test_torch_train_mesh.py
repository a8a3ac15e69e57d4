"""The port's training on a mesh against the reference's on the same mesh
shape, in f32 on the CPU: the partition spec tables, the
vocabulary-sharded cross-entropy, the a2a and tp MoE bodies' gradients,
``make_train_step`` and ``Trainer`` with a checkpoint resumed onto a
smaller mesh and onto one device.

The reference runs in two subprocesses side by side, each on 4 host
devices (its device count is fixed when JAX starts), its calls jitted: the
spec tables, the loss and the bodies in one, the steps and the trainers in
the other.  It draws the params and hands them, with its results, to the
port through an ``.npz``.  The port runs in
two ``spawn_ranks`` of gloo ranks (``_torch_mesh_ranks.py``: the ranks
import no JAX): 4 ranks for the loss, the bodies, the steps and the
``Trainer`` on (2, 2); 2 ranks for the resume on
``elastic_topology(2, model_axis_size=2)``.

Tolerances (those of ``test_torch_train_step.py`` and
``test_torch_training.py``): gradients and metrics 1e-4 of a leaf's
largest |value| (1e-5 relative for the losses, the grad norm and the lr);
params within lr a step taken and all but 1% of a leaf's elements within
1e-5 + 1e-5 |p|; the trainers' losses 1e-5 relative, their grad norms
1e-4; the cross-entropy's value 1e-4 and its gradient rtol 1e-4, atol 1e-5
(the reference's own sharded-loss test).
"""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _torch_mesh_ranks as ranks
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.fault import elastic_shape
from repro_torch.distributed.topology import Topology
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models.model import Model
from repro_torch.training.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TESTS = os.path.dirname(__file__)
SPEC_MESHES = ((1, 4), (2, 2), (2, 4), (16, 16))
LR = ranks.OPT["lr"]

_M = dict(cf=8.0, codec=False, B=4, S=16)
# the bodies' gradient cases: name -> (impl, mesh, overrides)
MOE_CASES = {
    f"{impl} {mesh} {tag}": (impl, mesh, kw)
    for impl in ("a2a", "tp") for mesh in ((1, 4), (2, 2))
    for tag, kw in (("", {}), ("codec", dict(codec=True)), ("drops", dict(cf=1.0)))
}


def _moe_cases():
    return [{**_M, **kw, "name": name, "impl": impl, "mesh": list(mesh)}
            for name, (impl, mesh, kw) in MOE_CASES.items()]


REFERENCE_HEAD = """
import dataclasses, itertools, json, os, shutil
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import sys; sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
from types import SimpleNamespace
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.configs import ARCHS, get_config, smoke_config
from repro.configs.base import CompressionConfig
from repro.core import moe
from repro.data import pipeline as jpipeline
from repro.distributed import sharding
from repro.distributed.fault import elastic_topology
from repro.distributed.loss import sharded_cross_entropy
from repro.distributed.topology import Topology
from repro.launch import steps
from repro.models.layers import cross_entropy_loss
from repro.models.model import build_model, make_dummy_batch
from repro.training.optimizer import OptimizerConfig, init_optimizer
from repro.training.trainer import Trainer, TrainerConfig
from _torch_ep_ranks import flatten
import _torch_mesh_ranks as R

args = json.load(open({args!r}))
out = {{}}
np_tree = lambda t: jax.tree.map(np.asarray, t)

def spec_list(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]

meshes = {{}}
def mesh_of(shape):
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = jax.make_mesh(shape, ("data", "model"),
                                      axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return meshes[shape]

def topo_of(shape):
    return Topology(mesh=mesh_of(shape), data_axes=("data",), model_axis="model")

"""

# the spec tables, the loss and the bodies' gradients
REFERENCE_A = """# -- the spec tables: a stub topology carrying only the mesh's shape --------
tables = {{}}
for name in sorted(ARCHS):
    cfg = get_config(name)
    model = build_model(cfg)
    p_sds, o_sds = steps.abstract_state(model)
    tables[name] = {{}}
    for shape in args["spec_meshes"]:
        mesh = SimpleNamespace(shape=dict(zip(("data", "model"), shape)))
        topo = Topology(mesh=mesh, data_axes=("data",), model_axis="model")
        B = 8
        batch = {{"tokens": jax.ShapeDtypeStruct((B, 64), jnp.int32),
                  "labels": jax.ShapeDtypeStruct((B, 64), jnp.int32),
                  "lengths": jax.ShapeDtypeStruct((B,), jnp.int32),
                  "cache": {{"k": jax.ShapeDtypeStruct((2, B, 64, 4, 8), jnp.float32),
                            "ssm": jax.ShapeDtypeStruct((2, 1, 8, 4, 4), jnp.float32),
                            "conv_x": jax.ShapeDtypeStruct((2, B, 3, 16), jnp.float32),
                            "conv_bc": jax.ShapeDtypeStruct((2, 3, 3, 16), jnp.float32),
                            "lengths": jax.ShapeDtypeStruct((3,), jnp.int32)}}}}
        got = {{}}
        for what, tree, specs in (
                ("params", p_sds, sharding.param_specs(p_sds, topo)),
                ("opt", o_sds, sharding.opt_state_specs(o_sds, p_sds, topo)),
                ("batch", batch, sharding.batch_specs(batch, topo))):
            leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
            sp = jax.tree_util.tree_flatten(specs, is_leaf=lambda s: isinstance(s, P))[0]
            got[what] = {{"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
                         [list(leaf.shape), spec_list(s)] for (kp, leaf), s in zip(leaves, sp)}}
        tables[name][str(tuple(shape))] = got
json.dump(tables, open({tables!r}, "w"))

# -- the sharded loss (the reference's own case, on (2, 2)) ----------------
rng = np.random.default_rng(0)
logits = rng.standard_normal((4, 8, 32)).astype(np.float32)
labels = rng.integers(0, 32, (4, 8)).astype(np.int32)
labels[0, 0] = -1
out["ce_logits"], out["ce_labels"] = logits, labels
want, _ = cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
out["ce_want"] = np.asarray(want)
out["ce_grad"] = np.asarray(jax.grad(
    lambda l: cross_entropy_loss(l, jnp.asarray(labels))[0])(jnp.asarray(logits)))

# -- the MoE bodies' gradients ----------------------------------------------
base = smoke_config(get_config(R.MOE)).replace(dtype="float32")
mparams = {{c: moe.init_moe(jax.random.PRNGKey(3), base.replace(compression=(
    CompressionConfig(rank=R.CODEC_RANK, boundaries=("dispatch",)) if c else None)))
    for c in (0, 1)}}
for c in (0, 1):
    out.update(flatten(np_tree(mparams[c]), f"mparams_{{c}}/"))
for i, case in enumerate(args["moe_cases"]):
    cfg = base.replace(
        moe_impl=case["impl"],
        moe=dataclasses.replace(base.moe, capacity_factor=case["cf"]),
        compression=(CompressionConfig(rank=R.CODEC_RANK, boundaries=("dispatch",))
                     if case["codec"] else None))
    rng = np.random.default_rng(100 + i)
    x = rng.standard_normal((case["B"], case["S"], base.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    name = case["name"]
    out["mx_" + name], out["mct_" + name] = x, ct
    topo = topo_of(case["mesh"])
    with jax.set_mesh(topo.mesh):
        xs = jax.device_put(jnp.asarray(x), NamedSharding(topo.mesh, P("data", None, None)))

        def loss(p, xx):
            y, aux = moe.apply_moe(p, xx, cfg, topo, train=True)
            return (y * ct).sum() + aux["aux_loss"], (y, aux)

        (_, (y, aux)), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            mparams[int(case["codec"])], xs)
    out["my_" + name] = np.asarray(y)
    out["maux_" + name] = np.asarray(aux["aux_loss"])
    out["mdrop_" + name] = np.asarray(aux["dropped_frac"])
    out["mg_" + name + "/x"] = np.asarray(g[1])
    out.update(flatten(np_tree(g[0]), "mg_" + name + "/params/"))

np.savez({out!r}, **out)
print("REF OK")
"""

# the train steps and the trainers
REFERENCE_B = """# -- make_train_step on (2, 2) ----------------------------------------------
topo = topo_of(R.TRAIN_MESH)
for name, (arch, kw) in R.STEP_CASES.items():
    cfg = smoke_config(get_config(arch)).replace(dtype="float32", **kw)
    model = build_model(cfg, topo)
    batch = np_tree(make_dummy_batch(cfg, jax.random.PRNGKey(1), 8, 32))
    out.update(flatten(batch, f"tp_{{name}}/batch/"))
    p = build_model(cfg).init(jax.random.PRNGKey(0))
    o = init_optimizer(cfg.optimizer, p)
    bspec = sharding.named(sharding.batch_specs(batch, topo), topo)
    loss_fn = steps.make_loss_fn(model)
    accum = max(1, cfg.grad_accum)
    with jax.set_mesh(topo.mesh):
        jgrad = jax.jit(jax.grad(lambda pp, bb: loss_fn(pp, bb)[0]))
        jstep, _ = steps.jit_train_step(model, jax.tree.map(
            lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), batch),
            OptimizerConfig(name=cfg.optimizer, **R.OPT))
        p = jax.device_put(p, sharding.named(sharding.param_specs(p, topo), topo))
        o = jax.device_put(o, sharding.named(sharding.opt_state_specs(o, p, topo), topo))
        for i in range(2):
            out.update(flatten(np_tree(p), f"tp_{{name}}/p{{i}}/"))
            mb = batch["tokens"].shape[0] // accum
            g = None
            for a in range(accum):  # the step's microbatches, its rows a data rank
                micro = jax.device_put({{k: v[a * mb:(a + 1) * mb] for k, v in batch.items()}},
                                       sharding.named(sharding.batch_specs(
                                           {{k: v[:mb] for k, v in batch.items()}}, topo), topo))
                ga = jgrad(p, micro)
                g = ga if g is None else jax.tree.map(lambda u, v: u + v, g, ga)
            out.update(flatten(np_tree(jax.tree.map(lambda u: u / accum, g)),
                               f"tp_{{name}}/g{{i}}/"))
            p, o, m = jstep(p, o, jax.device_put(batch, bspec))
            for k, v in m.items():
                out[f"tp_{{name}}/m{{i}}/{{k}}"] = np.asarray(v)
        out.update(flatten(np_tree(p), f"tp_{{name}}/p{{2}}/"))

# -- Trainer on (2, 2), resumed on (1, 2) and on one device -----------------
cfg = R.trainer_config()
ck, copy = args["ckpt"], args["ckpt"] + "_one"
kw = dict(async_checkpoint=False, log_every=1)
tr = Trainer(cfg, R.trainer_data(0, jpipeline), topo=elastic_topology(4, model_axis_size=2),
             trainer_cfg=TrainerConfig(total_steps=3, checkpoint_every=3, checkpoint_dir=ck,
                                       **kw)).initialize()
out.update(flatten(np_tree(tr.params), "tr/params/"))
out.update(flatten(np_tree(tr.opt_state), "tr/opt/"))
logs = {{"22": tr.run()["log"]}}
shutil.copytree(ck, copy)
t2 = elastic_topology(2, model_axis_size=2)
tr2 = Trainer(cfg, R.trainer_data(3, jpipeline), topo=t2, trainer_cfg=TrainerConfig(
    total_steps=5, checkpoint_every=5, checkpoint_dir=ck, **kw)).initialize()
assert tr2.step == 3 and (t2.dp_size, t2.ep_size) == (1, 2)
logs["12"] = tr2.run()["log"]
tr1 = Trainer(cfg, R.trainer_data(3, jpipeline), trainer_cfg=TrainerConfig(
    total_steps=5, checkpoint_every=5, checkpoint_dir=copy, **kw)).initialize()
assert tr1.step == 3
logs["one"] = tr1.run()["log"]
json.dump(logs, open({logs!r}, "w"))
np.savez({out!r}, **out)
print("REF OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's npz, its spec tables, its trainer logs, the port's
    4-rank results, its 2-rank elastic resume, its one-device resume)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    paths = {k: str(tmp / k) for k in ("args.json", "ref_a.npz", "ref_b.npz", "tables.json",
                                       "logs.json", "ref.npz")}
    json.dump({"spec_meshes": [list(m) for m in SPEC_MESHES], "moe_cases": _moe_cases(),
               "ckpt": str(tmp / "ref_ckpt")}, open(paths["args.json"], "w"))
    procs = []
    for part, out in ((REFERENCE_A, paths["ref_a.npz"]), (REFERENCE_B, paths["ref_b.npz"])):
        code = (REFERENCE_HEAD + part).format(src=SRC, tests=TESTS, args=paths["args.json"],
                                              out=out, tables=paths["tables.json"],
                                              logs=paths["logs.json"])
        procs.append(subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for proc in procs:  # the two halves run side by side
        stdout, stderr = proc.communicate(timeout=400)
        assert proc.returncode == 0 and "REF OK" in stdout, stderr[-4000:]
    ref = {**np.load(paths["ref_a.npz"]), **np.load(paths["ref_b.npz"])}
    np.savez(paths["ref.npz"], **ref)
    ckpt, copy = str(tmp / "port_ckpt"), str(tmp / "port_ckpt_one")
    port = tmesh.spawn_ranks(ranks.TRAIN_MESH, ranks.train_mesh_module, paths["ref.npz"],
                             _moe_cases(), ckpt, copy, policy="tp", device="cpu",
                             timeout_s=300)
    elastic = tmesh.spawn_ranks(elastic_shape(2, 2), ranks.elastic_resume, ckpt, policy="tp",
                                device="cpu", timeout_s=200)
    one = Trainer(ranks.trainer_config(), ranks.trainer_data(3), device="cpu",
                  trainer_cfg=TrainerConfig(total_steps=5, checkpoint_every=5,
                                            checkpoint_dir=copy, async_checkpoint=False,
                                            log_every=1)).initialize()
    resumed = one.step
    one_log = one.run()["log"]
    return SimpleNamespace(ref=ref, tables=json.load(open(paths["tables.json"])),
                           logs=json.load(open(paths["logs.json"])), port=port,
                           elastic=elastic, one=(resumed, one_log))


def _close(got, want, what, rel=1e-4):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-30), f"{what}: max |diff| {err}"


def _shape_tree(flat):
    """Nested dict of shape stubs from {path: [shape, spec]}."""
    tree = {}
    for path, (shape, _) in flat.items():
        *head, leaf = path.split("/")
        node = tree
        for p in head:
            node = node.setdefault(p, {})
        node[leaf] = SimpleNamespace(shape=tuple(shape))
    return tree


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = [list(e) if isinstance(e, tuple) else e for e in v]
    return out


@pytest.mark.parametrize("mesh", SPEC_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_spec_tables_equal_the_reference(runs, mesh):
    """``param_specs``, ``opt_state_specs`` and ``batch_specs`` of every
    config at full width, leaf by leaf, on a mesh of this shape (the
    reference's functions on a stub topology carrying only the shape)."""
    topo = Topology(mesh_shape=mesh, coords=(0, 0))
    assert sorted(runs.tables) == sorted(ARCHS) and len(ARCHS) == 11
    n = 0
    for name in sorted(ARCHS):
        ref = runs.tables[name][str(tuple(mesh))]
        params, opt, batch = (_shape_tree(ref[k]) for k in ("params", "opt", "batch"))
        got = {"params": _flat_specs(sharding.param_specs(params, topo)),
               "opt": _flat_specs(sharding.opt_state_specs(opt, params, topo)),
               "batch": _flat_specs(sharding.batch_specs(batch, topo))}
        for what in ("params", "opt", "batch"):
            want = {k: spec for k, (_, spec) in ref[what].items()}
            assert got[what] == want, (name, what)
            n += len(want)
    assert n > 1000


def test_sharded_cross_entropy_matches_plain(runs):
    """The reference's own case on (2, 2): logits [4, 8, 32] with a masked
    label, each rank its rows and vocabulary slice; value and gradient
    against the plain cross-entropy, on every rank."""
    for loss, tokens, grad in (r["ce"] for r in runs.port):
        assert abs(loss - float(runs.ref["ce_want"])) < 1e-4
        assert tokens == 31.0
        np.testing.assert_allclose(grad, runs.ref["ce_grad"], rtol=1e-4, atol=1e-5)


def test_one_device_cross_entropy_is_the_plain_one():
    """Without a mesh the loss is ``cross_entropy_loss`` (its token count
    the masked one's)."""
    from repro_torch.distributed.loss import sharded_cross_entropy

    loss, metrics = sharded_cross_entropy(torch.zeros(1, 2, 8),
                                          torch.zeros(1, 2, dtype=torch.int32))
    assert float(metrics["tokens"]) == 2.0
    assert abs(float(loss) - float(np.log(8.0)) - 1e-4 * float(np.log(8.0)) ** 2) < 1e-6


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_body_gradients_equal_the_reference(runs, name):
    """``apply_moe``'s a2a and tp bodies under ``sum(y · ct) + aux_loss``:
    y, aux_loss and ``dropped_frac``, then the gradient of every param leaf
    (the gate, the codec, the experts gathered over the model axis) and of
    ``x``, against ``jax.grad`` of the reference's ``apply_moe`` under
    ``shard_map`` on the same mesh."""
    impl, _, kw = MOE_CASES[name]
    ref = runs.ref
    y, aux_loss, dropped, grads, bodies = runs.port[0]["moe"][name]
    assert bodies == ((1, 0) if impl == "a2a" else (0, 1)), bodies
    for r in runs.port[1:]:
        np.testing.assert_array_equal(r["moe"][name][3]["x"], grads["x"])
    _close(y, ref["my_" + name], f"{name} y", 1e-5)
    assert abs(aux_loss - float(ref["maux_" + name])) <= 1e-6
    assert dropped == pytest.approx(float(ref["mdrop_" + name]), abs=1e-6)
    assert (dropped > 0) == (kw.get("cf") == 1.0), dropped
    want = {k[len(f"mg_{name}/"):]: v for k, v in ref.items() if k.startswith(f"mg_{name}/")}
    assert set(grads) == set(want), (sorted(grads), sorted(want))
    for k, v in want.items():
        _close(grads[k], v, f"{name} d{k}")


def _params_close(got, want, lr_steps):
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert diff.max() <= lr_steps, f"params {k}: max |diff| {diff.max()}"
        assert (diff > 1e-5 + 1e-5 * np.abs(w)).mean() <= 0.01, f"params {k}"


@pytest.mark.parametrize("name", list(ranks.STEP_CASES))
def test_train_step_on_a_mesh_equals_the_reference(runs, name):
    """Two steps of the mesh's ``make_train_step`` on (2, 2) against the
    reference's ``jit_train_step`` on the same mesh from the same params
    and batch: before each step every gradient leaf at the reference's
    params (its microbatches' rows a data rank), after it every metric;
    the params after each step.  switch-base smoke at 2 blocks with AdamW;
    qwen3-moe smoke at 1 layer with its Adafactor, ``grad_accum=2`` and
    its rank-64 dispatch codec."""
    ref = runs.ref
    steps_out, params = runs.port[0]["steps"][name]
    for i, (grads, metrics, n) in enumerate(steps_out):
        assert n == i + 1
        flat = {k[len(f"tp_{name}/g{i}/"):]: v for k, v in ref.items()
                if k.startswith(f"tp_{name}/g{i}/")}
        assert set(grads) == set(flat) and flat
        for k, v in flat.items():
            _close(grads[k], v, f"{name} step {i} d{k}")
        mkeys = {k.split("/")[-1] for k in ref if k.startswith(f"tp_{name}/m{i}/")}
        assert set(metrics) == mkeys, (sorted(metrics), sorted(mkeys))
        for key in mkeys:
            rel = 1e-5 if key in ("loss", "ce_loss", "grad_norm", "lr") else 1e-4
            _close(metrics[key], ref[f"tp_{name}/m{i}/{key}"], f"{name} {key}", rel)
    want = {k[len(f"tp_{name}/p2/"):]: v for k, v in ref.items()
            if k.startswith(f"tp_{name}/p2/")}
    _params_close(params, want, LR * 2)
    for r in runs.port[1:]:  # every rank read the same metrics
        for (_, m, _), (_, m0, _) in zip(r["steps"][name][0], steps_out):
            assert {k: float(np.asarray(v).sum()) for k, v in m.items()} == \
                {k: float(np.asarray(v).sum()) for k, v in m0.items()}


def test_a_pipeline_axis_is_a_replica_axis(runs):
    """``make_topology`` with a pipeline axis on the 4 ranks, mesh (2, 1, 2)
    over ("pipe", "data", "model"): ``pp_size`` 2, the data and model
    group of 2 ranks that leaves the pipeline axis out (the MoE bodies'
    ``pmean``), the world of 4."""
    for rank, r in enumerate(runs.port):
        pp, dp, ep, dm_mean, world_mean = r["pipe"]
        assert (pp, dp, ep) == (2, 1, 2)
        assert dm_mean == (rank // 2) * 2 + 0.5  # ranks 2p and 2p+1 alike
        assert world_mean == 1.5


def test_the_mesh_step_counts_its_collectives_forward_and_backward(runs):
    """The collectives the two step cases ran (rank 0): the bodies' forward
    exchanges and their backward adjoints, the gathers of the blocks and
    the reduce-scatters of the gradients all counted."""
    counts = runs.port[0]["counts"]
    for k in ("all_to_all", "all_gather", "reduce_scatter", "psum"):
        assert counts[k]["calls"] > 0 and counts[k]["bytes"] > 0, (k, counts[k])
    assert counts["all_to_all"]["bwd_calls"] > 0 and counts["psum"]["bwd_calls"] > 0


def _logs_equal(got, want):
    assert [m["step"] for m in got] == [m["step"] for m in want]
    for a, b in zip(got, want):
        assert np.isfinite(a["loss"])
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"]), (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-4 * abs(b["grad_norm"]), (a, b)


def test_trainer_on_a_mesh_and_the_elastic_resume_equal_the_reference(runs):
    """``Trainer`` on (2, 2) for 3 steps from the reference's state after
    ``initialize()``, checkpointed at 3 (every rank's log alike), then
    resumed on ``elastic_topology(2, model_axis_size=2)``, a (1, 2) mesh of
    2 ranks, for steps 4 and 5: the losses and grad norms of both runs
    against the reference's trainers on the same meshes."""
    logs = runs.logs
    for r in runs.port:
        _logs_equal(r["trainer"], logs["22"])
    assert [m["step"] for m in logs["22"]] == [1, 2, 3]
    for mesh, resumed, final, log in runs.elastic:
        assert (mesh, resumed, final) == ((1, 2), 3, 5)
        _logs_equal(log, logs["12"])
    assert [m["step"] for m in logs["12"]] == [4, 5]


def test_the_mesh_checkpoint_resumes_on_one_device(runs):
    """The (2, 2) run's checkpoint (whole arrays, the one-device format)
    restored by the one-device ``Trainer``: steps 4 and 5 against the
    reference's one-device trainer resumed from its own (2, 2)
    checkpoint."""
    resumed, log = runs.one
    assert resumed == 3
    _logs_equal(log, runs.logs["one"])


def test_a2a_without_a_mesh_raises_the_references_error():
    """An expert-parallel body named without a mesh is the reference's
    ``ValueError`` (an unknown impl off a mesh), in the loss and in
    ``train_logits``."""
    cfg = ranks.step_config("switch-base adamw").replace(moe_impl="a2a")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "labels": torch.zeros((1, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="unknown moe impl 'a2a'"):
        steps.make_loss_fn(model)(params, batch)
    with pytest.raises(ValueError, match="unknown moe impl 'a2a'"):
        model.train_logits(params, batch)


def test_blocks_and_specs_without_ranks():
    """``local_block`` on a (2, 4) mesh's rank (1, 2):
    the data block along the FSDP dim, the model block along the expert
    dim; ``elastic_shape`` keeps the model axis and refuses too few."""
    topo = Topology(mesh_shape=(2, 4), coords=(1, 2))
    wi = torch.arange(2 * 8 * 6 * 3).reshape(2, 8, 6, 3)
    spec = sharding.param_partition_spec("blocks/pos0/moe/wi", tuple(wi.shape), topo)
    assert spec == (None, "model", "data", None)
    blk = sharding.local_block(wi, spec, topo)
    assert tuple(blk.shape) == (2, 2, 3, 3)
    assert torch.equal(blk, wi[:, 4:6, 3:6])
    assert sharding.compute_spec("blocks/pos0/moe/wi", spec, topo) == (None, "model", None, None)
    assert sharding.compute_spec("blocks/pos0/attn/wq", (None, "data", "model", None), topo) == ()
    assert elastic_shape(7, 2) == (3, 2) and elastic_shape(4, 4) == (1, 4)
    with pytest.raises(RuntimeError, match="cannot keep model axis"):
        elastic_shape(1, 2)
    assert get_config("switch-base").padded_vocab_size % 4 == 0
