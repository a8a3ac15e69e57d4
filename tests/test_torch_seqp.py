"""The port's sequence parallelism and head-sharded SSM against the
reference's on the same host mesh and policy, in f32 on the CPU: the
``seqp`` / ``serve_seqp`` topologies, sequence-parallel attention (its
K/V gather's backward a reduce-scatter), ``apply_moe``'s pre-sharded a2a
tokens (3-D and 2-D, drops, a dispatch codec) and the shapes the
reference refuses, the head-sharded ``apply_ssm``, ``make_train_step``
under ``seqp`` (qwen3-moe, llama4-scout) and ``tp`` (jamba, mamba2),
``Model.prefill`` under ``seqp``, resident SSM weights served under
``serve_tp`` and ``ServingEngine`` under ``serve_seqp``.

The reference runs in three subprocesses side by side, each on 4 host
devices, its calls jitted (jamba's step compiles longest and runs alone); it draws the params and hands them, with its
results, to the port through an ``.npz``.  The port runs in one
``spawn_ranks`` of 4 gloo ranks (``_torch_seqp_ranks.py``; the ranks
import no JAX), which build every topology the cases need.

Tolerances (``test_torch_train_mesh.py``'s): values and gradients 1e-4 of
a leaf's largest |value| (1e-5 for attention's and the MoE's outputs, and
relative for the losses, the grad norm and the lr); params within lr a
step taken, all but 1% of a leaf's elements within 1e-5 + 1e-5 |p|;
logits 1e-4 of their largest |value|; tokens equal.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import _torch_seqp_ranks as ranks
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TESTS = os.path.dirname(__file__)
LR = ranks.OPT["lr"]


def _serve_runs():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 500, size=rng.integers(4, 20)).tolist() for _ in range(5)]
    return [dict(name=f"{slots} slots", slots=slots, layers=2, prompts=prompts, new=6,
                 max_len=64, chunk=8) for slots in (2, 4)]


REFERENCE_HEAD = """
import dataclasses, json, os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import sys; sys.path.insert(0, {src!r}); sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.configs import get_config, smoke_config
from repro.configs.base import CompressionConfig
from repro.core import moe
from repro.distributed import sharding
from repro.launch import steps
from repro.launch.mesh import make_topology
from repro.models import attention as jattn, ssm as jssm, transformer
from repro.models.model import Model, make_dummy_batch
from repro.serving.engine import Request, ServingEngine
from repro.training.optimizer import OptimizerConfig, init_optimizer
from _torch_ep_ranks import flatten
import _torch_seqp_ranks as R

args = json.load(open({args!r}))
out = {{}}
np_tree = lambda t: jax.tree.map(np.asarray, t)
meshes = {{}}

def topo_of(shape, policy):
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = jax.make_mesh(shape, ("data", "model"),
                                      axis_types=(jax.sharding.AxisType.Auto,) * 2)
    return make_topology(meshes[shape], policy=policy)

def put(x, topo, *spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(topo.mesh, P(*spec)))

"""

# topologies, attention, the MoE cases, the SSM, prefill and serving
REFERENCE_A = """tops = {{}}
for policy in ("seqp", "serve_seqp"):
    for shape in R.MESHES:
        t = topo_of(shape, policy)
        tops[f"{{policy}} {{tuple(shape)}}"] = dict(
            data_axes=list(t.data_axes), model_axis=t.model_axis, fsdp=t.fsdp,
            seq_parallel_attn=t.seq_parallel_attn, dp=t.dp_size, ep=t.ep_size)
out["topologies"] = np.asarray(json.dumps(tops))

# -- sequence-parallel attention ---------------------------------------------
for i, (name, (mesh, causal, window)) in enumerate(R.ATTN_CASES.items()):
    cfg = smoke_config(get_config(R.MOE)).replace(dtype="float32", sliding_window=window)
    topo = topo_of(mesh, "seqp")
    p = jattn.init_attention(jax.random.PRNGKey(5 + i), cfg, jnp.float32)
    B, S = R.ATTN_SHAPE
    rng = np.random.default_rng(10 + i)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    angles = np.asarray(jattn.rope_angles(jnp.broadcast_to(jnp.arange(S)[None], (B, S)),
                                          cfg.head_dim, cfg.rope_theta))

    def f(pp, hh, cfg=cfg, topo=topo, causal=causal, ct=ct, angles=angles):
        o, (k, v) = transformer._self_attention_seqp(pp, hh, cfg, topo, jnp.asarray(angles),
                                                     causal)
        return (o * ct).sum(), (o, k, v)

    with jax.set_mesh(topo.mesh):
        (_, (o, k, v)), (gp, gh) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, put(h, topo, "data", "model", None))
    pre = f"attn_{{name}}/"
    out.update({{pre + "h": h, pre + "ct": ct, pre + "angles": angles, pre + "o": np.asarray(o),
                 pre + "k": np.asarray(k), pre + "v": np.asarray(v), pre + "dh": np.asarray(gh)}})
    out.update(flatten(np_tree(p), pre + "p/"))
    out.update(flatten(np_tree(gp), pre + "dp/"))

# -- pre-sharded MoE tokens ----------------------------------------------------
base = smoke_config(get_config(R.MOE)).replace(dtype="float32")
def moe_cfg(codec):
    return base.replace(moe=dataclasses.replace(base.moe, capacity_factor=R.TRAIN_CF),
                        compression=(CompressionConfig(rank=R.CODEC_RANK, boundaries=("dispatch",))
                                     if codec else None))
mparams = {{c: moe.init_moe(jax.random.PRNGKey(3), moe_cfg(c)) for c in (0, 1)}}
for c in (0, 1):
    out.update(flatten(np_tree(mparams[c]), f"mparams_{{c}}/"))
for i, (name, (mesh, nd, codec)) in enumerate(R.MOE_CASES.items()):
    cfg = moe_cfg(codec)
    topo = topo_of(mesh, "seqp")
    B, S = R.MOE_SHAPE
    rng = np.random.default_rng(100 + i)
    shape = (B, S, cfg.d_model) if nd == 3 else (B * S, cfg.d_model)
    # a direction every token shares skews the routing: assignments drop
    x = (rng.standard_normal(shape) + R.MOE_SKEW * np.random.default_rng(99).standard_normal(
        cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)

    def loss(p, xx, cfg=cfg, topo=topo, ct=ct):
        y, aux = moe.apply_moe(p, xx, cfg, topo, train=True)
        return (y * ct).sum() + aux["aux_loss"], (y, aux)

    with jax.set_mesh(topo.mesh):
        (_, (y, aux)), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            mparams[int(codec)], put(x, topo, "data", *([None] * (nd - 1))))
    pre = f"moe_{{name}}/"
    out.update({{pre + "x": x, pre + "ct": ct, pre + "y": np.asarray(y),
                 pre + "aux": np.asarray(aux["aux_loss"]),
                 pre + "drop": np.asarray(aux["dropped_frac"]), pre + "g/x": np.asarray(g[1])}})
    out.update(flatten(np_tree(g[0]), pre + "g/params/"))
refused = {{}}
for name, (mesh, policy, (B, S)) in R.REFUSED.items():
    topo = topo_of(mesh, policy)
    cfg = moe_cfg(False)
    try:
        with jax.set_mesh(topo.mesh):
            jax.jit(lambda p, xx, cfg=cfg, topo=topo: moe.apply_moe(p, xx, cfg, topo,
                                                                   train=False)[0])(
                mparams[0], jnp.zeros((B, S, cfg.d_model), jnp.float32))
        refused[name] = None
    except ValueError as e:
        refused[name] = str(e)
out["refused"] = np.asarray(json.dumps(refused))

# -- the head-sharded SSM under tp on (2, 2) ------------------------------------
topo = topo_of((2, 2), "tp")
for i, (name, arch) in enumerate(R.SSM_CASES.items()):
    cfg = smoke_config(get_config(arch)).replace(dtype="float32")
    p = jssm.init_ssm(jax.random.PRNGKey(9 + i), cfg, jnp.float32)
    B, S = R.SSM_SHAPE
    rng = np.random.default_rng(200 + i)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)

    def f(pp, xx, cfg=cfg, ct=ct):
        o, (fs, (cx, cbc)) = jssm.apply_ssm(pp, xx, cfg, topo=topo, return_state=True)
        return (o * ct).sum(), (o, fs, cx, cbc)

    with jax.set_mesh(topo.mesh):
        (_, res), g = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            p, put(x, topo, "data", None, None))
    pre = f"ssm_{{name}}/"
    out.update({{pre + "x": x, pre + "ct": ct, pre + "g/x": np.asarray(g[1])}})
    out.update({{pre + k: np.asarray(v) for k, v in zip(("out", "fs", "cx", "cbc"), res)}})
    out.update(flatten(np_tree(p), pre + "p/"))
    out.update(flatten(np_tree(g[0]), pre + "g/params/"))

# -- Model.prefill under seqp ------------------------------------------------------
pf = R.PREFILL
cfg = smoke_config(get_config(pf["config"])).replace(num_layers=pf["layers"], dtype="float32")
topo = topo_of(pf["mesh"], "seqp")
model = Model(cfg, topo)
params = model.init(jax.random.PRNGKey(0))
tokens = np.random.default_rng(300).integers(0, cfg.vocab_size, (pf["B"], pf["S"])).astype(np.int32)
with jax.set_mesh(topo.mesh):
    logits, cache = jax.jit(lambda p, t: model.prefill(p, {{"tokens": t}}))(params, tokens)
out.update(flatten(np_tree(params), "pf/params/"))
out.update(flatten(np_tree(cache["blocks"]), "pf/cache/"))
out["pf/tokens"], out["pf/logits"] = tokens, np.asarray(logits)

# -- resident SSM weights under serve_tp -------------------------------------------
rs = R.RESIDENT
cfg = smoke_config(get_config(rs["config"])).replace(num_layers=rs["layers"], dtype="float32")
topo = topo_of(rs["mesh"], "serve_tp")
model = Model(cfg, topo)
params = model.init(jax.random.PRNGKey(2))
tokens = np.random.default_rng(301).integers(0, cfg.vocab_size, (rs["B"], rs["S"])).astype(np.int32)
with jax.set_mesh(topo.mesh):
    lg, cache = jax.jit(lambda p, t: model.prefill(p, {{"tokens": t}},
                                                   max_len=rs["S"] + rs["steps"]))(params, tokens)
    out["rs/logits0"] = np.asarray(lg)
    dec = jax.jit(model.decode_step)
    for i in range(rs["steps"]):
        nxt = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)[:, None]
        out[f"rs/next{{i}}"] = nxt
        lg, cache = dec(params, jnp.asarray(nxt), cache)
        out[f"rs/logits{{i + 1}}"] = np.asarray(lg)
out.update(flatten(np_tree(params), "rs/params/"))
out["rs/tokens"] = tokens
out["rs/ssm"] = np.asarray(cache["blocks"]["pos0"]["ssm"])
out["rs/conv_x"] = np.asarray(cache["blocks"]["pos0"]["conv_x"])

# -- ServingEngine under serve_seqp on (1, 4) ----------------------------------------
topo = topo_of((1, 4), "serve_seqp")
served = {{}}
for run in args["serve_runs"]:
    cfg = smoke_config(get_config(R.MOE)).replace(num_layers=run["layers"], dtype="float32")
    model = Model(cfg, topo)
    params = model.init(jax.random.PRNGKey(0))
    out.update(flatten(np_tree(params), "sv/params/"))
    eng = ServingEngine(model, params, max_batch=run["slots"], max_len=run["max_len"],
                        prefill_chunk=run["chunk"])
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=run["new"])
            for i, p in enumerate(run["prompts"])]
    for r in reqs:
        eng.submit(r)
    try:
        eng.run()
        served[run["name"]] = [[int(t) for t in r.generated] for r in reqs]
    except ValueError as e:
        served[run["name"]] = str(e)
out["served"] = np.asarray(json.dumps(served))
np.savez({out!r}, **out)
print("REF OK")
"""

# make_train_step under seqp and tp on (2, 2)
REFERENCE_B = """for name in {cases!r}:
    arch, policy, kw = R.STEP_CASES[name]
    topo = topo_of((2, 2), policy)
    cfg = smoke_config(get_config(arch)).replace(dtype="float32", **kw)
    model = Model(cfg, topo)
    batch = np_tree(make_dummy_batch(cfg, jax.random.PRNGKey(1), *R.STEP_BATCH))
    out.update(flatten(batch, f"st_{{name}}/batch/"))
    p = Model(cfg).init(jax.random.PRNGKey(0))
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
            out.update(flatten(np_tree(p), f"st_{{name}}/p{{i}}/"))
            out.update(flatten(np_tree(o), f"st_{{name}}/o{{i}}/"))
            mb = batch["tokens"].shape[0] // accum
            g = None
            for a in range(accum):
                micro = jax.device_put({{k: v[a * mb:(a + 1) * mb] for k, v in batch.items()}},
                                       sharding.named(sharding.batch_specs(
                                           {{k: v[:mb] for k, v in batch.items()}}, topo), topo))
                ga = jgrad(p, micro)
                g = ga if g is None else jax.tree.map(lambda u, v: u + v, g, ga)
            out.update(flatten(np_tree(jax.tree.map(lambda u: u / accum, g)),
                               f"st_{{name}}/g{{i}}/"))
            p, o, m = jstep(p, o, jax.device_put(batch, bspec))
            for k, v in m.items():
                out[f"st_{{name}}/m{{i}}/{{k}}"] = np.asarray(v)
        out.update(flatten(np_tree(p), f"st_{{name}}/p2/"))
np.savez({out!r}, **out)
print("REF OK")
"""


REFERENCE_PARTS = ((REFERENCE_A, None),
                   (REFERENCE_B, [n for n in ranks.STEP_CASES if n != "jamba tp"]),
                   (REFERENCE_B, ["jamba tp"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's arrays, the port's 4 ranks' results)."""
    tmp = tmp_path_factory.mktemp("seqp")
    paths = {k: str(tmp / k) for k in ("args.json", "ref.npz")}
    json.dump({"serve_runs": _serve_runs()}, open(paths["args.json"], "w"))
    procs, outs = [], []
    for part, cases in REFERENCE_PARTS:
        outs.append(str(tmp / f"ref_{len(outs)}.npz"))
        code = (REFERENCE_HEAD + part).format(src=SRC, tests=TESTS, args=paths["args.json"],
                                              out=outs[-1], cases=cases)
        procs.append(subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for proc in procs:  # the parts run side by side
        stdout, stderr = proc.communicate(timeout=400)
        assert proc.returncode == 0 and "REF OK" in stdout, stderr[-4000:]
    ref = {k: v for out in outs for k, v in np.load(out).items()}
    np.savez(paths["ref.npz"], **ref)
    port = tmesh.spawn_ranks((2, 2), ranks.seqp_module, paths["ref.npz"], _serve_runs(),
                             str(tmp / "ckpt"), policy="seqp", device="cpu", timeout_s=400)
    return ref, port


def _close(got, want, what, rel=1e-4):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rel * max(np.abs(want).max(), 1e-30), f"{what}: max |diff| {err}"


def _sub(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


def test_seqp_policies_build_the_reference_topologies(runs):
    """``make_topology(policy="seqp" | "serve_seqp")`` on (1, 4) and (2, 2):
    the batch axes, the model axis, FSDP and the flag, on every rank."""
    ref, port = runs
    want = json.loads(str(ref["topologies"]))
    assert len(want) == 4
    for r in port:
        assert {k: dict(v) for k, v in r["topologies"].items()} == want


def test_gather_rs_backward_sums_the_shares(runs):
    """The K/V gather's backward sums every rank's share of the gradient
    and hands this rank its chunk (a reduce-scatter); ``all_gather``'s
    chunk-only backward (a value every rank consumes alike) keeps only its
    own."""
    _, port = runs
    n = 4
    total = sum(q + 1 for q in range(n)) * np.arange(1, 2 * n + 1, dtype=np.float32)
    for r, res in enumerate(port):
        rs, plain = res["gather_rs"]
        np.testing.assert_array_equal(rs, total[2 * r : 2 * r + 2])
        np.testing.assert_array_equal(
            plain, (r + 1) * np.arange(1, 2 * n + 1, dtype=np.float32)[2 * r : 2 * r + 2])


@pytest.mark.parametrize("name", list(ranks.ATTN_CASES))
def test_seqp_attention_equals_the_reference(runs, name):
    """``_self_attention_seqp`` on each rank's rows and sequence slice: the
    output and the local K/V (the cache's), gathered whole, and under
    ``sum(o · ct)`` the input's gradient and the params' (each rank's
    share summed over the ranks) against ``jax.grad`` of the reference's
    on the same mesh.  The input's gradient reaches it through the other
    ranks' queries too, so a K/V gather whose backward drops their shares
    fails here."""
    ref, port = runs
    got = port[0]["attn"][name]
    pre = f"attn_{name}/"
    for r in port[1:]:
        np.testing.assert_array_equal(r["attn"][name]["o"], got["o"])
    _close(got["o"], ref[pre + "o"], f"{name} o", 1e-5)
    for k in ("k", "v", "dh"):
        _close(got[k], ref[pre + k], f"{name} {k}")
    want = _sub(ref, pre + "dp/")
    assert set(got["dp"]) == set(want)
    for k, v in want.items():
        _close(got["dp"][k], v, f"{name} d{k}")


MOE_RUNS = [(name, seq) for name, (_, nd, _) in ranks.MOE_CASES.items()
            for seq in ((False, True) if nd == 3 else (False,))]


@pytest.mark.parametrize("name,seq", MOE_RUNS,
                         ids=[f"{n}{' seq-sharded' if s else ''}" for n, s in MOE_RUNS])
def test_pre_sharded_moe_equals_the_reference(runs, name, seq):
    """``apply_moe`` under seqp at train capacity 1.25 (assignments drop)
    on each rank's batch shard, or with ``seq_sharded`` its slice of the
    sequence: the a2a body on pre-sharded tokens; y, aux_loss,
    ``dropped_frac`` and under ``sum(y · ct) + aux_loss`` the gradient of
    x and of every param leaf against ``jax.grad`` of the reference's on
    the same mesh."""
    ref, port = runs
    y, aux_loss, dropped, grads, bodies = port[0]["moe"][(name, seq)]
    pre = f"moe_{name}/"
    assert bodies == (1, 0), bodies
    for r in port[1:]:
        np.testing.assert_array_equal(r["moe"][(name, seq)][3]["x"], grads["x"])
    _close(y, ref[pre + "y"], f"{name} y", 1e-5)
    assert abs(aux_loss - float(ref[pre + "aux"])) <= 1e-6
    assert dropped == pytest.approx(float(ref[pre + "drop"]), abs=1e-6)
    assert dropped > 0, dropped
    want = _sub(ref, pre + "g/")
    assert set(grads) == set(want), (sorted(grads), sorted(want))
    for k, v in want.items():
        _close(grads[k], v, f"{name} d{k}")


@pytest.mark.parametrize("name", list(ranks.REFUSED))
def test_pre_sharded_shapes_the_reference_refuses(runs, name):
    """A pre-sharded 3-D input whose batch the data axes or whose sequence
    the model axis does not divide (a 4-slot decode under serve_seqp on
    (1, 4): S = 1 over 4 ranks): the reference's ``shard_map`` raises a
    ``ValueError``, and so does the port, on every rank."""
    ref, port = runs
    assert json.loads(str(ref["refused"]))[name] is not None
    for r in port:
        assert r["refused"][name] is not None and "divid" in r["refused"][name]


@pytest.mark.parametrize("name,local", [(n, lo) for n in ranks.SSM_CASES for lo in (False, True)],
                         ids=[f"{n}{' head slices' if lo else ''}" for n in ranks.SSM_CASES
                              for lo in (False, True)])
def test_head_sharded_ssm_equals_the_reference(runs, name, local):
    """``apply_ssm`` under tp on (2, 2), 8 heads, 4 a rank over the model
    axis of 2: from whole params and from this rank's head
    slices, the output, the final state and the conv tails, and under
    ``sum(out · ct)`` the gradients of x and of every param leaf against
    ``jax.grad`` of the reference's head-sharded branch."""
    ref, port = runs
    (out, fs, cx, cbc), grads = port[0]["ssm"][(name, local)]
    pre = f"ssm_{name}/"
    for what, got in (("out", out), ("fs", fs), ("cx", cx), ("cbc", cbc)):
        _close(got, ref[pre + what], f"{name} {what}")
    want = _sub(ref, pre + "g/")
    assert set(grads) == set(want), (sorted(grads), sorted(want))
    for k, v in want.items():
        _close(grads[k], v, f"{name} d{k}")


def _params_close(got, want, lr_steps):
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert diff.max() <= lr_steps, f"params {k}: max |diff| {diff.max()}"
        assert (diff > 1e-5 + 1e-5 * np.abs(w)).mean() <= 0.01, f"params {k}"


@pytest.mark.parametrize("name", list(ranks.STEP_CASES))
def test_train_step_equals_the_reference(runs, name):
    """Two steps of the mesh's ``make_train_step`` on (2, 2) against the
    reference's ``jit_train_step`` on the same mesh and policy: at the
    reference's params and optimizer state before each step every gradient
    leaf and the step's every metric, and the params after two steps taken
    from the same start.  qwen3-moe and llama4-scout smoke at 2
    layers under their own policy, seqp (sequence-parallel attention,
    pre-sharded a2a tokens); jamba and mamba2 smoke under tp (the
    head-sharded SSM)."""
    ref, port = runs
    steps_out, params = port[0]["steps"][name]
    for i, (grads, metrics, n) in enumerate(steps_out):
        assert n == i + 1
        flat = _sub(ref, f"st_{name}/g{i}/")
        assert set(grads) == set(flat) and flat
        for k, v in flat.items():
            _close(grads[k], v, f"{name} step {i} d{k}")
        mkeys = {k.split("/")[-1] for k in ref if k.startswith(f"st_{name}/m{i}/")}
        assert set(metrics) == mkeys, (sorted(metrics), sorted(mkeys))
        for key in mkeys:
            rel = 1e-5 if key in ("loss", "ce_loss", "grad_norm", "lr") else 1e-4
            _close(metrics[key], ref[f"st_{name}/m{i}/{key}"], f"{name} {key}", rel)
    _params_close(params, _sub(ref, f"st_{name}/p2/"), LR * 2)


def test_seqp_steps_gather_kv_and_reduce_scatter_back(runs):
    """The step cases' collectives (rank 0): the K/V gathers of the seqp
    cases' attention forward (and recomputation), their reduce-scatters in
    the backward."""
    counts = runs[1][0]["counts"]["all_gather_rs"]
    assert counts["calls"] > 0 and counts["bwd_calls"] > 0, counts
    assert counts["bytes"] > 0 and counts["bwd_bytes"] > 0, counts


def test_prefill_under_seqp_equals_the_reference(runs):
    """``Model.prefill`` of qwen3-moe smoke (2 layers) under seqp on (2, 2):
    the last position's logits and every cache leaf (each rank writes the
    whole ring) against the reference's; each layer's flash call runs this
    rank's S/ep queries at its offset against all S keys."""
    ref, port = runs
    for rank, r in enumerate(port):
        logits, cache, offsets = r["prefill"]
        _close(logits, ref["pf/logits"], "prefill logits")
        want = _sub(ref, "pf/cache/")
        assert set(cache) == set(want) and want
        for k, v in want.items():
            _close(cache[k], v, f"prefill cache {k}")
        S, ep = ranks.PREFILL["S"], ranks.PREFILL["mesh"][1]
        assert offsets == [(S // ep, S, (rank % ep) * S // ep)] * ranks.PREFILL["layers"]


def test_resident_ssm_weights_serve_as_the_reference(runs):
    """mamba2 smoke (2 layers) with resident weights on a (1, 4) serve_tp
    mesh: each rank holds its 2 of 8 heads (the bridge's head slices), its
    state and conv tail; ``Model.prefill`` and 3 decode steps' logits, and
    the rank's state and conv_x tail after them, against the reference's
    on the same mesh.  Saved by a mesh ``Checkpointer``, the slices come
    back whole in the file (the one-device format) and as the slices on
    restore."""
    ref, port = runs
    for rank, r in enumerate(port):
        logits, state, conv_x, w_z, (saved_whole, restored) = r["resident"]
        assert saved_whole and restored
        assert w_z == (2, 128, 64)
        for i, lg in enumerate(logits):
            _close(lg, ref[f"rs/logits{i}"], f"resident logits {i}")
        m = rank % 4
        _close(state, ref["rs/ssm"][:, :, 2 * m : 2 * m + 2], "resident state")
        _close(conv_x, ref["rs/conv_x"][..., 64 * m : 64 * m + 64], "resident conv_x")


@pytest.mark.parametrize("name", [run["name"] for run in _serve_runs()])
def test_serving_engine_under_serve_seqp(runs, name):
    """``ServingEngine`` on qwen3-moe smoke (2 layers) under serve_seqp on
    (1, 4): with 2 slots the prompts' 8-token chunks go through the a2a body
    on pre-sharded tokens and the 2-token decode through tp, and the
    tokens equal the reference's; with 4 slots a decode step's 4 tokens
    would pre-shard a sequence of 1 over 4 ranks, which the reference
    refuses (``ValueError``), and so does the port."""
    ref, port = runs
    want = json.loads(str(ref["served"]))[name]
    for r in port:
        got = r["serve"][name]
        if name == "4 slots":
            assert isinstance(want, str) and isinstance(got, str) and "divid" in got
            continue
        tokens, (a2a, tp), pages = got
        assert tokens == want and pages == 0
        assert a2a > 0 and tp > 0
