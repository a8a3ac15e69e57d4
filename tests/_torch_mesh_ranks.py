"""Rank-side halves of the port's training-on-a-mesh tests
(``test_torch_train_mesh.py``): module-level functions that
``launch.mesh.spawn_ranks`` runs in each rank.  They import no JAX; the
reference's numbers reach them as an ``.npz`` and results leave as numpy."""

from __future__ import annotations

import dataclasses
import itertools
import shutil

import numpy as np
import torch

from _torch_ep_ranks import flatten, unflatten
from repro_torch.bridge import blocks_from_numpy, params_from_numpy
from repro_torch.configs import CompressionConfig, get_config, smoke_config
from repro_torch.core import moe
from repro_torch.data import pipeline
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.distributed.fault import elastic_topology
from repro_torch.distributed.loss import sharded_cross_entropy
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_topology
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.trainer import Trainer, TrainerConfig

MOE = "qwen3-moe-235b-a22b"  # the reference's own EP config at smoke width
CODEC_RANK = 64
OPT = dict(lr=1e-3, warmup_steps=1, decay_steps=100)
# name -> (config, overrides): the train-step cases
STEP_CASES = {
    "switch-base adamw": ("switch-base", dict(num_layers=4)),
    "qwen3-moe adafactor grad_accum=2 codec": (MOE, dict(num_layers=1)),
}
TRAIN_MESH = (2, 2)
DATA = dict(task="lm", vocab_size=512, seq_len=32)
TRAINER_BATCH = 8


def moe_config(case):
    """The MoE layer's config of one gradient case (the reference builds
    the same)."""
    cfg = smoke_config(get_config(MOE)).replace(dtype="float32")
    return cfg.replace(
        moe_impl=case["impl"],
        moe=dataclasses.replace(cfg.moe, capacity_factor=case["cf"]),
        compression=(CompressionConfig(rank=CODEC_RANK, boundaries=("dispatch",))
                     if case["codec"] else None),
    )


def step_config(name):
    """A train-step case's config: smoke width, f32."""
    arch, kw = STEP_CASES[name]
    return smoke_config(get_config(arch)).replace(dtype="float32", **kw)


def trainer_config():
    """The reference's elastic-test config: qwen3-moe smoke at 1 layer, f32."""
    return smoke_config(get_config(MOE)).replace(num_layers=1, dtype="float32")


def _block(x: torch.Tensor, topo) -> torch.Tensor:
    """This rank's rows of ``x`` along the data axes."""
    b = x.shape[0] // topo.dp_size
    return x[topo.data_index * b : (topo.data_index + 1) * b]


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.detach().float().cpu().numpy()
            for k, v in tree.items()}


def ce_case(topo, data):
    """The vocabulary-sharded cross-entropy on this rank's batch rows and
    vocabulary slice: (loss, its gradient's block gathered whole)."""
    logits = torch.from_numpy(data["ce_logits"])
    labels = torch.from_numpy(data["ce_labels"])
    V = logits.shape[-1] // topo.ep_size
    lo = topo.model_index * V
    mine = _block(logits, topo)[..., lo : lo + V].clone().requires_grad_(True)
    loss, metrics = sharded_cross_entropy(mine, _block(labels, topo), topo)
    loss.backward()
    g = coll.all_gather(mine.grad.movedim(-1, 0).contiguous(), topo.model_group).movedim(0, -1)
    g = coll.all_gather(g.contiguous(), topo.data_group)
    return float(loss), float(metrics["tokens"]), g.numpy()


def moe_grad_case(topo, data, case):
    """``apply_moe``'s gradients on this rank under the cotangent ``ct``
    plus ``aux_loss``: (y gathered, aux_loss, {"x", "params/..."} gathered:
    x over the data axes, the replicated params summed over them, the
    experts summed over them and gathered over the model axis)."""
    cfg = moe_config(case)
    full = unflatten(data, f"mparams_{int(case['codec'])}/")
    params = params_from_numpy(full, "cpu", topo)
    leaves = opt_mod.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    x = _block(torch.from_numpy(data["mx_" + case["name"]]), topo).clone().requires_grad_(True)
    ct = _block(torch.from_numpy(data["mct_" + case["name"]]), topo)
    before = (moe._moe_a2a_body.calls, moe._moe_tp_body.calls)
    y, aux = moe.apply_moe(params, x, cfg, topo, train=True)
    ((y * ct).sum() + aux["aux_loss"]).backward()
    bodies = (moe._moe_a2a_body.calls - before[0], moe._moe_tp_body.calls - before[1])
    with torch.no_grad():
        grads = {"x": coll.all_gather(x.grad, topo.data_group)}

        def reduce(k, t):
            g = coll.psum(t.grad, topo.data_group) if topo.dp_size > 1 else t.grad
            if k in ("wi", "wg", "wo"):
                g = coll.all_gather(g, topo.model_group)
            return g

        for k, v in params.items():
            if isinstance(v, dict):
                for kk, t in v.items():
                    grads[f"params/{k}/{kk}"] = reduce(kk, t)
            else:
                grads[f"params/{k}"] = reduce(k, v)
        y = coll.all_gather(y, topo.data_group) if topo.dp_size > 1 else y
    return (y.detach().numpy(), float(aux["aux_loss"]), float(aux["dropped_frac"]),
            {k: v.numpy() for k, v in grads.items()}, bodies)


def step_case(topo, data, name, n_steps):
    """``n_steps`` of the mesh's ``make_train_step`` from the reference's
    initial params on its batch: before each step the gradients (gathered
    whole) at the reference's params of that step, after it the metrics;
    the params gathered after the last."""
    cfg = step_config(name)
    model = Model(cfg, "cpu", topo)
    p0 = unflatten(data, f"tp_{name}/p0/")
    pspecs, ospecs = sharding.train_specs(p0, cfg.optimizer, topo)
    params = blocks_from_numpy(p0, pspecs, topo, "cpu")
    shards = sharding.leaf_shards(params, pspecs, topo)
    state = opt_mod.init_optimizer(cfg.optimizer, params, shards)
    step = steps.make_train_step(model, opt_mod.OptimizerConfig(name=cfg.optimizer, **OPT),
                                 pspecs)
    batch = {k: torch.from_numpy(v) for k, v in unflatten(data, f"tp_{name}/batch/").items()}
    out = []
    for i in range(n_steps):
        here = blocks_from_numpy(unflatten(data, f"tp_{name}/p{i}/"), pspecs, topo, "cpu")
        _, g = step.grads(here, batch)
        g = sharding.gather_tree(g, pspecs, topo)
        params, state, metrics = step(params, state, batch)
        out.append((flatten(_numpy(g)),
                    {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v)
                     for k, v in metrics.items()}, int(state["step"])))
    return out, flatten(_numpy(sharding.gather_tree(params, pspecs, topo)))


def trainer_data(skip=0, mod=pipeline):
    """The trainers' batches from ``mod``'s data pipeline (the port's, or
    the reference's, which gives the same), the first ``skip`` left out (a
    resumed run goes on where the checkpointed one stopped)."""
    it = itertools.cycle(mod.batches(mod.DataConfig(**DATA), TRAINER_BATCH, 30))
    return itertools.islice(it, skip, None)


def trainer_22(topo, data, ckpt, copy):
    """``Trainer`` for 3 steps on this mesh from the reference's state after
    ``initialize()``, checkpointed at step 3 into ``ckpt``; rank 0 then
    copies the checkpoints to ``copy`` (the one-device resume's)."""
    tc = TrainerConfig(total_steps=3, checkpoint_every=3, checkpoint_dir=ckpt,
                       async_checkpoint=False, log_every=1)
    tr = Trainer(trainer_config(), trainer_data(), topo=topo, trainer_cfg=tc, device="cpu").initialize()
    tr.load_state(*(params_from_numpy(unflatten(data, f"tr/{k}/"), "cpu")
                     for k in ("params", "opt")))
    log = tr.run()["log"]
    if topo.rank == 0:
        shutil.copytree(ckpt, copy)
    coll.barrier(topo.world_group)
    return log


def pipeline_check(topo):
    """A (2, 1, 2) mesh over ("pipe", "data", "model") with the pipeline
    axis declared: (pp, dp, ep, the rank's mean over its data and model
    group, its mean over the world)."""
    t = make_topology((2, 1, 2), ("pipe", "data", "model"), pipeline_axis="pipe")
    x = torch.tensor([float(topo.rank)])
    return (t.pp_size, t.dp_size, t.ep_size, float(coll.pmean(x, t.data_model_group)),
            float(coll.pmean(x, t.world_group)))


def train_mesh_module(topo, device, data_path, moe_cases, ckpt, copy):
    """Every case of the first spawn (4 ranks): the loss on (2, 2), the MoE
    gradient cases on their meshes, the train-step cases and the
    ``Trainer`` on (2, 2)."""
    data = dict(np.load(data_path))
    topos = {topo.mesh_shape: topo}
    out = {"ce": ce_case(topo, data), "pipe": pipeline_check(topo), "moe": {}, "steps": {}}
    for case in moe_cases:
        mesh = tuple(case["mesh"])
        if mesh not in topos:
            topos[mesh] = make_topology(mesh, policy="tp")
        out["moe"][case["name"]] = moe_grad_case(topos[mesh], data, case)
    coll.reset_counts()
    for name in STEP_CASES:
        out["steps"][name] = step_case(topo, data, name, 2)
    out["counts"] = coll.counts()
    out["trainer"] = trainer_22(topo, data, ckpt, copy)
    return out


def elastic_resume(topo, device, ckpt):
    """The second spawn (2 ranks): ``Trainer`` on ``elastic_topology(2,
    model_axis_size=2)`` resumes ``ckpt``'s step 3 and trains to step 5.
    Returns (its mesh, the step it resumed at, the log)."""
    t = elastic_topology(2, model_axis_size=2)
    tc = TrainerConfig(total_steps=5, checkpoint_every=5, checkpoint_dir=ckpt,
                       async_checkpoint=False, log_every=1)
    tr = Trainer(trainer_config(), trainer_data(3), topo=t, trainer_cfg=tc, device="cpu").initialize()
    resumed = tr.step
    out = tr.run()
    return t.mesh_shape, resumed, out["final_step"], out["log"]



def one_process_steps(cfg, device, batch, n_steps, seed=0, topo=None):
    """``n_steps`` of ``make_train_step`` from params drawn once by
    ``seed`` on the CPU, on ``device``; on a mesh ``topo`` this rank's
    blocks of them.  Returns ([(loss, grad_norm, dropped_frac)] a step,
    the params whole after the last, as numpy)."""
    from repro_torch.models.model import to_device

    model = Model(cfg, device, topo) if topo is not None else Model(cfg, device)
    full = Model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    specs = None
    if topo is not None:
        specs = sharding.train_specs(full, cfg.optimizer, topo)[0]
        full = sharding.shard_tree(full, specs, topo)
    params = to_device(full, device)
    shards = sharding.leaf_shards(params, specs, topo) if topo is not None else None
    state = opt_mod.init_optimizer(cfg.optimizer, params, shards)
    step = steps.make_train_step(model, opt_mod.OptimizerConfig(name=cfg.optimizer, **OPT), specs)
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out = []
    for _ in range(n_steps):
        params, state, m = step(params, state, b)
        out.append((float(m["loss"]), float(m["grad_norm"]), float(m.get("dropped_frac", 0.0))))
    if topo is not None:
        params = sharding.gather_tree(params, specs, topo)
    return out, flatten(_numpy(params))


def mesh_steps(topo, device, cfg, batch, n_steps):
    """:func:`one_process_steps` on this rank of a mesh."""
    return one_process_steps(cfg, device, batch, n_steps, topo=topo)
