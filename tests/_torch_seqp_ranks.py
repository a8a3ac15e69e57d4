"""Rank-side halves of the port's sequence-parallelism tests
(``test_torch_seqp.py``): module-level functions that
``launch.mesh.spawn_ranks`` runs in each rank.  They import no JAX; the
reference's numbers reach them as an ``.npz`` and results leave as numpy."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from _torch_ep_ranks import flatten, unflatten
from _torch_mesh_ranks import OPT, _numpy
from repro_torch.bridge import blocks_from_numpy, params_from_numpy
from repro_torch.configs import CompressionConfig, get_config, smoke_config
from repro_torch.core import moe
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_topology
from repro_torch.models import attention as attn
from repro_torch.models import ssm, transformer
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt_mod

MOE = "qwen3-moe-235b-a22b"
MESHES = ((1, 4), (2, 2))
CODEC_RANK = 32
TRAIN_CF = 1.25  # the MoE cases' train capacity: assignments drop
# name -> (mesh, causal, sliding window): sequence-parallel attention
ATTN_CASES = {
    "causal (2,2)": ((2, 2), True, None),
    "causal (1,4)": ((1, 4), True, None),
    "not causal (2,2)": ((2, 2), False, None),
    "window 6 (1,4)": ((1, 4), True, 6),
}
ATTN_SHAPE = (4, 16)  # [B, S]
# name -> (mesh, x rank: 3 [B, S, d] or 2 [T, d], codec): apply_moe under seqp
MOE_CASES = {
    f"{mesh} {nd}-D{' codec' if codec else ''}": (mesh, nd, codec)
    for mesh in MESHES for nd in (3, 2) for codec in (False, True)
}
MOE_SHAPE = (8, 16)  # [B, S]; the 2-D cases take its B·S rows
# every token shares a direction (drawn from seed 99) at this scale, which
# skews the routing: each case drops assignments at TRAIN_CF
MOE_SKEW = 3.0
# name -> (mesh, policy, x shape): pre-sharded tokens the reference's body3d refuses
REFUSED = {
    "decode of 4 slots on (1,4)": ((1, 4), "serve_seqp", (4, 1)),
    "one row on (2,2)": ((2, 2), "seqp", (1, 8)),
}
SSM_CASES = {"jamba": "jamba-1.5-large-398b", "mamba2": "mamba2-130m"}
SSM_SHAPE = (4, 64)  # two SSD chunks
# name -> (config, policy, overrides): make_train_step on (2, 2)
STEP_CASES = {
    "qwen3-moe seqp": (MOE, "seqp", dict(num_layers=2)),
    "llama4-scout seqp": ("llama4-scout-17b-16e", "seqp", dict(num_layers=2)),
    "jamba tp": ("jamba-1.5-large-398b", "tp", {}),
    "mamba2 tp": ("mamba2-130m", "tp", dict(num_layers=2)),
}
STEP_BATCH = (8, 32)
PREFILL = dict(config=MOE, layers=2, mesh=(2, 2), B=2, S=16)
RESIDENT = dict(config="mamba2-130m", layers=2, mesh=(1, 4), B=2, S=8, steps=3)


def attn_config(window):
    return smoke_config(get_config(MOE)).replace(dtype="float32", sliding_window=window)


def moe_config(codec: bool):
    cfg = smoke_config(get_config(MOE)).replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=TRAIN_CF),
                       compression=(CompressionConfig(rank=CODEC_RANK, boundaries=("dispatch",))
                                    if codec else None))


def ssm_config(name):
    return smoke_config(get_config(SSM_CASES[name])).replace(dtype="float32")


def step_config(name):
    arch, _, kw = STEP_CASES[name]
    return smoke_config(get_config(arch)).replace(dtype="float32", **kw)


def _rows(x: torch.Tensor, topo) -> torch.Tensor:
    """This rank's rows of ``x`` along the data axes."""
    b = x.shape[0] // topo.dp_size
    return x[topo.data_index * b : (topo.data_index + 1) * b]


def _seq(x: torch.Tensor, topo) -> torch.Tensor:
    """This rank's slice of ``x``'s sequence (dim 1) along the model axis."""
    s = x.shape[1] // topo.ep_size
    return x[:, topo.model_index * s : (topo.model_index + 1) * s]


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return coll.all_gather(x.detach().movedim(dim, 0).contiguous(), group).movedim(0, dim)


def _whole(x: torch.Tensor, topo, seq: bool) -> np.ndarray:
    """A value of this rank's rows (and with ``seq`` its sequence slice)
    gathered whole."""
    if seq:
        x = _gather(x, 1, topo.model_group)
    if topo.dp_size > 1:
        x = _gather(x, 0, topo.data_group)
    return x.detach().numpy()


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def gather_rs_check(topo, device="cpu"):
    """``all_gather_rs`` against ``all_gather`` on the world, on ``device``:
    rank r sends [r, r] and weighs the gathered value by (r + 1) · [1 ..
    2n]; the gradient of its chunk is the sum of every rank's weights
    there, and ``all_gather``'s chunk-only backward keeps its own weights
    alone."""
    n, r = 4, topo.rank
    w = (r + 1) * torch.arange(1, 2 * n + 1, dtype=torch.float32, device=device)
    out = []
    for fn in (coll.all_gather_rs, coll.all_gather):
        x = torch.full((2,), float(r), device=device, requires_grad=True)
        (fn(x, topo.world_group) * w).sum().backward()
        out.append(x.grad.cpu().numpy())
    return out


def gather_rs_module(topo, device):
    """:func:`gather_rs_check` on this rank's device (the card test)."""
    return gather_rs_check(topo, device)


def attn_case(topos, data, name):
    """``_self_attention_seqp`` on this rank's rows and sequence slice
    under ``sum(o · ct)``: (o, local k, local v, the input's gradient,
    each gathered whole; the params' gradients summed over the world: each
    rank's is its share)."""
    mesh, causal, window = ATTN_CASES[name]
    topo = topos[(mesh, "seqp")]
    cfg = attn_config(window)
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in unflatten(data, f"attn_{name}/p/").items()}
    cut = lambda k: _seq(_rows(torch.from_numpy(data[f"attn_{name}/{k}"]), topo), topo)  # noqa: E731
    h = cut("h").clone().requires_grad_(True)
    o, (k, v) = transformer._self_attention_seqp(p, h, cfg, topo, cut("angles"), causal)
    (o * cut("ct")).sum().backward()
    grads = {kk: coll.psum(t.grad, topo.world_group).numpy() for kk, t in p.items()}
    return {"o": _whole(o, topo, True), "k": _whole(k, topo, True),
            "v": _whole(v, topo, True), "dh": _whole(h.grad, topo, True), "dp": grads}


def moe_case(topos, data, name, seq_sharded):
    """``apply_moe`` (train=True) under seqp on this rank's batch shard
    (with ``seq_sharded`` its slice of the sequence) under ``sum(y · ct) +
    aux_loss``: (y gathered, aux_loss, dropped_frac, {"x", "params/..."}:
    x's gradient gathered, the replicated params' summed over the data
    axes, the experts' summed over them and gathered over the model axis,
    a2a / tp body calls)."""
    mesh, nd, codec = MOE_CASES[name]
    topo = topos[(mesh, "seqp")]
    cfg = moe_config(codec)
    params = params_from_numpy(unflatten(data, f"mparams_{int(codec)}/"), "cpu", topo)
    for _, t in _leaves(params):
        t.requires_grad_(True)
    cut = lambda k: _rows(torch.from_numpy(data[f"moe_{name}/{k}"]), topo)  # noqa: E731
    x, ct = cut("x"), cut("ct")
    if seq_sharded:
        x, ct = _seq(x, topo), _seq(ct, topo)
    x = x.clone().requires_grad_(True)
    before = (moe._moe_a2a_body.calls, moe._moe_tp_body.calls)
    y, aux = moe.apply_moe(params, x, cfg, topo, train=True, seq_sharded=seq_sharded)
    ((y * ct).sum() + aux["aux_loss"]).backward()
    bodies = (moe._moe_a2a_body.calls - before[0], moe._moe_tp_body.calls - before[1])
    grads = {"x": _whole(x.grad, topo, seq_sharded)}
    for path, t in _leaves(params):
        g = coll.psum(t.grad, topo.data_group) if topo.dp_size > 1 else t.grad
        if path.split("/")[-1] in ("wi", "wg", "wo"):
            g = _gather(g, 0, topo.model_group)
        grads["params/" + path] = g.numpy()
    return (_whole(y, topo, seq_sharded), float(aux["aux_loss"]),
            float(aux["dropped_frac"]), grads, bodies)


def refused_case(topos, name):
    """The pre-sharded shapes the reference refuses: the ValueError's text,
    or None if the call went through."""
    mesh, policy, (B, S) = REFUSED[name]
    topo = topos[(mesh, policy)]
    cfg = moe_config(False)
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    params.update({k: params[k][topo.expert_slice(cfg.moe.num_experts)]
                   for k in ("wi", "wg", "wo") if k in params})
    try:
        with torch.no_grad():
            moe.apply_moe(params, torch.zeros(B, S, cfg.d_model), cfg, topo, train=False)
    except ValueError as e:
        return str(e)
    return None


def ssm_case(topo, data, name, local):
    """``apply_ssm`` head-sharded on this rank's batch shard under
    ``sum(out · ct)``, from whole params or (``local``) this rank's head
    slices: (out, final state, conv_x tail, conv_bc tail, {"x", "params/k"}),
    each whole: gathered over the data axes, and over the model axis where
    it holds this rank's heads; the params' gradients summed over the data
    axes."""
    cfg = ssm_config(name)
    whole = {k: torch.from_numpy(v) for k, v in unflatten(data, f"ssm_{name}/p/").items()}
    if local:
        whole = ssm.resident_slices(whole, dataclasses.replace(topo, fsdp=False))
    p = {k: v.clone().requires_grad_(True) for k, v in whole.items()}
    x = _rows(torch.from_numpy(data[f"ssm_{name}/x"]), topo).clone().requires_grad_(True)
    ct = _rows(torch.from_numpy(data[f"ssm_{name}/ct"]), topo)
    out, (fs, (cx, cbc)) = ssm.apply_ssm(p, x, cfg, topo=topo, return_state=True, train=True)
    (out * ct).sum().backward()
    heads = lambda t, dim: _gather(t, dim, topo.model_group) if local else t  # noqa: E731
    res = [_whole(out, topo, False), _whole(heads(fs, 1), topo, False),
           _whole(heads(cx, -1), topo, False), _whole(cbc, topo, False)]
    grads = {"x": _whole(x.grad, topo, False)}
    for k, t in p.items():
        g = coll.psum(t.grad, topo.data_group) if topo.dp_size > 1 else t.grad
        if local and k in ssm.HEAD_LEAVES:
            g = _gather(g, ssm.HEAD_LEAVES[k], topo.model_group)
        grads["params/" + k] = g.numpy()
    return res, grads


def step_case(topo, data, name, n_steps):
    """``n_steps`` of the mesh's ``make_train_step``: at the reference's
    params and optimizer state of each step, the gradients (gathered whole)
    and the step's metrics; from its first, ``n_steps`` steps, and the
    params gathered after them.  (Adafactor turns a near-zero gradient
    element's rounding into an update of up to lr, so a run's later
    metrics carry its params' drift; the params are held to lr a step.)"""
    cfg = step_config(name)
    model = Model(cfg, "cpu", topo)
    p0 = unflatten(data, f"st_{name}/p0/")
    pspecs, ospecs = sharding.train_specs(p0, cfg.optimizer, topo)
    params = blocks_from_numpy(p0, pspecs, topo, "cpu")
    shards = sharding.leaf_shards(params, pspecs, topo)
    state = opt_mod.init_optimizer(cfg.optimizer, params, shards)
    step = steps.make_train_step(model, opt_mod.OptimizerConfig(name=cfg.optimizer, **OPT),
                                 pspecs)
    batch = {k: torch.from_numpy(v) for k, v in unflatten(data, f"st_{name}/batch/").items()}
    out = []
    for i in range(n_steps):
        here = blocks_from_numpy(unflatten(data, f"st_{name}/p{i}/"), pspecs, topo, "cpu")
        _, g = step.grads(here, batch)
        g = sharding.gather_tree(g, pspecs, topo)
        here_state = blocks_from_numpy(unflatten(data, f"st_{name}/o{i}/"), ospecs, topo, "cpu")
        here_state["step"] = here_state["step"].to(state["step"].dtype)
        _, here_state, metrics = step(here, here_state, batch)
        out.append((flatten(_numpy(g)),
                    {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v)
                     for k, v in metrics.items()}, int(here_state["step"])))
    for _ in range(n_steps):
        params, state, _ = step(params, state, batch)
    return out, flatten(_numpy(sharding.gather_tree(params, pspecs, topo)))


def prefill_case(topo, data):
    """``Model.prefill`` under seqp: (last logits, every cache leaf, the
    flash calls' query offsets)."""
    cfg = smoke_config(get_config(PREFILL["config"])).replace(
        num_layers=PREFILL["layers"], dtype="float32")
    params = params_from_numpy(unflatten(data, "pf/params/"), "cpu", topo)
    offsets = []
    inner = attn.flash_attention

    def spy(q, k, v, **kw):
        offsets.append((q.shape[1], k.shape[1], kw.get("q_offset", 0)))
        return inner(q, k, v, **kw)

    attn.flash_attention = spy
    try:
        with torch.no_grad():
            logits, cache = Model(cfg, "cpu", topo).prefill(
                params, {"tokens": torch.from_numpy(data["pf/tokens"])})
    finally:
        attn.flash_attention = inner
    return logits.numpy(), flatten(_numpy(cache["blocks"])), offsets


def resident_checkpoint(topo, data, params, ckpt):
    """The resident head slices through a mesh ``Checkpointer`` (specs by
    ``sharding.resident_specs`` of the whole shapes): (the file holds every
    leaf whole, equal to the reference's params; the restore hands this
    rank its slices back)."""
    import os

    from repro_torch.checkpoint.checkpointer import Checkpointer

    whole = unflatten(data, "rs/params/")
    specs = sharding.resident_specs(whole, topo)
    ck = Checkpointer(ckpt, topo=topo)
    ck.save(1, params, specs=specs)
    with np.load(os.path.join(ckpt, "step_00000001", "arrays.npz")) as z:
        same = sorted(z.files) == sorted(flatten(whole)) and all(
            np.array_equal(z[k], v) for k, v in flatten(whole).items())
    _, back = ck.restore(params, specs=specs)
    back_same = all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(back), _leaves(params)))
    return same, back_same


def resident_case(topo, data, ckpt):
    """mamba2 smoke on a ``serve_tp`` mesh with resident weights (this
    rank's head slices, from the bridge): ``Model.prefill`` then decode
    steps fed the reference's tokens: (every step's logits, this rank's
    SSM state and conv_x tail after the last, the head leaves' shapes, the
    checkpoint round trip of :func:`resident_checkpoint` into ``ckpt``)."""
    cfg = smoke_config(get_config(RESIDENT["config"])).replace(
        num_layers=RESIDENT["layers"], dtype="float32")
    params = params_from_numpy(unflatten(data, "rs/params/"), "cpu", topo)
    model = Model(cfg, "cpu", topo)
    logits = []
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": torch.from_numpy(data["rs/tokens"])},
                                  max_len=RESIDENT["S"] + RESIDENT["steps"])
        logits.append(lg.numpy())
        for i in range(RESIDENT["steps"]):
            lg, cache = model.decode_step(params, torch.from_numpy(data[f"rs/next{i}"]), cache)
            logits.append(lg.numpy())
    entry = cache["blocks"]["pos0"]
    return (logits, entry["ssm"].numpy(), entry["conv_x"].numpy(),
            tuple(params["blocks"]["pos0"]["ssm"]["w_z"].shape),
            resident_checkpoint(topo, data, params, ckpt))


def serve_case(topo, data, run):
    """``ServingEngine`` under serve_seqp with the reference's weights and
    requests: (tokens, (a2a, tp) body calls, pages left), or the
    ``ValueError``'s text where the run is refused."""
    from repro_torch.serving import Request, ServingEngine

    cfg = smoke_config(get_config(MOE)).replace(num_layers=run["layers"], dtype="float32")
    params = params_from_numpy(unflatten(data, "sv/params/"), "cpu", topo)
    eng = ServingEngine(Model(cfg, "cpu", topo), params, max_batch=run["slots"],
                        max_len=run["max_len"], prefill_chunk=run["chunk"])
    reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=run["new"])
            for i, p in enumerate(run["prompts"])]
    for r in reqs:
        eng.submit(r)
    before = (moe._moe_a2a_body.calls, moe._moe_tp_body.calls)
    try:
        eng.run()
    except ValueError as e:
        return str(e)
    return ([list(r.generated) for r in reqs],
            (moe._moe_a2a_body.calls - before[0], moe._moe_tp_body.calls - before[1]),
            eng.pool.pages_in_use)


def seqp_module(topo, device, data_path, serve_runs, ckpt):
    """Every case on 4 ranks (``topo``: (2, 2) under seqp): the policies'
    topologies, the collective, attention, the MoE cases and refusals, the
    head-sharded SSM, the train steps, prefill, resident SSM serving and
    the engine."""
    data = dict(np.load(data_path))
    topos = {}
    for policy in ("seqp", "serve_seqp", "tp", "serve_tp"):
        for mesh in MESHES:
            topos[(mesh, policy)] = make_topology(mesh, policy=policy)
    out = {"topologies": {f"{p} {m}": dict(
        data_axes=list(t.data_axes), model_axis=t.model_axis, fsdp=t.fsdp,
        seq_parallel_attn=t.seq_parallel_attn, dp=t.dp_size, ep=t.ep_size)
        for (m, p), t in topos.items() if p.endswith("seqp")}}
    out["gather_rs"] = gather_rs_check(topo)
    out["attn"] = {name: attn_case(topos, data, name) for name in ATTN_CASES}
    out["moe"] = {(name, seq): moe_case(topos, data, name, seq)
                  for name, (_, nd, _) in MOE_CASES.items()
                  for seq in ((False, True) if nd == 3 else (False,))}
    out["refused"] = {name: refused_case(topos, name) for name in REFUSED}
    out["ssm"] = {(name, local): ssm_case(topos[((2, 2), "tp")], data, name, local)
                  for name in SSM_CASES for local in (False, True)}
    coll.reset_counts()
    out["steps"] = {name: step_case(topos[((2, 2), policy)], data, name, 2)
                    for name, (_, policy, _) in STEP_CASES.items()}
    out["counts"] = coll.counts()
    out["prefill"] = prefill_case(topos[(PREFILL["mesh"], "seqp")], data)
    out["resident"] = resident_case(topos[(RESIDENT["mesh"], "serve_tp")], data, ckpt)
    out["serve"] = {run["name"]: serve_case(topos[((1, 4), "serve_seqp")], data, run)
                    for run in serve_runs}
    return out
