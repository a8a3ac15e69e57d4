"""Rank-side halves of the port's expert-parallel tests: module-level
functions that ``launch.mesh.spawn_ranks`` runs in each rank.  They import
no JAX (the ranks import this module, not the test files, and the card's
test file imports it too); the reference's numbers reach them as ``.npz``
files and leave as numpy."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import CompressionConfig, get_config, smoke_config
from repro_torch.core import moe
from repro_torch.distributed import collectives as coll
from repro_torch.launch.mesh import make_topology

# qwen3-moe smoke, the reference's own EP config (tests/test_distributed.py):
# 8 experts in 4 groups, top-2, d 128; its dispatch codec at rank 64
NAME = "qwen3-moe-235b-a22b"
CODEC_RANK = 64


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def case_config(case):
    """The port's config of one case (the reference builds the same)."""
    cfg = smoke_config(get_config(NAME))
    cfg = cfg.replace(
        moe_impl=case["impl"],
        moe=dataclasses.replace(cfg.moe, capacity_factor=case["cf"]),
        compression=(CompressionConfig(rank=CODEC_RANK, boundaries=("dispatch",))
                     if case["codec"] else None),
    )
    return cfg


def moe_cases(topo, device, data_path, cases):
    """Every case's ``apply_moe`` on this rank: the topology of the case's
    mesh (made on the world of ranks in the order of ``cases``, the same on
    every rank), the reference's params with this rank's expert slices,
    the same ``x``: whole for serving; for training this rank's data shard
    (the training stack carries it; whole when ``dp`` does not divide the
    tokens), its output gathered over the data axes.  Returns {case: (y,
    aux, bodies run)}; the train-mode forward runs under ``no_grad``."""
    data = dict(np.load(data_path))
    topos = {topo.mesh_shape: topo}
    out = {}
    for case in cases:
        mesh = tuple(case["mesh"])
        if mesh not in topos:
            topos[mesh] = make_topology(mesh, policy="tp")
        t = topos[mesh]
        cfg = case_config(case)
        params = params_from_numpy(unflatten(data, f"params_{int(case['codec'])}/"), device, t)
        x = torch.from_numpy(data[f"x_{case['name']}"]).to(device)
        mask = data.get(f"mask_{case['name']}")
        mask = None if mask is None else torch.from_numpy(mask).to(device)
        before = (moe._moe_a2a_body.calls, moe._moe_tp_body.calls)
        shard = case["train"] and x.shape[0] % t.dp_size == 0 and t.dp_size > 1
        if shard:
            b = x.shape[0] // t.dp_size
            x = x[t.data_index * b : (t.data_index + 1) * b]
        with torch.no_grad():
            y, aux = moe.apply_moe(params, x, cfg, t, expert_mask=mask, train=case["train"])
            if shard:
                y = coll.all_gather(y, t.data_group)
        bodies = (moe._moe_a2a_body.calls - before[0], moe._moe_tp_body.calls - before[1])
        out[case["name"]] = (y.cpu().numpy(), {k: v.cpu().numpy() for k, v in aux.items()},
                             bodies)
    return out


def collectives_check(topo, device):
    """The collectives on this rank's ``device`` against their definitions:
    (all_to_all, all_gather, psum, pmean) results and the counters."""
    coll.reset_counts()
    r, n = topo.rank, topo.num_devices
    x = torch.arange(2 * n, dtype=torch.float32, device=device) + 100 * r
    a2a = coll.all_to_all(x, topo.world_group)
    ag = coll.all_gather(x[:2], topo.world_group)
    ps = coll.psum(x.to(torch.bfloat16), topo.world_group)
    pm = coll.pmean(x, topo.world_group)
    return ([t.cpu().float().numpy() for t in (a2a, ag, ps, pm)], coll.counts(),
            str(ps.dtype), str(a2a.device.type))


def ep_module(topo, device, data_path, cases):
    """The collectives' check, then every MoE case (one spawn a module)."""
    return {"coll": collectives_check(topo, device),
            "moe": moe_cases(topo, device, data_path, cases)}


def fail_on_rank_two(topo, device):
    if topo.rank == 2:
        raise RuntimeError("rank two fails")
    return topo.rank


def serve_runs(topo, device, data_path, runs):
    """``ServingEngine`` on this rank for each run: the reference's params
    (this rank's experts), its requests, f32.  Returns {run: (tokens,
    (a2a calls, tp calls), pages left in use, collective calls)}."""
    from repro_torch.models.model import Model
    from repro_torch.serving import Request, ServingEngine

    data = dict(np.load(data_path))
    out = {}
    for run in runs:
        cfg = smoke_config(get_config(run["config"])).replace(
            num_layers=run["layers"], dtype="float32")
        params = params_from_numpy(unflatten(data, f"params_{run['config']}/"), device, topo)
        eng = ServingEngine(Model(cfg, device, topo), params, max_batch=run["slots"],
                            max_len=run["max_len"], prefill_chunk=run["chunk"])
        reqs = [Request(i, np.asarray(p, np.int32), max_new_tokens=run["new"])
                for i, p in enumerate(run["prompts"])]
        for r in reqs:
            eng.submit(r)
        before = (moe._moe_a2a_body.calls, moe._moe_tp_body.calls)
        coll.reset_counts()
        eng.run()
        out[run["name"]] = (
            [r.generated for r in reqs],
            (moe._moe_a2a_body.calls - before[0], moe._moe_tp_body.calls - before[1]),
            eng.pool.pages_in_use,
            {k: v["calls"] for k, v in coll.counts().items()},
        )
    return out
