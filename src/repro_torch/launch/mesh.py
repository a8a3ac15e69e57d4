"""Meshes of ranks (port of the reference's ``launch/mesh.py``) and the
port's rank launcher.

The reference builds a JAX ``Mesh`` over the devices of one process; the
port runs one process a rank (SPMD) and joins them with ``torch.distributed``.
:func:`make_topology` turns a mesh shape and a policy into a
:class:`~repro_torch.distributed.topology.Topology` with this rank's
coordinates and the process groups of its axes; :func:`spawn_ranks` starts
the ranks, runs a function on each and gathers what they return.

Ranks lie on the mesh in row-major order.  The backend follows from the
devices (:func:`backend_for`): gloo on the CPU, nccl when each rank has a
card of its own, and gloo over CUDA tensors when several ranks share a card
(nccl refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import DEFAULT_DEVICE
from repro_torch.distributed.topology import Topology

POLICIES = ("tp", "serve_tp", "dp", "fsdp", "seqp", "serve_seqp")


def _axis_groups(shape: Tuple[int, ...], keep: Sequence[int], rank: int):
    """Create the process groups of the ranks that differ only along the
    axes ``keep`` (one group for every setting of the other axes; every
    rank creates all of them, in the same order) and return this rank's."""
    mine = None
    others = [i for i in range(len(shape)) if i not in keep]
    for fixed in itertools.product(*(range(shape[i]) for i in others)):
        ranks = []
        for free in itertools.product(*(range(shape[i]) for i in keep)):
            coords = [0] * len(shape)
            for i, c in zip(others, fixed):
                coords[i] = c
            for i, c in zip(keep, free):
                coords[i] = c
            ranks.append(_ravel(coords, shape))
        group = dist.new_group(sorted(ranks))
        if rank in ranks:
            mine = group
    return mine


def _ravel(coords: Sequence[int], shape: Sequence[int]) -> int:
    idx = 0
    for c, n in zip(coords, shape):
        idx = idx * n + c
    return idx


def _unravel(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def policy_layout(policy: str, axes: Sequence[str] = ("data", "model"),
                  pipeline_axis: Optional[str] = None) -> dict:
    """The :class:`Topology` fields a mesh policy sets over ``axes``:
    ``data_axes``, ``model_axis``, ``fsdp`` and ``seq_parallel_attn`` (the
    reference's ``make_topology``).

    ``"tp"``: the ``pod``/``data`` axes carry the batch, ``model`` is the
    TP / EP axis; ``"serve_tp"``: the same with weights resident (no FSDP);
    ``"dp"``: every axis a batch axis, params replicated; ``"fsdp"``: every
    axis a batch axis (ZeRO-3, no TP); ``"seqp"``: the model axis holds the
    experts and shards the residual stream's sequence, non-expert weights
    replicated over it (FSDP over the data axes); ``"serve_seqp"``: the same
    with weights resident.  ``pipeline_axis`` names an axis that is
    neither."""
    if policy not in POLICIES:
        raise ValueError(f"unknown mesh policy {policy!r} (one of {POLICIES})")
    axes = tuple(axes)
    if pipeline_axis is not None and pipeline_axis not in axes:
        raise ValueError(f"pipeline axis {pipeline_axis!r} is not one of {axes}")
    free = tuple(a for a in axes if a != pipeline_axis)
    if policy in ("dp", "fsdp"):
        return dict(data_axes=free, model_axis=None, fsdp=policy == "fsdp",
                    seq_parallel_attn=False)
    if "model" not in axes:
        raise ValueError(f"policy {policy!r} needs a 'model' axis, got {axes}")
    return dict(data_axes=tuple(a for a in free if a in ("pod", "data")), model_axis="model",
                fsdp=policy in ("tp", "seqp"), seq_parallel_attn=policy.endswith("seqp"))


def make_topology(shape: Sequence[int], axes: Sequence[str] = ("data", "model"), *,
                  policy: str = "tp", pipeline_axis: Optional[str] = None) -> Topology:
    """This rank's topology on a mesh of ``shape`` over ``axes`` under
    ``policy`` (:func:`policy_layout`; the process group must be
    initialised with ``prod(shape)`` ranks).  A pipeline axis's ranks are
    replicas: the reference declares one and shards nothing along it."""
    layout = policy_layout(policy, axes, pipeline_axis)
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh {shape} vs axes {axes}")
    world = math.prod(shape)
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {shape} needs {world} ranks, the group has "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    data_axes, model_axis = layout["data_axes"], layout["model_axis"]
    model_group = None
    if model_axis is not None:
        model_group = _axis_groups(shape, [axes.index(model_axis)], rank)
    data_group = _axis_groups(shape, [axes.index(a) for a in data_axes], rank)
    dm = data_axes + ((model_axis,) if model_axis else ())
    data_model_group = (dist.group.WORLD if len(dm) == len(axes)
                        else _axis_groups(shape, [axes.index(a) for a in dm], rank))
    return Topology(
        mesh_shape=shape, axis_names=axes, pipeline_axis=pipeline_axis, **layout,
        coords=_unravel(rank, shape), world_group=dist.group.WORLD, model_group=model_group,
        data_group=data_group, data_model_group=data_model_group,
    )


def backend_for(n_ranks: int, device: str) -> Tuple[str, List[torch.device]]:
    """(backend, each rank's device) for ``n_ranks`` ranks on ``device``
    ("cpu" or "cuda"): gloo on the CPU; on cards nccl when there is a card
    a rank, else gloo over CUDA tensors, the ranks dealt round the cards."""
    if device == "cpu":
        return "gloo", [torch.device("cpu")] * n_ranks
    if device != "cuda":
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("spawn_ranks(device='cuda'): no CUDA device")
    devices = [torch.device("cuda", r % cards) for r in range(n_ranks)]
    return ("nccl" if n_ranks <= cards else "gloo"), devices


def _rank_main(rank, world, store, backend, devices, shape, axes, policy, timeout_s,
               fn, args, results):
    dev = devices[rank]
    if dev.type == "cpu":
        torch.set_num_threads(1)  # several ranks share the host's cores
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        topo = make_topology(shape, axes, policy=policy)
        results.put((rank, fn(topo, dev, *args)))
    finally:
        dist.destroy_process_group()


def spawn_ranks(shape: Sequence[int], fn: Callable[..., Any], *args,
                axes: Sequence[str] = ("data", "model"), policy: str = "serve_tp",
                device: str = DEFAULT_DEVICE, timeout_s: float = 300.0) -> List[Any]:
    """Run ``fn(topo, device, *args)`` on ``prod(shape)`` spawned ranks (one
    process each) and return the ranks' return values in rank order.

    ``fn`` must be importable by name (a module-level function) and return
    something picklable.  The ranks run on the card unless ``device`` is
    "cpu".  The process group's timeout is ``timeout_s``
    (a collective that waits longer raises in its rank), and the whole run
    must end within it: a rank that raises, or a run past the deadline,
    stops every rank and raises here."""
    world = math.prod(shape)
    backend, devices = backend_for(world, device)
    tmp = tempfile.mkdtemp(prefix="ranks-")
    results = mp.get_context("spawn").SimpleQueue()
    got, ctx = {}, None
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(world, os.path.join(tmp, "store"), backend, devices, tuple(shape),
                  tuple(axes), policy, timeout_s, fn, args, results),
        )
        deadline = time.monotonic() + timeout_s
        while True:
            while not results.empty():
                rank, out = results.get()
                got[rank] = out
            if ctx.join(timeout=0.1):  # raises if a rank failed
                break
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"spawn_ranks: the ranks ran past {timeout_s} s")
        while not results.empty():
            rank, out = results.get()
            got[rank] = out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        # a failed rank leaves its traceback in a temporary file, read by
        # the join that raised
        for f in getattr(ctx, "error_files", ()):
            if os.path.exists(f):
                os.unlink(f)
    missing = sorted(set(range(world)) - set(got))
    if missing:
        raise RuntimeError(f"spawn_ranks: ranks {missing} returned nothing")
    return [got[r] for r in range(world)]
