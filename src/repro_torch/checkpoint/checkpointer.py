"""Checkpointing: atomic, resumable, optionally asynchronous (port of the
reference's ``checkpoint/checkpointer.py``, with the same files on disk).

Layout: ``<dir>/step_<N>/`` (N zero-padded to 8 digits) holding
  ``arrays.npz`` — every leaf, keyed by its '/'-joined path (dict keys;
                   tuple and list indices), and
  ``meta.json``  — step, time, leaf count and the caller's metadata.

So a checkpoint written by either package restores in the other: the
trainer's state ``(params, opt_state)`` has keys such as
``0/blocks/pos0/attn/wq`` and ``1/step``.  Writes go to ``step_<N>.tmp``
and are ``os.replace``d into place, so a crash mid-write never corrupts
the latest checkpoint (the readers ignore ``*.tmp``); ``keep`` bounds the
checkpoints kept.  ``async_save`` copies the state to the host
synchronously (the trainer updates its params in place right after) and
writes on a background thread.  A bf16 leaf is written as f32 (numpy has
no bf16); a restore casts every leaf to its template's type and device.

On a mesh (``topo``) the state is this rank's blocks, and ``specs`` (the
state's ``distributed.sharding`` specs) says how each leaf lies: ``save``
gathers every leaf whole (a collective, leaf by leaf), rank 0 writes and
the other ranks wait at a barrier; ``async_save`` gathers before it hands
the write to rank 0's thread, and ``wait`` is the barrier.  ``restore``
cuts each whole array to the block its specs give on the mesh it is called
on (or keeps it whole on one device), so the files stay the one-device
format and a checkpoint restores onto any mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding


def _items(tree, prefix: str = ""):
    """(path, leaf) of a nested dict / tuple / list, depth first."""
    if isinstance(tree, dict):
        pairs = tree.items()
    elif isinstance(tree, (tuple, list)):
        pairs = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in pairs:
        yield from _items(v, f"{prefix}/{k}" if prefix else str(k))


def _to_host(leaf) -> np.ndarray:
    """A host copy of a leaf (a tensor is copied even when it lies on the
    CPU, so a later in-place update cannot reach the snapshot)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {path: _to_host(leaf) for path, leaf in _items(tree)}


def _spec_items(specs, prefix: str = ""):
    """(path, spec) of a specs tree: dicts, and tuples or lists of dicts,
    down to the spec tuples (the leaves)."""
    if isinstance(specs, dict):
        pairs = specs.items()
    elif isinstance(specs, (tuple, list)) and specs and all(isinstance(s, dict) for s in specs):
        pairs = enumerate(specs)
    else:
        yield prefix, tuple(specs)
        return
    for k, v in pairs:
        yield from _spec_items(v, f"{prefix}/{k}" if prefix else str(k))


def _unflatten(template, flat, prefix: str = "", specs=None, topo=None):
    """``template``'s structure with each leaf from ``flat`` (read leaf by
    leaf), cut to this rank's block by its spec in ``specs`` ({path:
    spec}) on a mesh, as a tensor of the template leaf's type on its
    device; raise on a missing leaf or a shape that differs."""
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k), specs, topo)
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(
            _unflatten(v, flat, f"{prefix}/{i}" if prefix else str(i), specs, topo)
            for i, v in enumerate(template))
    if prefix not in flat:
        raise KeyError(f"checkpoint missing leaf {prefix!r}")
    arr = flat[prefix]
    if specs is not None:
        arr = sharding.local_block(torch.from_numpy(np.asarray(arr)), specs[prefix], topo).numpy()
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(
            f"shape mismatch for {prefix}: ckpt {arr.shape} vs model {tuple(template.shape)}")
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=template.device, dtype=template.dtype)
    return arr


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, topo=None):
        self.dir = directory
        self.keep = keep
        self.topo = topo if topo is not None and topo.mesh_shape is not None else None
        self._writer = self.topo is None or self.topo.rank == 0
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pending = False  # a mesh's asynchronous write not yet waited for

    # -- write ---------------------------------------------------------------

    def _host(self, state: Any, specs) -> Dict[str, np.ndarray]:
        """The state's leaves on the host, whole: on a mesh gathered leaf by
        leaf (every rank takes part), kept on the writing rank only."""
        if self.topo is None:
            return _flatten(state)
        spec = dict(_spec_items(specs))
        flat = {}
        for path, leaf in _items(state):
            whole = sharding.gather_block(leaf, spec[path], self.topo)
            if self._writer:
                flat[path] = _to_host(whole)
        return flat

    def save(self, step: int, state: Any, metadata: Optional[Dict] = None, specs=None):
        """Write ``state`` (on a mesh: its blocks, laid out by ``specs``)."""
        flat = self._host(state, specs)
        if self._writer:
            self._write(step, flat, metadata or {})
        if self.topo is not None:
            coll.barrier(self.topo.world_group)

    def async_save(self, step: int, state: Any, metadata: Optional[Dict] = None, specs=None):
        """Copy to the host synchronously (on a mesh: gathered), write in the
        background."""
        self.wait()
        flat = self._host(state, specs)
        if self._writer:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, metadata or {}), daemon=True
            )
            self._thread.start()
        self._pending = self.topo is not None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:  # every rank reads the files only after they are written
            coll.barrier(self.topo.world_group)
            self._pending = False

    def _write(self, step: int, flat: Dict[str, np.ndarray], metadata: Dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "time": time.time(), "n_leaves": len(flat), **metadata}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None, specs=None
                ) -> Tuple[int, Any]:
        """Restore into the structure of ``template`` (each leaf takes the
        template leaf's type and device); on a mesh ``template`` holds this
        rank's blocks and ``specs`` their layout, and each whole array is
        cut to the block."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}", "arrays.npz")
        spec = dict(_spec_items(specs)) if self.topo is not None and specs is not None else None
        with np.load(path) as z:
            return step, _unflatten(template, z, specs=spec, topo=self.topo)

    def metadata(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.dir, f"step_{step:08d}", "meta.json")) as f:
            return json.load(f)
