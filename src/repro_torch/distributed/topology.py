"""Mesh topology descriptor threaded through model code (port of the
reference's ``distributed/topology.py``).

Model code never asks ``torch.distributed`` which rank it is; it receives a
:class:`Topology` that says which mesh axes exist, how logical roles
(data / expert / tensor / pipeline) map onto them, where this rank sits on
the mesh and which process groups span its axes.  In place of the
reference's JAX ``Mesh`` it holds the mesh's shape and axis names, this
rank's coordinates and the groups of the model axis, of the data axes and of
the data and model axes together and of the whole world
(``launch.mesh.make_topology`` builds them).  The port runs
SPMD: one process a rank, every rank the same host code.  ``mesh_shape=None``
(or ``ep_size == 1``) selects the single-device code paths.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class Topology:
    mesh_shape: Optional[Tuple[int, ...]] = None  # None: one device, no groups
    axis_names: Tuple[str, ...] = ("data", "model")
    data_axes: Tuple[str, ...] = ("data",)  # batch-sharding axes ("pod", "data")
    model_axis: Optional[str] = "model"  # TP / EP axis
    # Pipeline parallelism over pods and the heterogeneous flag: the
    # reference declares both and its model code reads neither, so nothing
    # shards along a pipeline axis (its ranks are replicas; ``pp_size`` is
    # its size).  The per-shard capability mask (HL-GGN eq. 2-4) reaches the
    # MoE bodies as ``apply_moe``'s ``expert_mask``, as in the reference.
    pipeline_axis: Optional[str] = None
    fsdp: bool = True
    # Sequence-parallel attention: the residual stream is S-sharded over the
    # model axis; attention gathers only the (small, GQA) K/V heads and the
    # MoE dispatch consumes pre-sharded tokens.  The reference calls it valid
    # for attention-pure stacks (an SSM layer's scan crosses the shard
    # boundary); as there, a hybrid stack runs under it all the same, its SSM
    # layers on the whole sequence.
    seq_parallel_attn: bool = False
    heterogeneous: bool = False
    coords: Tuple[int, ...] = ()  # this rank's index along each axis
    # torch.distributed process groups (None on one device); not compared
    world_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)
    data_group: Any = field(default=None, compare=False, repr=False)
    # the data and model axes together: the world less a pipeline axis
    data_model_group: Any = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.mesh_shape is not None:
            if len(self.mesh_shape) != len(self.axis_names):
                raise ValueError(f"mesh {self.mesh_shape} vs axes {self.axis_names}")
            if len(self.coords) != len(self.mesh_shape):
                raise ValueError(f"coords {self.coords} on mesh {self.mesh_shape}")

    def _size(self, axis: str) -> int:
        return self.mesh_shape[self.axis_names.index(axis)]

    def _coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    @property
    def dp_size(self) -> int:
        if self.mesh_shape is None:
            return 1
        return math.prod(self._size(a) for a in self.data_axes)

    @property
    def ep_size(self) -> int:
        if self.mesh_shape is None or self.model_axis is None:
            return 1
        return self._size(self.model_axis)

    @property
    def tp_size(self) -> int:
        return self.ep_size

    @property
    def pp_size(self) -> int:
        if self.mesh_shape is None or self.pipeline_axis is None:
            return 1
        return self._size(self.pipeline_axis)

    @property
    def num_devices(self) -> int:
        return 1 if self.mesh_shape is None else math.prod(self.mesh_shape)

    @property
    def use_shard_map_moe(self) -> bool:
        """The expert-parallel MoE bodies run (the reference's name: there
        they run inside ``shard_map``)."""
        return self.mesh_shape is not None and self.ep_size > 1

    @property
    def model_index(self) -> int:
        """This rank's shard along the model axis (``axis_index``)."""
        if self.mesh_shape is None or self.model_axis is None:
            return 0
        return self._coord(self.model_axis)

    @property
    def data_index(self) -> int:
        """This rank's shard of the batch: its coordinates on the data axes,
        row-major."""
        if self.mesh_shape is None:
            return 0
        idx = 0
        for a in self.data_axes:
            idx = idx * self._size(a) + self._coord(a)
        return idx

    def expert_slice(self, num_experts: int) -> slice:
        """This rank's experts ``[r·E/ep, (r+1)·E/ep)`` along the model axis
        (all of them off an expert-parallel mesh)."""
        if not self.use_shard_map_moe:
            return slice(0, num_experts)
        n = num_experts // self.ep_size
        return slice(self.model_index * n, (self.model_index + 1) * n)

    @property
    def rank(self) -> int:
        """The row-major position of ``coords`` on the mesh."""
        if self.mesh_shape is None:
            return 0
        idx = 0
        for n, c in zip(self.mesh_shape, self.coords):
            idx = idx * n + c
        return idx


def single_device_topology() -> Topology:
    return Topology(mesh_shape=None)
