"""Fault-tolerant training loop (port of the reference's
``training/trainer.py``), on one device or on a mesh.

Composes the train step (``launch.steps``), the data pipeline, the
checkpointer (atomic, optionally asynchronous), ``StepGuard`` (a NaN or
runaway step restores the last checkpoint), the straggler watchdog and
the elastic restart: a checkpoint restores onto whatever mesh the trainer
runs on (``distributed.fault.elastic_topology``), the model axis kept.

On a mesh (``topo``) every rank runs this loop alike (SPMD): it reads the
same global batches, holds its blocks of the params and the optimizer
state (``distributed.sharding``), and takes the same guard and injector
decisions, since the loss and grad norm it reads are the global values
(a rank that decided otherwise would deadlock the next collective).
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.fault import FailureInjector, StepGuard, StragglerMitigator
from repro_torch.distributed.topology import Topology, single_device_topology
from repro_torch.launch import steps as steps_mod
from repro_torch.models.model import Model
from repro_torch.training import optimizer as opt_mod


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    log_every: int = 10


class Trainer:
    """Trains ``cfg`` on ``data_iter``'s numpy batches on ``device``.
    Params are drawn from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (on a mesh every rank draws them whole and keeps its blocks);
    :meth:`initialize` resumes from the latest checkpoint in
    ``checkpoint_dir`` when there is one.  Each step's time is taken on
    the host clock after a synchronizing ``float(loss)``."""

    def __init__(
        self,
        cfg: ModelConfig,
        data_iter: Iterator[Dict[str, np.ndarray]],
        *,
        topo=None,
        trainer_cfg: Optional[TrainerConfig] = None,
        opt_cfg: Optional[opt_mod.OptimizerConfig] = None,
        failure_injector: Optional[FailureInjector] = None,
        seed: int = 0,
        device=DEFAULT_DEVICE,
    ):
        self.cfg = cfg
        self.topo: Topology = topo or single_device_topology()
        self.mesh = self.topo.mesh_shape is not None
        self.device = torch.device(device)
        self.tc = trainer_cfg or TrainerConfig()
        self.opt_cfg = opt_cfg or opt_mod.OptimizerConfig(name=cfg.optimizer)
        self.data_iter = data_iter
        self.model = Model(cfg, device=self.device, topo=self.topo)
        self.ckpt = Checkpointer(self.tc.checkpoint_dir, keep=self.tc.keep_checkpoints,
                                 topo=self.topo)
        self.guard = StepGuard()
        self.straggler = StragglerMitigator()
        self.injector = failure_injector
        self.metrics_log: list = []
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._step_fn = None
        self.step = 0
        self.params = None
        self.opt_state = None
        self.specs = None  # on a mesh: (param specs, optimizer-state specs)

    # -- state ----------------------------------------------------------------

    def _restore(self):
        """Load the latest checkpoint into the current state's structure."""
        self.step, (self.params, self.opt_state) = self.ckpt.restore(
            (self.params, self.opt_state), specs=self.specs)

    def initialize(self, resume: bool = True):
        self.params = self.model.init(self.generator)
        if self.mesh:
            self.specs = sharding.train_specs(self.params, self.cfg.optimizer, self.topo)
            self.params = sharding.shard_tree(self.params, self.specs[0], self.topo)
        self.opt_state = opt_mod.init_optimizer(self.cfg.optimizer, self.params,
                                                self._shards())
        self.step = 0
        if resume and self.ckpt.latest_step() is not None:
            self._restore()
        return self

    def _shards(self):
        """The optimizer's view of the params' blocks (None on one device)."""
        return sharding.leaf_shards(self.params, self.specs[0], self.topo) if self.mesh else None

    def load_state(self, params, opt_state):
        """Take whole ``params`` and ``opt_state`` (trees of tensors, as one
        device holds them), keeping this rank's blocks on a mesh."""
        if self.mesh:
            params = sharding.shard_tree(params, self.specs[0], self.topo)
            opt_state = sharding.shard_tree(opt_state, self.specs[1], self.topo)
        self.params, self.opt_state = params, opt_state
        return self

    # -- loop -----------------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        restores = 0
        if self._step_fn is None:
            self._step_fn = steps_mod.make_train_step(
                self.model, self.opt_cfg, self.specs[0] if self.mesh else None)
        specs = self.specs
        while self.step < self.tc.total_steps:
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in next(self.data_iter).items()}
            seen = {}

            def accept(metrics):
                # the step's loss read on the host (a synchronization), the
                # injected failure, then the guard: a bad step's update is
                # never applied
                loss = float(metrics["loss"])
                gnorm = float(metrics.get("grad_norm", 0.0))
                if self.injector is not None:
                    loss = self.injector.maybe_fail(self.step, loss)
                seen.update(loss=loss, gnorm=gnorm, dt=time.perf_counter() - t0,
                            ok=self.guard.check(loss, gnorm))
                return seen["ok"]

            t0 = time.perf_counter()
            self.params, self.opt_state, _ = self._step_fn(
                self.params, self.opt_state, batch, accept=accept)
            loss, gnorm, dt = seen["loss"], seen["gnorm"], seen["dt"]
            self.straggler.record(self.step, dt)
            if not seen["ok"]:
                # bad step: the update was dropped; restore the last good checkpoint
                restores += 1
                if self.ckpt.latest_step() is not None:
                    self.ckpt.wait()
                    self._restore()
                continue

            self.step += 1
            if self.step % self.tc.log_every == 0:
                self.metrics_log.append(
                    {"step": self.step, "loss": loss, "grad_norm": gnorm, "step_time_s": dt})
            if self.step % self.tc.checkpoint_every == 0:
                save = self.ckpt.async_save if self.tc.async_checkpoint else self.ckpt.save
                save(self.step, (self.params, self.opt_state),
                     {"loss": loss, "arch": self.cfg.name}, specs=specs)
        self.ckpt.wait()
        self.ckpt.save(self.step, (self.params, self.opt_state), {"final": True}, specs=specs)
        return {
            "final_step": self.step,
            "restores": restores,
            "stragglers": list(self.straggler.flagged),
            "log": self.metrics_log,
        }
