"""Training loop: steps + fault tolerance (the port of
``repro.train.trainer``).

  * async checkpoints every ``ckpt_every`` steps (``checkpoint/ckpt.py``),
    and a final one at the last step;
  * auto-resume: on start, the trainer restores the latest *committed*
    checkpoint and continues, so a killed and restarted job loses at most
    ``ckpt_every`` steps;
  * data is assigned by pure function of step (``data/pipeline.py``), so
    resume needs no data-loader state;
  * an optional in-process failure injector exercises the recovery path.

The step runs eagerly (the reference ``jax.jit``-s it); each token batch
goes up pinned and non-blocking, and the parameters are updated in place.
The fresh parameters come from ``init_params`` on a generator seeded 0 on
the training device: the reference's ``jax.random.key(0)`` draw has no
torch counterpart, so the two packages start from different weights
unless one is converted (``convert.params_from_numpy``).

With a process mesh (``core.mesh.ProcessMesh``; every rank of the mesh
runs the same trainer) the parameters are laid out by their specs as they
are drawn (``convert.shard_params`` over ``init_leaves``: no rank holds
the whole tree), each step's batch is split over the batch's axes
(``inputs.shard_batch``), the train step runs sharded, and the
checkpoints are gathered and written by rank 0 and restored into each
rank's pieces (``checkpoint/ckpt.py``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import torch

from repro_torch.checkpoint.ckpt import AsyncSaver, latest_step, restore
from repro_torch.core.engine import resolve_device, upload
from repro_torch.core.mesh import ProcessMesh
from repro_torch.data.pipeline import HostDataLoader, TokenDataset
from repro_torch.launch.steps import (TrainConfig, build_train_step,
                                      opt_state_specs)
from repro_torch.models import init_leaves, init_params, param_shapes
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import adamw_init

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    fail_at_step: int | None = None   # failure injection (tests)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 dataset: TokenDataset, rules=None, mesh=None,
                 device: str = "cuda") -> None:
        self.cfg = cfg
        self.tcfg = tcfg
        self.ds = dataset
        self.rules, self.mesh = rules, mesh
        self.sharded = isinstance(mesh, ProcessMesh)
        self.device = mesh.device() if self.sharded \
            else resolve_device(device)
        self.saver = AsyncSaver()
        self.step_fn = build_train_step(cfg, tcfg.train, rules, mesh)
        self.metrics: list[dict] = []

    def _state(self, params, opt) -> dict:
        return {"p": params.tree(), "o": opt}

    def init_or_restore(self):
        """Fresh init, or resume from the latest committed checkpoint.
        Returns (params, opt_state, first step)."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        if self.sharded:
            from repro_torch.convert import shard_params
            params = shard_params(init_leaves(self.cfg, gen,
                                              str(self.device)),
                                  self.mesh, self.rules, self.cfg)
        else:
            params = init_params(self.cfg, gen, device=str(self.device))
        opt = adamw_init(params, self.tcfg.train.optim)
        start = 0
        if self.sharded:
            # every rank reads the directory after rank 0's last write
            import torch.distributed as dist
            dist.barrier()
        last = latest_step(self.tcfg.ckpt_dir)
        if last is not None:
            shardings = None
            if self.sharded:
                from repro_torch.launch.sharding import param_sharding
                shardings = {"p": param_sharding(self.mesh, self.rules,
                                                 param_shapes(self.cfg)),
                             "o": opt_state_specs(self.cfg, self.mesh,
                                                  self.rules,
                                                  self.tcfg.train)}
            state, _ = restore(self._state(params, opt), self.tcfg.ckpt_dir,
                               last, shardings)
            with torch.no_grad():
                for p, t in zip(tree_leaves(params.tree()),
                                tree_leaves(state["p"])):
                    p.copy_(t)
            opt = state["o"]
            start = last + 1
        return params, opt, start

    def run(self) -> dict:
        params, opt, start = self.init_or_restore()
        loader = HostDataLoader(self.ds, host=0, n_hosts=1, start_step=start)
        losses = []
        try:
            for step in range(start, self.tcfg.steps):
                if self.tcfg.fail_at_step == step:
                    raise RuntimeError(f"injected failure at step {step}")
                _, (tokens, labels) = next(loader)
                batch = {"tokens": upload(tokens, self.device),
                         "labels": upload(labels, self.device)}
                if self.sharded:
                    from repro_torch.launch.inputs import shard_batch
                    batch = shard_batch(batch, self.mesh)
                params, opt, m = self.step_fn(params, opt, batch)
                if step % self.tcfg.log_every == 0 or \
                        step == self.tcfg.steps - 1:
                    loss = float(m["loss"])
                    losses.append((step, loss))
                    self.metrics.append({"step": step, "loss": loss,
                                         "grad_norm": float(m["grad_norm"])})
                if step % self.tcfg.ckpt_every == 0 and step > start:
                    self.saver.save_async(self._state(params, opt),
                                          self.tcfg.ckpt_dir, step)
        finally:
            loader.close()
            self.saver.wait()
        # final checkpoint
        self.saver.save_async(self._state(params, opt), self.tcfg.ckpt_dir,
                              self.tcfg.steps - 1)
        self.saver.wait()
        return {"losses": losses, "params": params}
