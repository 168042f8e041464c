"""The step functions: train_step (forward + backward + AdamW, remat,
microbatching) and serve_step (one-token decode over caches); the port of
``repro.launch.steps``.

The steps run eagerly: there is no ``jit`` to build them for, and the
gradients come from autograd over the model's forward.  The reference's
``opt_state_specs`` and its ``rules``/``mesh`` arguments place the state
on a device mesh through ``launch/sharding``, which the port does not have
yet (ROADMAP Queue 1, item 7e): ``opt_state_specs`` is left out, and a
``rules`` or ``mesh`` other than None raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import Model, decode_step, init_params, loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.models.model import REMATS
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainConfig", "build_train_step", "build_serve_step",
           "init_train_state"]

_ACC = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "full"          # none | dots | dots_no_batch | full | nested
    microbatch: int = 1          # gradient-accumulation steps
    unroll: bool = False         # the reference's metering builds
    scan_param_fsdp: bool = False  # per-layer FSDP gather (with a mesh)
    grad_accum_dtype: str = "float32"   # bf16 halves the accumulation buffer
    optim: AdamWConfig = AdamWConfig()


def _no_mesh(rules, mesh) -> None:
    if rules is not None or mesh is not None:
        raise NotImplementedError(
            "sharding rules and meshes wait for the port of launch/sharding "
            "(ROADMAP Queue 1, item 7e); pass rules=None, mesh=None")


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     rules=None, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``params`` a :class:`Model` made trainable and updated in
    place, ``batch`` a dict of tensors on its device.  With ``microbatch``
    mb > 1 the batch is cut into mb chunks along its first axis, the
    gradients summed in ``grad_accum_dtype``, then loss and gradients
    divided by mb."""
    _no_mesh(rules, mesh)
    if tcfg.remat not in REMATS:
        raise ValueError(tcfg.remat)

    def grads_of(params: Model, batch) -> tuple:
        """(loss, gradients of the leaves in sorted key order)."""
        loss, _ = loss_fn(params, cfg, batch, remat=tcfg.remat,
                          unroll=tcfg.unroll,
                          scan_param_fsdp=tcfg.scan_param_fsdp)
        grads = torch.autograd.grad(loss, tree_leaves(params.tree()))
        return loss.detach(), list(grads)

    def train_step(params: Model, opt_state, batch):
        params.trainable()
        tree = params.tree()
        if tcfg.microbatch > 1:
            mb = tcfg.microbatch
            chunks = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                      for k, v in batch.items()}
            acc_dt = _ACC[tcfg.grad_accum_dtype]
            grads = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                     for p in tree_leaves(tree)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=params.device)
            for i in range(mb):
                l, g = grads_of(params, {k: v[i] for k, v in chunks.items()})
                grads = [a + b.to(a.dtype) for a, b in zip(grads, g)]
                loss = loss + l
            loss = loss / mb
            grads = [g / mb for g in grads]
        else:
            loss, grads = grads_of(params, batch)
        params, opt_state, om = adamw_update(
            params, tree_unflatten(tree, grads), opt_state, tcfg.optim)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def build_serve_step(cfg: ModelConfig, rules=None, mesh=None,
                     unroll: bool = False):
    """serve_step(params, caches, batch) -> (logits, caches): one new token
    against a pre-filled KV/state cache, the caches written in place."""
    _no_mesh(rules, mesh)

    def serve_step(params, caches, batch):
        with torch.inference_mode():
            return decode_step(
                params, cfg, caches,
                tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                aux={k: v for k, v in batch.items() if k == "image_embed"},
                unroll=unroll)

    return serve_step


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: torch.Generator, device: str = "cuda"):
    """(params, opt_state): ``init_params`` drawn on ``generator``, made
    trainable, on ``device`` (the card unless ``device="cpu"``), and its
    AdamW state."""
    resolve_device(device)
    params = init_params(cfg, generator, device=device).trainable()
    return params, adamw_init(params, tcfg.optim)
