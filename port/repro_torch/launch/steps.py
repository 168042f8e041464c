"""The step functions: train_step (forward + backward + AdamW, remat,
microbatching), serve_step (one-token decode over caches) and
prefill_step (the last position's logits of a prompt batch); the port of
``repro.launch.steps`` (the prefill is what the reference's dry run
jits).

The steps run eagerly: there is no ``jit`` to build them for, and the
gradients come from autograd over the model's forward.  With ``rules``
the step runs under ``rules_ctx(rules, mesh)``, so that the model's
sharding hooks resolve and check every layout (``launch/sharding``); a
mesh of distinct devices in one process raises ``NotImplementedError``
when the step is built.  On a process mesh (``core.mesh.ProcessMesh``,
one process a position) the serve and prefill steps run sharded: the
parameters, caches and batch are ``DTensor``s (``convert.shard_params``,
``inputs.shard_caches``, ``inputs.shard_batch``) and so are the logits
(``full_tensor()`` gathers them).  So does the train step, for every
block: the parameters and the AdamW state are ``DTensor``s laid out by
their specs (``convert.shard_params``, ``convert.shard_opt_state``), the
loss is ``sharding.cross_entropy`` and each gradient is redistributed to
its parameter's placements before the update (``optim/adamw``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import (Model, decode_step, forward, init_params,
                                loss_fn, param_shapes)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.models.model import REMATS
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_state_shapes,
                               adamw_update)

from repro_torch.core.mesh import ProcessMesh

from .sharding import ShardingRules, param_sharding, rules_ctx

__all__ = ["TrainConfig", "build_train_step", "build_serve_step",
           "build_prefill_step", "init_train_state", "opt_state_specs"]

_ACC = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "full"          # none | dots | dots_no_batch | full | nested
    microbatch: int = 1          # gradient-accumulation steps
    unroll: bool = False         # the reference's metering builds
    scan_param_fsdp: bool = False  # per-layer FSDP gather (with a mesh)
    grad_accum_dtype: str = "float32"   # bf16 halves the accumulation buffer
    optim: AdamWConfig = AdamWConfig()


def opt_state_specs(cfg: ModelConfig, mesh, rules: ShardingRules,
                    tcfg: TrainConfig):
    """The AdamW state's :class:`Sharded` stand-ins: each moment and master
    leaf takes its parameter's resolved spec, ``step`` (no axes) is
    replicated."""
    return param_sharding(mesh, rules,
                          adamw_state_shapes(param_shapes(cfg), tcfg.optim))


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                     rules=None, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), ``params`` a :class:`Model` made trainable and updated in
    place, ``batch`` a dict of tensors on its device.  With ``microbatch``
    mb > 1 the batch is cut into mb chunks along its first axis, the
    gradients summed in ``grad_accum_dtype``, then loss and gradients
    divided by mb.  Chunk ``i`` holds the batch's rows ``[i*B/mb,
    (i+1)*B/mb)``, as the reference's (an MoE's groups depend on it); on
    a process mesh each chunk is cut from the gathered batch (a few
    kilobytes of token ids) and split over the batch's axes again; the
    chunks' gradients are summed in whatever layout DTensor gives the sum,
    which the update reduces into the parameters' placements."""
    _check_mesh(mesh)
    if tcfg.remat not in REMATS:
        raise ValueError(tcfg.remat)

    def grads_of(params: Model, batch) -> tuple:
        """(loss, gradients of the leaves in sorted key order)."""
        loss, _ = loss_fn(params, cfg, batch, remat=tcfg.remat,
                          unroll=tcfg.unroll,
                          scan_param_fsdp=tcfg.scan_param_fsdp)
        grads = torch.autograd.grad(loss, tree_leaves(params.tree()))
        if isinstance(mesh, ProcessMesh):
            loss = loss.to_local()
        return loss.detach(), list(grads)

    def train_step(params: Model, opt_state, batch):
        with rules_ctx(rules, mesh):
            return step(params, opt_state, batch)

    def step(params: Model, opt_state, batch):
        params.trainable()
        tree = params.tree()
        if tcfg.microbatch > 1:
            mb = tcfg.microbatch
            acc_dt = _ACC[tcfg.grad_accum_dtype]
            grads = [torch.zeros_like(p, dtype=acc_dt)
                     for p in tree_leaves(tree)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=params.device)
            for i in range(mb):
                l, g = grads_of(params, _chunk(batch, i, mb, mesh))
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


def _chunk(batch: dict, i: int, mb: int, mesh) -> dict:
    """Rows ``[i*B/mb, (i+1)*B/mb)`` of every input of ``batch``; on a
    process mesh gathered whole, cut, and split over the batch's axes
    again (``inputs.shard_batch``)."""
    if not isinstance(mesh, ProcessMesh):
        return {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                for k, v in batch.items()}
    from .inputs import shard_batch

    b = next(iter(batch.values())).shape[0] // mb
    return shard_batch({k: v.full_tensor()[i * b:(i + 1) * b]
                        for k, v in batch.items()}, mesh)


def build_serve_step(cfg: ModelConfig, rules=None, mesh=None,
                     unroll: bool = False):
    """serve_step(params, caches, batch) -> (logits, caches): one new token
    against a pre-filled KV/state cache, the caches written in place."""
    _check_mesh(mesh)

    def serve_step(params, caches, batch):
        with rules_ctx(rules, mesh), torch.inference_mode():
            return decode_step(
                params, cfg, caches,
                tokens=batch.get("tokens"), embeds=batch.get("embeds"),
                aux={k: v for k, v in batch.items() if k == "image_embed"},
                unroll=unroll)

    return serve_step


def build_prefill_step(cfg: ModelConfig, rules=None, mesh=None,
                       unroll: bool = False):
    """prefill_step(params, batch) -> logits (B, 1, V): ``forward`` over
    the batch's prompts with no remat and only the last position
    projected, as the reference's dry run jits its prefill cells."""
    _check_mesh(mesh)

    def prefill_step(params, batch):
        with rules_ctx(rules, mesh), torch.inference_mode():
            logits, _ = forward(
                params, cfg, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"),
                aux={k: v for k, v in batch.items() if k == "image_embed"},
                remat="none", last_only=True, unroll=unroll)
            return logits

    return prefill_step


def _check_mesh(mesh) -> None:
    """A mesh of distinct devices in one process raises
    ``NotImplementedError``."""
    if mesh is not None and not isinstance(mesh, ProcessMesh):
        mesh.device()


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: torch.Generator, device: str = "cuda"):
    """(params, opt_state): ``init_params`` drawn on ``generator``, made
    trainable, on ``device`` (the card unless ``device="cpu"``), and its
    AdamW state."""
    resolve_device(device)
    params = init_params(cfg, generator, device=device).trainable()
    return params, adamw_init(params, tcfg.optim)
