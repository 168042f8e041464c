"""AdamW with f32 master weights and global-norm clipping (the port of
``repro.optim.adamw``).

The state is the reference's tree, ``{"step", "m", "v", "master"}``
(``master`` only with ``master_f32``), each of ``m``, ``v`` and ``master``
a nested dict shaped like the parameters, in float32.  ``params`` is a
:class:`~repro_torch.models.Model` or a nested dict of tensors; leaves
are visited in sorted key order, the order in which JAX flattens the
reference's trees, so the global norm sums them in the reference's order.

:func:`adamw_update` works in place under ``torch.no_grad()``: it writes
the new values into the parameters, ``m``, ``v`` and ``master``
themselves, so the views a serving model holds of its parameters stay
valid, and the optimizer allocates nothing the size of the model.  On one
card with no mesh there is no sharding of the states (the reference's
ZeRO posture comes with ``launch/sharding``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import Spec, tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_state_shapes",
           "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_f32: bool = True     # keep f32 master copy of bf16 params


def _tree(params) -> dict:
    """A model's parameter tree, or the tree itself."""
    return params.tree() if hasattr(params, "tree") else params


def adamw_init(params, cfg: AdamWConfig) -> dict:
    tree = _tree(params)
    dev = tree_leaves(tree)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "m": tree_map(zeros, tree), "v": tree_map(zeros, tree)}
    if cfg.master_f32:
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), tree)
    return state


def adamw_state_shapes(param_specs, cfg: AdamWConfig) -> dict:
    """Spec tree mirroring adamw_init."""
    def f32(s):
        return Spec(s.shape, torch.float32, s.axes)

    state = {"step": Spec((), torch.int32, ()),
             "m": tree_map(f32, param_specs),
             "v": tree_map(f32, param_specs)}
    if cfg.master_f32:
        state["master"] = tree_map(f32, param_specs)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares in f32, the leaves
    added in sorted key order."""
    total = 0
    for g in tree_leaves(_tree(tree)):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0):
    """One AdamW step.  Returns (params, state, metrics) with ``params``
    and ``state`` the objects given, updated in place, and metrics
    ``{"grad_norm", "lr"}``.  Each leaf follows the reference's
    operations in its order: the gradient cast to f32 and clipped, the
    moments, their bias corrections, then the decoupled decay."""
    tree = _tree(params)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr * lr_scale
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    masters = state.get("master", tree)

    def upd(p, pm, g, m, v):
        g = g.to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mh = m / b1c
        vh = v / b2c
        w = pm.to(torch.float32)
        w = w - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                      + cfg.weight_decay * w)
        if pm is not p:
            pm.copy_(w)
        p.copy_(w.to(p.dtype))

    tree_map(upd, tree, masters, grads, state["m"], state["v"])
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
