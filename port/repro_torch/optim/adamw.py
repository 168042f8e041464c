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
valid, and the optimizer allocates nothing the size of the model.

On a process mesh (the parameters ``DTensor``s, ``convert.shard_params``)
``m``, ``v`` and ``master`` are laid out as their parameters (the
reference's ZeRO posture: ``steps.opt_state_specs`` gives each its
parameter's spec) and ``step`` is a plain scalar, the same on every rank.
A gradient comes back from autograd in whatever layout DTensor's backward
left it, often a partial sum over the batch's axes: the update first
redistributes it to its parameter's placements (the gradient's reduction),
then works on each rank's pieces.  :func:`global_norm` sums each rank's
pieces of every leaf, each piece counted once: an all-reduce a mesh
axis (DTensor reduces a sum partial over two axes in two, one after the
other).
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
    # laid out as its parameter (a DTensor's zeros are one)
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
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
    added in sorted key order.  With ``DTensor`` leaves (none a partial
    sum), each rank takes the sum of squares of its piece of each leaf,
    or zero where a rank before it along an axis that does not split the
    leaf holds the same piece; an all-reduce a mesh axis sums them into
    each leaf's, and the leaves are added in sorted key order."""
    from torch.distributed.tensor import DTensor

    leaves = tree_leaves(_tree(tree))
    if not any(isinstance(g, DTensor) for g in leaves):
        total = 0
        for g in leaves:
            total = total + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(total)
    from repro_torch.launch import sharding as sh

    mesh = next(g for g in leaves if isinstance(g, DTensor)).device_mesh
    coord = mesh.get_coordinate()
    sums = []
    for g in leaves:
        if any(p.is_partial() for p in g.placements):
            raise ValueError(f"the norm of a partial sum ({g.placements})")
        first = all(p.is_shard() or c == 0
                    for p, c in zip(g.placements, coord))
        ss = torch.sum(torch.square(g.to_local().to(torch.float32)))
        sums.append(ss if first else torch.zeros_like(ss))
    every = sh.reduce_ranks(torch.stack(sums),
                            tuple(range(len(coord))))
    total = 0
    for ss in every:
        total = total + ss
    return torch.sqrt(total)


def _laid_out(g, p):
    """The gradient ``g`` in its parameter ``p``'s placements (a plain
    tensor as it is)."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def _local(t):
    """A ``DTensor``'s piece on this rank (a view), a plain tensor as it
    is."""
    return t.to_local() if hasattr(t, "to_local") else t


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0):
    """One AdamW step.  Returns (params, state, metrics) with ``params``
    and ``state`` the objects given, updated in place, and metrics
    ``{"grad_norm", "lr"}``.  Each leaf follows the reference's
    operations in its order: the gradient cast to f32 and clipped, the
    moments, their bias corrections, then the decoupled decay."""
    tree = _tree(params)
    grads = tree_map(_laid_out, grads, tree)
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr * lr_scale
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    masters = state.get("master", tree)

    def upd(p, pm, g, m, v):
        same = pm is p
        p, pm, g, m, v = (_local(t) for t in (p, pm, g, m, v))
        g = g.to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        mh = m / b1c
        vh = v / b2c
        w = pm.to(torch.float32)
        w = w - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                      + cfg.weight_decay * w)
        if not same:
            pm.copy_(w)
        p.copy_(w.to(p.dtype))

    tree_map(upd, tree, masters, grads, state["m"], state["v"])
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
