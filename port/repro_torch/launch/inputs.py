"""Sharded stand-ins for every model input (no device allocation; the port
of ``repro.launch.inputs``).

``input_specs(cfg, shape, mesh, rules)`` returns sharded specs
(:class:`~repro_torch.launch.sharding.Sharded`) for the train or serve
step of each (architecture x input-shape) cell, including decode KV
caches (batch over (pod,data); cache context over the model axis =
split-KV decode).

On a process mesh, :func:`shard_caches` and :func:`shard_batch` make the
caches and a batch themselves, as ``DTensor``s laid out by those specs.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.models import init_caches, param_shapes
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_map
from repro_torch.models.model import Caches

from .mesh import batch_axes
from .sharding import (P, Sharded, ShardingRules, distribute, param_sharding)

__all__ = ["input_specs", "cache_specs", "batch_sds", "decode_batch_sds",
           "param_specs_sharded", "shard_caches", "shard_batch"]


def _sds(mesh, shape, dtype, spec) -> Sharded:
    return Sharded(tuple(shape), dtype, spec, mesh)


def _bspec(mesh, gb: int) -> P:
    """Batch partition over (pod, data) restricted to axes whose product
    divides the global batch (long_500k has gb=1 -> replicated)."""
    sizes = mesh.axis_sizes
    axes = []
    prod = 1
    for a in batch_axes(mesh):
        if gb % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return P(tuple(axes)) if axes else P()


def batch_sds(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: ShardingRules):
    """Training/prefill batch specs."""
    GB, S, D = shape.global_batch, shape.seq_len, cfg.d_model
    bspec = _bspec(mesh, GB)
    batch = {}
    if cfg.inputs_embeds:
        batch["embeds"] = _sds(mesh, (GB, S, D), torch.bfloat16, bspec)
    else:
        batch["tokens"] = _sds(mesh, (GB, S), torch.int32, bspec)
    batch["labels"] = _sds(mesh, (GB, S), torch.int32, bspec)
    if cfg.n_image_tokens:
        batch["image_embed"] = _sds(mesh, (GB, cfg.n_image_tokens, D),
                                    torch.bfloat16, bspec)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, rules: ShardingRules):
    """Sharded specs for decode caches: ``init_caches`` on ``meta`` (the
    reference's ``jax.eval_shape``) with shardings attached: batch dim ->
    (pod,data); the context (T) dim of attention caches -> model axis
    (split-KV decode)."""
    GB, T = shape.global_batch, shape.seq_len
    caches = init_caches(cfg, GB, T, device="meta")
    model_size = mesh.axis_sizes.get("model", 1)
    bs = _bspec(mesh, GB)

    def to_spec(leaf):
        # leaf shapes are (L, ...) stacked; find dims:
        shp = tuple(leaf.shape)
        parts = [None] * len(shp)
        if len(shp) >= 2 and shp[1] == GB and len(bs) and bs[0]:
            parts[1] = bs[0]
        # context dim: a dim equal to T or the window size, shard over model
        for i in range(2, len(shp)):
            d = shp[i]
            if d >= 256 and d % model_size == 0 and d in (
                    T, min(T, cfg.window or T)):
                parts[i] = "model"
                break
        return _sds(mesh, shp, leaf.dtype, P(*parts))

    return tree_map(to_spec, dict(caches))


def decode_batch_sds(cfg: ModelConfig, shape: ShapeSpec, mesh):
    GB, D = shape.global_batch, cfg.d_model
    bspec = _bspec(mesh, GB)
    batch = {}
    if cfg.inputs_embeds:
        batch["embeds"] = _sds(mesh, (GB, 1, D), torch.bfloat16, bspec)
    else:
        batch["tokens"] = _sds(mesh, (GB, 1), torch.int32, bspec)
    if cfg.n_image_tokens:
        batch["image_embed"] = _sds(mesh, (GB, cfg.n_image_tokens, D),
                                    torch.bfloat16, bspec)
    return batch


def param_specs_sharded(cfg: ModelConfig, mesh, rules: ShardingRules):
    return param_sharding(mesh, rules, param_shapes(cfg))


def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rules: ShardingRules):
    """All step inputs for one cell: (params, extras...) per step kind."""
    params = param_specs_sharded(cfg, mesh, rules)
    if shape.kind in ("train", "prefill"):
        return params, batch_sds(cfg, shape, mesh, rules)
    return params, cache_specs(cfg, shape, mesh, rules), \
        decode_batch_sds(cfg, shape, mesh)


def shard_caches(cfg: ModelConfig, B: int, T: int, mesh,
                 rules: ShardingRules, whole: dict | None = None) -> Caches:
    """``init_caches(cfg, B, T)`` on the process ``mesh``: each leaf a
    ``DTensor`` laid out by :func:`cache_specs`, each rank's piece made as
    zeros on its device (the whole cache is never made).  ``whole``:
    caches of that shape that every rank holds the same (a decode that
    goes on from them); each rank's piece is cut from them instead."""
    specs = cache_specs(cfg, ShapeSpec("serve", T, B, "decode"), mesh, rules)
    dev = mesh.device()

    def one(s: Sharded, w=None):
        if w is None:
            local = torch.zeros(s.shard_shape(), dtype=s.dtype, device=dev)
            return distribute(s.meta(), s.spec, mesh, local=local)
        if tuple(w.shape) != tuple(s.shape) or w.dtype != s.dtype:
            raise ValueError(f"a cache leaf of {tuple(w.shape)} {w.dtype}, "
                             f"not {tuple(s.shape)} {s.dtype}")
        return distribute(w.to(dev), s.spec, mesh)

    if whole is None:
        return Caches(tree_map(one, specs))
    return Caches(tree_map(one, specs, dict(whole)))


def shard_batch(batch: dict, mesh) -> dict:
    """Each input of ``batch`` (every rank holds the same whole batch) as
    a ``DTensor`` split over the batch axes by :func:`_bspec`."""
    return {k: distribute(v, _bspec(mesh, v.shape[0]), mesh)
            for k, v in batch.items()}
