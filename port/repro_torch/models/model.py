"""Model assembly: embedding -> staged block stack -> norm -> LM head.

The port of ``repro.models.model``.  The parameters keep the reference's
layout: ``embed``, ``stages/<key>/...`` with every leaf stacked ``(L, ...)``
over the stage's layers, ``final_norm`` and ``lm_head`` (absent when the
embeddings are tied), so that ``execution_runs`` keeps its meaning and
``convert.params_from_numpy`` carries a reference tree across leaf by leaf.
:class:`Model` holds them as an ``nn.Module``: ``params`` is the tree
(:class:`ParamTree`) and ``blocks`` a ``ModuleList`` with one
:class:`Layer` a layer, in execution order, each holding views of its row
of its stage's stacked tensors, made once.

There is no ``jit`` and no scan: layers run as a Python loop, eagerly, on
the parameters' device.  ``decode_step`` writes the KV caches in place and
returns the same cache tree.  ``loss_fn`` comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.engine import resolve_device

from .blocks import BLOCKS
from .config import ModelConfig
from .layers import Spec, apply_norm, norm_shapes, shard

__all__ = ["param_shapes", "init_params", "forward", "decode_step",
           "init_caches", "execution_runs", "Model", "ParamTree", "Layer",
           "Caches"]


def _dtype(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict, keys in sorted order (the
    order in which JAX flattens the reference's trees)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], path + (k,)) for k in sorted(tree)}
    return fn(path, tree)


def _stack_shapes(shapes, L):
    return _map(lambda _, s: Spec((L,) + s.shape, s.dtype,
                                  ("layers",) + s.axes), shapes)


def _stage_key(kind: str, si: int, block: str) -> str:
    return f"{kind}{si}_{block}"


def param_shapes(cfg: ModelConfig):
    dt = _dtype(cfg)
    D, V = cfg.d_model, cfg.vocab
    p = {}
    if not cfg.inputs_embeds:
        p["embed"] = Spec((V, D), dt, ("vocab", "embed"))
    stages = {}
    for si, st in enumerate(cfg.prologue):
        stages[_stage_key("pro", si, st.block)] = _stack_shapes(
            BLOCKS[st.block].shapes(cfg, dt), st.layers)
    for si, st in enumerate(cfg.pattern):
        stages[_stage_key("s", si, st.block)] = _stack_shapes(
            BLOCKS[st.block].shapes(cfg, dt), st.layers * cfg.n_units)
    p["stages"] = stages
    p["final_norm"] = norm_shapes(cfg, torch.float32)
    if not cfg.tie_embeddings:
        p["lm_head"] = Spec((D, V), dt, ("embed", "vocab"))
    return p


def execution_runs(cfg: ModelConfig):
    """Ordered (stage_key, offset, count, block) runs, RLE-merged."""
    raw = []
    for si, st in enumerate(cfg.prologue):
        raw.append([_stage_key("pro", si, st.block), 0, st.layers, st.block])
    for u in range(cfg.n_units):
        for si, st in enumerate(cfg.pattern):
            raw.append([_stage_key("s", si, st.block), u * st.layers,
                        st.layers, st.block])
    merged = []
    for r in raw:
        if merged and merged[-1][0] == r[0] and \
                merged[-1][1] + merged[-1][2] == r[1]:
            merged[-1][2] += r[2]
        else:
            merged.append(list(r))
    return [tuple(m) for m in merged]


# ------------------------------------------------------------------- module

class ParamTree(nn.Module):
    """A nested dict of tensors as a module: leaves are (frozen)
    parameters, inner dicts submodules."""

    def __init__(self, tree: dict) -> None:
        super().__init__()
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def tree(self) -> dict:
        """The tensors as a nested dict (the parameters themselves)."""
        out = dict(self.named_parameters(recurse=False))
        out.update((k, m.tree()) for k, m in self.named_children())
        return out


def _index(tree, j: int):
    """Row ``j`` of every leaf of a tree (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    return tree[j]


class Layer(nn.Module):
    """One layer of the stack: its block's forward and decode over ``p``,
    row ``index`` of stage ``key``'s stacked parameters (views made once),
    and over the same row of that stage's caches.  Holds no parameters of
    its own: the stage owns them."""

    def __init__(self, block: str, key: str, index: int, p: dict) -> None:
        super().__init__()
        self.block, self.key, self.index = block, key, index
        self.p = p

    def forward(self, x, cfg, aux):
        return BLOCKS[self.block].forward(x, self.p, cfg, aux)

    def decode(self, x, cfg, caches: "Caches", aux):
        """Decode one token through this layer, writing its row of the
        stage's stacked ``caches`` in place."""
        cache = caches.rows[self.key][self.index]
        y, new = BLOCKS[self.block].decode(x, self.p, cfg, cache, aux)
        for name, t in new.items():
            if t is not cache[name]:
                cache[name].copy_(t)
        return y


class Model(nn.Module):
    """The parameters of one configuration, in the reference's layout
    (``params``), and the layers that read them (``blocks``)."""

    def __init__(self, cfg: ModelConfig, tree: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.params = ParamTree(tree)
        stages = {k: m.tree()
                  for k, m in self.params.stages.named_children()}
        self.blocks = nn.ModuleList(
            Layer(block, key, off + j, _index(stages[key], off + j))
            for key, off, cnt, block in execution_runs(cfg)
            for j in range(cnt))

    @property
    def device(self) -> torch.device:
        return self.params.final_norm.device

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, tokens=None, embeds=None, aux=None):
        return forward(self, self.cfg, tokens=tokens, embeds=embeds, aux=aux)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str = "cuda") -> Model:
    """Real initialization (smoke tests / small trains), decided by path as
    in the reference: norms -> ones, gates/biases -> zeros, matrices ->
    normal 0.02, drawn in f32 and cast.  Leaves are drawn in sorted path
    order on ``generator``'s device, then placed on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def one(path, s):
        nm = "/".join(path).lower()
        if any(t in nm for t in ("norm", "ln1", "ln2", "/na", "/nm")):
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        if "gate" in nm or len(s.shape) < 2:        # gates, biases
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device).mul_(0.02)
        return w.to(s.dtype).to(dev)

    return Model(cfg, _map(one, param_shapes(cfg)))


def _embed(params: Model, cfg: ModelConfig, tokens, embeds):
    if cfg.inputs_embeds:
        return embeds.to(_dtype(cfg))
    e = params.params.embed
    return e[tokens.long()].to(_dtype(cfg))


def _logits(params: Model, cfg: ModelConfig, x):
    p = params.params
    head = p.embed.T if cfg.tie_embeddings else p.lm_head
    return apply_norm(x, p.final_norm, cfg) @ head


def forward(params: Model, cfg: ModelConfig, tokens=None, embeds=None,
            aux=None, remat: str | None = "full", last_only: bool = False,
            unroll: bool = False, scan_param_fsdp: bool = False):
    """Returns (logits (B,S,V), aux_loss ()).  tokens (B,S) int32 or
    embeds (B,S,D).  last_only: project only the final position (serving
    prefill — avoids the (B,S,V) logits tensor).  ``remat``, ``unroll``
    and ``scan_param_fsdp`` choose how the reference builds its program
    (checkpointing, loop form, parameter sharding); without a gradient, a
    mesh or a compiler none of them changes a value here, and they are
    accepted for the reference's signature."""
    del remat, unroll, scan_param_fsdp
    aux = aux or {}
    x = shard(_embed(params, cfg, tokens, embeds), ("batch", "seq", "embed"))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.blocks:
        x, a = layer(x, cfg, aux)
        x = shard(x, ("batch", "seq", "embed"))
        aux_total = aux_total + a
    if last_only:
        x = x[:, -1:, :]
    logits = shard(_logits(params, cfg, x), ("batch", "seq", "vocab"))
    return logits, aux_total


# ------------------------------------------------------------------- decode

class Caches(dict):
    """Stacked per-stage caches in the reference's layout, ``{stage_key:
    {name: (L, ...)}}``, and ``rows[stage_key][j]``: row ``j`` of each of
    its tensors, as views made once, through which decode writes."""

    def __init__(self, tree: dict) -> None:
        super().__init__(tree)
        self.rows = {k: [_index(c, j) for j in range(_depth(c))]
                     for k, c in tree.items()}


def _depth(tree) -> int:
    """The leading (layer) dimension of a stacked tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def init_caches(cfg: ModelConfig, B: int, T: int, device: str = "cuda"):
    """Stacked per-stage caches for one-token decode with context length T,
    on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    dt = _dtype(cfg)
    caches = {}
    stages = [(_stage_key("pro", si, st.block), st.block, st.layers)
              for si, st in enumerate(cfg.prologue)]
    stages += [(_stage_key("s", si, st.block), st.block,
                st.layers * cfg.n_units) for si, st in enumerate(cfg.pattern)]
    for key, block, L in stages:
        one = BLOCKS[block].init_cache(cfg, B, T, dt, dev)
        caches[key] = _map(lambda _, a: a[None].repeat(
            (L,) + (1,) * a.dim()), one)
    return Caches(caches)


def decode_step(params: Model, cfg: ModelConfig, caches: Caches,
                tokens=None, embeds=None, aux=None, unroll: bool = False):
    """One-token decode.  tokens (B,1) int32 / embeds (B,1,D).
    Returns (logits (B,1,V), caches), the caches written in place.
    ``unroll`` is the reference's loop form; it changes no value here."""
    del unroll
    aux = aux or {}
    x = _embed(params, cfg, tokens, embeds)
    for layer in params.blocks:
        x = layer.decode(x, cfg, caches, aux)
    return _logits(params, cfg, x), caches
