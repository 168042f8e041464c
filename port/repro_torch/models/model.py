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
the parameters' device.  ``decode_step`` writes the caches (KV, and the
recurrent blocks' state) in place and returns the same cache tree.

Serving runs the parameters frozen (``requires_grad=False``) and builds no
graph.  :meth:`Model.trainable` turns them into trainable leaves for
``loss_fn`` and the optimizer; a trainable layer then takes its row of the
stacked leaves on every call, so that autograd reaches the stacked
parameter (a view made while the parameter was frozen has no ``grad_fn``,
and would leave it without a gradient).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.engine import resolve_device
from repro_torch.launch.sharding import (backward_in_ctx, embedding,
                                         param_constraint)

from .blocks import BLOCKS
from .config import ModelConfig
from .layers import (Spec, apply_norm, cross_entropy, norm_shapes, shard,
                     tree_map, tree_paths, tree_unflatten)

__all__ = ["param_shapes", "init_params", "init_leaves", "forward",
           "loss_fn",
           "decode_step", "init_caches", "execution_runs", "Model",
           "ParamTree", "Layer", "Caches", "REMATS"]


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
    """One layer of the stack: its block's forward and decode over row
    ``index`` of stage ``key``'s stacked parameters ``stage``, and over the
    same row of that stage's caches.  Holds no parameters of its own: the
    stage owns them.  Frozen, it reads views of its row made once
    (``p``); trainable, it takes the row anew on each call."""

    def __init__(self, block: str, key: str, index: int,
                 stage: dict) -> None:
        super().__init__()
        self.block, self.key, self.index = block, key, index
        self.stage = stage
        self.p = _index(stage, index)
        self.trainable = False

    def rows(self) -> dict:
        return _index(self.stage, self.index) if self.trainable else self.p

    def forward(self, x, cfg, aux, specs=None):
        """The block's forward; with ``specs`` (the stage's stacked
        ``Spec`` tree) each leaf of the row first passes through
        ``param_constraint`` on its per-layer axes."""
        p = self.rows()
        if specs is not None:
            p = tree_map(lambda a, s: param_constraint(a, s.axes[1:]), p,
                         specs)
        return BLOCKS[self.block].forward(x, p, cfg, aux)

    def decode(self, x, cfg, caches: "Caches", aux):
        """Decode one token through this layer, writing its row of the
        stage's stacked ``caches`` in place."""
        cache = caches.rows[self.key][self.index]
        y, new = BLOCKS[self.block].decode(x, self.rows(), cfg, cache, aux)
        _write_back(cache, new)
        return y


def _write_back(cache: dict, new: dict) -> None:
    """Write a block's new cache tree into ``cache`` leaf by leaf, in
    place, at any depth (``hybrid``'s is ``{"attn": ..., "mamba": ...}``).
    A leaf the block already updated in place is left as it is."""
    for name, t in new.items():
        if isinstance(t, dict):
            _write_back(cache[name], t)
        elif t is not cache[name]:
            cache[name].copy_(t)


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
            Layer(block, key, off + j, stages[key])
            for key, off, cnt, block in execution_runs(cfg)
            for j in range(cnt))

    @property
    def device(self) -> torch.device:
        return self.params.final_norm.device

    def trainable(self, mode: bool = True) -> "Model":
        """Make every parameter a trainable leaf (``mode``) or freeze it
        again, with the layers reading their rows to match."""
        self.params.requires_grad_(mode)
        for layer in self.blocks:
            layer.trainable = mode
        return self

    def tree(self) -> dict:
        return self.params.tree()

    def forward(self, tokens=None, embeds=None, aux=None):
        return forward(self, self.cfg, tokens=tokens, embeds=embeds, aux=aux)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: str = "cuda") -> Model:
    """Real initialization (smoke tests / small trains), decided by path as
    in the reference and in its order: norms -> ones, gates -> zeros,
    mamba's ``A_log`` -> ``log(1..N)`` along its last axis (A from -1 to
    -N), ``Dskip`` -> ones, leaves of two or more axes -> normal 0.02
    drawn in f32 and cast, the rest (unstacked biases) -> zeros.  Drawn
    leaves are drawn in sorted path order on ``generator``'s device, then
    placed on ``device`` (the card unless ``device="cpu"``)."""
    return Model(cfg, tree_unflatten(param_shapes(cfg), [
        leaf for _, leaf in init_leaves(cfg, generator, device)]))


def init_leaves(cfg: ModelConfig, generator: torch.Generator,
                device: str = "cuda"):
    """``init_params``' leaves one at a time, as (dotted name, tensor) in
    sorted key order (its draw order): a caller that keeps a piece of each
    (``convert.shard_params``) never holds the whole tree."""
    dev = resolve_device(device)

    def one(name, s):
        nm = name.replace(".", "/").lower()
        if any(t in nm for t in ("norm", "ln1", "ln2", "/na", "/nm")):
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        if "gate" in nm:
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if "a_log" in nm:          # mamba: A in [-N..-1]
            # numpy's float32 log rounds as XLA's does for N <= 36
            # (torch's is an ulp off at some N)
            a = np.log(np.arange(1, s.shape[-1] + 1, dtype=np.float32))
            return torch.from_numpy(a).to(device=dev, dtype=s.dtype) \
                .expand(s.shape).contiguous()
        if "dskip" in nm:
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        if len(s.shape) >= 2:
            w = torch.randn(s.shape, generator=generator,
                            dtype=torch.float32,
                            device=generator.device).mul_(0.02)
            return w.to(s.dtype).to(dev)
        return torch.zeros(s.shape, dtype=s.dtype, device=dev)   # biases

    for name, spec in tree_paths(param_shapes(cfg)):
        yield name, one(name, spec)


def _embed(params: Model, cfg: ModelConfig, tokens, embeds):
    if cfg.inputs_embeds:
        return embeds.to(_dtype(cfg))
    # the gather as ``F.embedding`` (``sharding.embedding`` reads a split
    # table without gathering it)
    return embedding(tokens.long(), params.params.embed).to(_dtype(cfg))


def _logits(params: Model, cfg: ModelConfig, x):
    p = params.params
    head = p.embed.T if cfg.tie_embeddings else p.lm_head
    return apply_norm(x, p.final_norm, cfg) @ head


# The reference's activation checkpointing (``_remat_wrap`` and the
# "nested" branch of its ``forward``), as ``torch.utils.checkpoint``:
#   None, "none"     no checkpointing;
#   "full"           each layer checkpointed: only its input is kept, the
#                    rest recomputed in the backward (``jax.checkpoint``);
#   "dots"           each layer checkpointed, keeping the outputs of its
#                    matrix products (mm, addmm, bmm, baddbmm) and
#                    recomputing the rest: the counterpart of
#                    ``checkpoint_dots`` (torch has no such named policy);
#   "dots_no_batch"  the same keeping only the products without batch
#                    dimensions (mm, addmm), as
#                    ``checkpoint_dots_with_no_batch_dims``;
#   "nested"         groups of G layers checkpointed, G the largest divisor
#                    of the run's length up to its square root, and each
#                    layer inside a group checkpointed again.  The
#                    reference does this on runs of 4 layers or more and
#                    raises ValueError("nested") on shorter ones; the port
#                    checkpoints a shorter run's layers one by one.
# Every choice computes the same values; only what the backward keeps and
# recomputes differs.
REMATS = (None, "none", "full", "dots", "dots_no_batch", "nested")
_DOTS = {"dots": ("mm", "addmm", "bmm", "baddbmm"),
         "dots_no_batch": ("mm", "addmm")}


def _keep_dots(names, ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE
            if op.overloadpacket.__name__ in names
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpointed(fn, remat: str):
    """``fn`` run under ``torch.utils.checkpoint`` for ``remat``."""
    kw = {}
    if remat in _DOTS:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_keep_dots, _DOTS[remat]))

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return run


def _run_layers(layers, x, cfg, aux, remat, specs=None):
    """``x`` through ``layers`` (one run of the stack); returns x and the
    sum of their auxiliary losses.  ``specs``: the run's stage ``Spec``
    tree, for ``scan_param_fsdp``."""
    def one(x, layer):
        y, a = layer(x, cfg, aux, specs)
        return shard(y, ("batch", "seq", "embed")), a

    def seq(x, group):
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in group:
            x, a = step(x, layer)
            total = total + a
        return x, total

    if remat in (None, "none") or not torch.is_grad_enabled():
        step = one
        return seq(x, layers)
    step = _checkpointed(one, "full" if remat == "nested" else remat)
    if remat != "nested" or len(layers) < 4:
        return seq(x, layers)
    n = len(layers)
    G = next(g for g in range(int(n ** 0.5), 0, -1) if n % g == 0)
    inner = n // G
    group = _checkpointed(seq, "full")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(G):
        x, a = group(x, layers[g * inner: (g + 1) * inner])
        total = total + a
    return x, total


def forward(params: Model, cfg: ModelConfig, tokens=None, embeds=None,
            aux=None, remat: str | None = "full", last_only: bool = False,
            unroll: bool = False, scan_param_fsdp: bool = False):
    """Returns (logits (B,S,V), aux_loss ()).  tokens (B,S) int32 or
    embeds (B,S,D).  last_only: project only the final position (serving
    prefill — avoids the (B,S,V) logits tensor).  ``remat`` chooses the
    activation checkpointing of a backward (see REMATS; it changes no
    value).  ``unroll`` is the reference's loop form (the layers run
    unrolled here); it changes nothing.  ``scan_param_fsdp`` passes each
    layer's leaves through ``param_constraint`` (``launch/sharding``), as
    the reference pins them inside its layer scan."""
    del unroll
    if remat not in REMATS:
        raise ValueError(remat)
    aux = aux or {}
    x = shard(_embed(params, cfg, tokens, embeds), ("batch", "seq", "embed"))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = list(params.blocks)
    stages = param_shapes(cfg)["stages"] if scan_param_fsdp else None
    for key, off, cnt, _ in execution_runs(cfg):
        x, a = _run_layers(layers[:cnt], x, cfg, aux, remat,
                           stages[key] if stages else None)
        layers = layers[cnt:]
        aux_total = aux_total + a
    if last_only:
        x = x[:, -1:, :]
    logits = shard(_logits(params, cfg, x), ("batch", "seq", "vocab"))
    return logits, aux_total


def loss_fn(params: Model, cfg: ModelConfig, batch: dict,
            remat: str | None = "full", unroll: bool = False,
            scan_param_fsdp: bool = False):
    """Returns (nll + aux, {"nll", "aux"}) for ``batch``'s ``tokens`` (or
    ``embeds``), ``labels`` and optional ``image_embed``.  On a process
    mesh the loss's backward runs under the caller's ``rules_ctx``
    (``sharding.backward_in_ctx``), on whatever thread autograd runs it."""
    logits, aux = forward(params, cfg,
                          tokens=batch.get("tokens"),
                          embeds=batch.get("embeds"),
                          aux={k: v for k, v in batch.items()
                               if k in ("image_embed",)},
                          remat=remat, unroll=unroll,
                          scan_param_fsdp=scan_param_fsdp)
    nll = cross_entropy(logits, batch["labels"], cfg.logit_softcap)
    return backward_in_ctx(nll + aux), {"nll": nll, "aux": aux}


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
    # the residual stream laid out as ``forward`` lays it out (a layout
    # hint; on a process mesh it keeps DTensor from carrying partial sums
    # across layers)
    x = shard(_embed(params, cfg, tokens, embeds), ("batch", "seq", "embed"))
    for layer in params.blocks:
        x = shard(layer.decode(x, cfg, caches, aux), ("batch", "seq", "embed"))
    return _logits(params, cfg, x), caches
