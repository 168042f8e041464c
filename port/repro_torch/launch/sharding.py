"""Logical-to-physical sharding rules (the port of ``repro.launch.sharding``).

Models annotate params/activations with logical axis names; a ShardingRules
table maps them to mesh axes.  Changing the table (not the model) is the
sharding lever.

A spec is :class:`P`, one entry a tensor dimension: None (replicated), a
mesh axis name, or a tuple of two or more names; entries are normalized as
``jax.sharding.PartitionSpec`` normalizes them, so that the two packages'
specs compare equal as tuples.

The reference hands each resolved spec to GSPMD
(``jax.lax.with_sharding_constraint``), which lays the tensor out over the
mesh.  The port runs one program on one device.  On a mesh whose positions
are all one device every layout is that device's whole tensor, so
:func:`constraint` and :func:`param_constraint` resolve the spec, check it
against the tensor (its rank, each split dividing its dimension, its
device) and return the tensor itself: what a layout hint computes there.
A mesh of two or more distinct devices needs each tensor split across
them, which the port does not do (ROADMAP, "multi-card model
execution"): they raise ``NotImplementedError`` rather than run
unsharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

from repro_torch.core.mesh import Mesh

__all__ = ["P", "ShardingRules", "DEFAULT_RULES", "Sharded", "rules_ctx",
           "current_rules", "constraint", "param_constraint",
           "logical_to_spec", "param_sharding", "shard_shape"]

# logical axis -> mesh axis (or None = replicated).  "batch" maps to the
# combined (pod, data) axes; "embed"/"heads"/"mlp"/"vocab"/"experts" are the
# tensor/FSDP dims.
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,           # activations: replicated along model by default
    "embed_fsdp": ("pod", "data"),  # params+opt: FSDP over pod x data (ZeRO-3)
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "layers": None,
    "qk": None, "v": None, "state": None, "conv": None, "lora": None,
    "image": None,
}


def _part(p):
    """One spec entry as ``PartitionSpec`` keeps it: () -> None, a 1-tuple
    -> its name."""
    if isinstance(p, (tuple, list)):
        p = tuple(p)
        return None if not p else (p[0] if len(p) == 1 else p)
    return p


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "model"))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_part(p) for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class ShardingRules(dict):
    def spec(self, axes: tuple) -> P:
        return P(*(self.get(a) for a in axes))


_tls = threading.local()


def current_rules():
    return getattr(_tls, "rules", None), getattr(_tls, "mesh_axes", None)


@contextlib.contextmanager
def rules_ctx(rules: ShardingRules | None, mesh: Mesh | None = None):
    old = (getattr(_tls, "rules", None), getattr(_tls, "mesh_axes", None),
           getattr(_tls, "mesh", None))
    _tls.rules = rules
    if mesh is not None:
        _tls.mesh_axes, _tls.mesh = mesh.axis_sizes, mesh
    elif rules is None:
        _tls.mesh_axes = _tls.mesh = None
    try:
        yield
    finally:
        _tls.rules, _tls.mesh_axes, _tls.mesh = old


def _axes_of(part) -> tuple:
    return part if isinstance(part, tuple) else (part,)


def _filter_spec(spec: P, mesh_axes: dict | None, shape=None) -> P:
    """Drop mesh axes not present in the current mesh, duplicates (first
    occurrence wins), and axes that do not divide the corresponding dim."""
    if mesh_axes is None:
        return spec
    used: set = set()
    parts = []
    for i, part in enumerate(spec):
        keep = tuple(a for a in _axes_of(part)
                     if a in mesh_axes and a not in used)
        if shape is not None and keep:
            sz = math.prod(mesh_axes[a] for a in keep)
            if sz and shape[i] % sz != 0:
                keep = ()
        used.update(keep)
        parts.append(keep)
    return P(*parts)


def shard_shape(shape: tuple, spec: P, mesh_axes: dict) -> tuple:
    """The per-position shape of a ``shape`` tensor laid out by ``spec``;
    ValueError when the spec has more entries than the tensor has
    dimensions or a split does not divide its dimension."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = list(shape)
    for i, part in enumerate(spec):
        if part is None:
            continue
        n = math.prod(mesh_axes[a] for a in _axes_of(part))
        if out[i] % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"split {n} ways ({spec})")
        out[i] //= n
    return tuple(out)


def _place(x: torch.Tensor, spec: P) -> torch.Tensor:
    """``x`` itself, once ``spec`` is checked against it and the current
    mesh (none: nothing to check)."""
    mesh = getattr(_tls, "mesh", None)
    if mesh is None:
        return x
    dev = mesh.device()
    shard_shape(tuple(x.shape), spec, mesh.axis_sizes)
    if x.device != dev:
        raise ValueError(f"a tensor on {x.device} under a mesh of {dev}")
    return x


def constraint(x, axes: tuple):
    """Activation sharding constraint by logical axes (``x`` itself without
    rules; see the module docstring for a mesh)."""
    rules, mesh_axes = current_rules()
    if rules is None:
        return x
    return _place(x, _filter_spec(rules.spec(axes), mesh_axes, x.shape))


def param_constraint(x, axes: tuple):
    """Parameter-rule (embed -> embed_fsdp) sharding constraint; the
    reference uses it inside the layer scan to pin per-layer param slices
    to their FSDP layout."""
    rules, mesh_axes = current_rules()
    if rules is None or len(axes) != x.ndim:
        return x
    parts = [rules.get("embed_fsdp" if a == "embed" else a) for a in axes]
    return _place(x, _filter_spec(P(*parts), mesh_axes, x.shape))


def logical_to_spec(rules: ShardingRules, axes: tuple,
                    param: bool = True, shape: tuple | None = None,
                    mesh: Mesh | None = None) -> P:
    """Resolve logical axes -> spec in one shape-aware pass.

    A mesh axis is assigned only if (a) it exists in the mesh, (b) it is not
    already used by an earlier dim, and (c) it divides the dim.  A later
    logical axis can therefore pick up a mesh axis an earlier one could not
    use (e.g. mixtral's 8 experts skip "model"; the per-expert mlp dim takes
    it instead)."""
    mesh_axes = mesh.axis_sizes if mesh else None
    used: set = set()
    parts = []
    for i, a in enumerate(axes):
        key = "embed_fsdp" if (param and a == "embed") else a
        keep = []
        for ax in _axes_of(rules.get(key)):
            if not ax or ax in used:
                continue
            if mesh_axes is not None:
                if ax not in mesh_axes:
                    continue
                dim = shape[i] if shape is not None else None
                cur = math.prod(mesh_axes[k] for k in keep)
                if dim is not None and dim % (cur * mesh_axes[ax]) != 0:
                    continue
            keep.append(ax)
        used.update(keep)
        parts.append(keep)
    return P(*parts)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A tensor's stand-in, the counterpart of a ``jax.ShapeDtypeStruct``
    with a ``NamedSharding``: global shape and dtype, spec and mesh."""
    shape: tuple
    dtype: torch.dtype
    spec: P
    mesh: Mesh

    def shard_shape(self) -> tuple:
        return shard_shape(self.shape, self.spec, self.mesh.axis_sizes)

    def shard_bytes(self) -> int:
        return math.prod(self.shard_shape()) * self.dtype.itemsize

    def meta(self) -> torch.Tensor:
        """A ``meta`` tensor of the global shape (no memory)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def param_sharding(mesh: Mesh, rules: ShardingRules, spec_tree):
    """Tree of parameter specs (``models.layers.Spec``, with ``.axes``) ->
    tree of :class:`Sharded`; a leaf without axes is replicated."""
    if isinstance(spec_tree, dict):
        return {k: param_sharding(mesh, rules, v)
                for k, v in sorted(spec_tree.items())}
    s = spec_tree
    axes = getattr(s, "axes", None)
    spec = P() if axes is None else logical_to_spec(rules, axes,
                                                     shape=s.shape, mesh=mesh)
    return Sharded(tuple(s.shape), s.dtype, spec, mesh)
