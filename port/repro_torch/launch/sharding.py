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
mesh.  The port has two kinds of mesh:

- a :class:`~repro_torch.core.mesh.Mesh` of one device in one process
  (``cpu``, ``meta`` or one card, repeated): every layout there is that
  device's whole tensor, so :func:`constraint` and
  :func:`param_constraint` resolve the spec, check it against the tensor
  (its rank, each split dividing its dimension, its device) and return the
  tensor itself.  A mesh of distinct devices in one process raises
  ``NotImplementedError``;
- a :class:`~repro_torch.core.mesh.ProcessMesh`, one process a position
  (``launch/spmd``): every tensor is a ``DTensor``, and the two turn the
  resolved spec into its placements (:func:`placements`) and
  ``redistribute`` to them, as GSPMD does.  A plain tensor there raises:
  nothing runs unsharded behind the caller's back.  Under ``rules_ctx``
  with such a mesh, a plain tensor the model makes (a mask, the rotary
  frequencies, a position) counts as replicated
  (``implicit_replication``); the parameters, caches and inputs are laid
  out by their specs (:func:`distribute`, ``convert.shard_params``,
  ``launch/inputs.shard_caches``).  Two ops are written out by hand,
  where DTensor's own strategy gives a wrong result: :func:`index_copy_`,
  a cache row written in place on the rank that holds its slot, and
  :func:`embedding`, the lookup in a split table.  The MoE FFN's
  dispatch and combine run by hand on each rank's pieces
  (``models/moe``) through the collectives here: :func:`gather_ranks`,
  :func:`sum_ranks` and :func:`all_to_all`, torch's functional
  collectives.  Every block of the reference runs sharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

from repro_torch.core.mesh import Mesh, ProcessMesh

__all__ = ["P", "ShardingRules", "DEFAULT_RULES", "Sharded", "rules_ctx",
           "current_rules", "constraint", "param_constraint",
           "logical_to_spec", "param_sharding", "shard_shape", "placements",
           "distribute", "local_shard", "index_copy_", "embedding",
           "laid_out_as", "process_mesh", "split_axes", "whole_over",
           "piece_span", "rank_index", "gather_ranks", "sum_ranks",
           "all_to_all", "from_pieces"]

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
        with contextlib.ExitStack() as stack:
            if isinstance(_tls.mesh, ProcessMesh):
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
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


def placements(spec: P, mesh: ProcessMesh) -> tuple:
    """``spec`` as DTensor placements over ``mesh``'s axes: ``Shard(i)``
    on each mesh axis that entry ``i`` names, ``Replicate()`` on the rest.
    A dimension split by two or more axes takes them in mesh order, which
    is ``PartitionSpec``'s major-to-minor order; a spec naming them in
    another order raises ValueError, as does an axis the mesh lacks or one
    named twice."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.axis_names
    out = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        if part is None:
            continue
        axes = _axes_of(part)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, not an axis of "
                                 f"the mesh {names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dimension {i} over {axes}, "
                             f"not in the mesh's order {names}")
        for j in idx:
            if out[j] != Replicate():
                raise ValueError(f"spec {spec} names {names[j]!r} twice")
            out[j] = Shard(i)
    return tuple(out)


def _offsets(shape: tuple, places: tuple, mesh: ProcessMesh) -> list:
    """(start, length) of this rank's shard along each dimension of a
    ``shape`` tensor laid out by ``places`` (mesh axes in order, each
    cutting its dimension's current piece into equal parts)."""
    span = [(0, n) for n in shape]
    for c, n, pl in zip(mesh.coordinate, mesh.shape, places):
        if pl.is_shard():
            start, length = span[pl.dim]
            length //= n
            span[pl.dim] = (start + c * length, length)
    return span


def local_shard(t: torch.Tensor, spec: P, mesh: ProcessMesh) -> torch.Tensor:
    """This rank's piece of the whole tensor ``t`` laid out by ``spec``
    (a view)."""
    shard_shape(tuple(t.shape), spec, mesh.axis_sizes)
    for d, (start, length) in enumerate(
            _offsets(tuple(t.shape), placements(spec, mesh), mesh)):
        t = t.narrow(d, start, length)
    return t


def distribute(t: torch.Tensor, spec: P, mesh: ProcessMesh,
               local: torch.Tensor | None = None):
    """A ``DTensor`` of the global shape of ``t`` laid out by ``spec``,
    made from this rank's piece with no communication: every rank holds
    the same ``t`` (or a ``meta`` stand-in of it, with the piece given as
    ``local``)."""
    from torch.distributed.tensor import DTensor

    if local is None:
        local = local_shard(t, spec, mesh).contiguous()
    return DTensor.from_local(local, mesh.device_mesh,
                              placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=_contiguous(t.shape))


def _contiguous(shape) -> tuple:
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def _redistribute(x, spec: P, mesh: ProcessMesh):
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(f"a plain {tuple(x.shape)} tensor under a process "
                        f"mesh (spec {spec}): lay it out with "
                        "sharding.distribute")
    shard_shape(tuple(x.shape), spec, mesh.axis_sizes)
    want = placements(spec, mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh.device_mesh, want)
    return x


def index_copy_(dst, dim: int, index, src):
    """``dst.index_copy_(dim, index, src)`` for a one-element ``index``
    (a device tensor, never read on the host).  On a ``DTensor`` by hand:
    DTensor runs an in-place ``index_copy_`` on a redistributed copy of
    ``dst`` and leaves ``dst`` as it was (torch 2.13).  Here ``src`` is
    laid out as ``dst`` with ``dim`` whole, and each rank writes the row
    into its own piece when the slot falls in it (and its row back where
    it does not).  Returns ``dst``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(dst, DTensor):
        return dst.index_copy_(dim, index, src)
    mesh = process_mesh()
    want = tuple(Replicate() if p.is_shard(dim) else p
                 for p in dst.placements)
    if any(p.is_partial() for p in want):
        raise ValueError(f"a cache laid out as {dst.placements}")
    src = src.redistribute(mesh.device_mesh, want).to_local()
    start, length = _offsets(tuple(dst.shape), tuple(dst.placements),
                             mesh)[dim]
    idx = index.to_local() if isinstance(index, DTensor) else index
    i = idx - start
    ok = (i >= 0) & (i < length)
    i = i.clamp(0, length - 1)
    loc = dst.to_local()
    keep = loc.index_select(dim, i)
    loc.index_copy_(dim, i, torch.where(ok, src, keep))
    return dst


def embedding(tokens, table):
    """``F.embedding(tokens, table)``.  On ``DTensor``s, by hand: DTensor's
    own strategy pairs a vocab-split table with a masked partial sum whose
    mask it later applies to a tensor of another shape (an IndexError in
    torch 2.11 and 2.13).  Here the tokens are gathered whole over each
    mesh axis that splits the table, and each rank looks them up in its
    piece: over an axis splitting the vocabulary, a rank zeros the tokens
    outside its range and the result is a partial sum; over one splitting
    the embedding dimension, the result is split there too.  Over the
    other axes it keeps the tokens' layout.  The table itself is never
    gathered."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = process_mesh()
    if any(p.is_partial() for p in (*table.placements, *tokens.placements)):
        raise ValueError(f"an embedding of tokens laid out as "
                         f"{tokens.placements} in a table laid out as "
                         f"{table.placements}")
    tok = tuple(Replicate() if t.is_shard() else p
                for p, t in zip(tokens.placements, table.placements))
    tokens = tokens.redistribute(mesh.device_mesh, tok)
    start, length = _offsets(tuple(table.shape), tuple(table.placements),
                             mesh)[0]
    ids = tokens.to_local() - start
    ok = (ids >= 0) & (ids < length)
    rows = F.embedding(ids.clamp(0, length - 1), table.to_local())
    rows = rows * ok[..., None].to(rows.dtype)
    places = tuple(Partial() if t.is_shard(0) else
                   Shard(tokens.ndim) if t.is_shard(1) else p
                   for p, t in zip(tok, table.placements))
    shape = tuple(tokens.shape) + (table.shape[1],)
    return DTensor.from_local(rows, mesh.device_mesh, places,
                              run_check=False, shape=shape,
                              stride=_contiguous(shape))


def laid_out_as(t, ref):
    """``t`` redistributed to the placements of the DTensor ``ref``, a
    tensor of the same rank whose dimensions mean the same (a layout
    hint: a new value laid out as the cache it meets); ``t`` itself when
    either is a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not (isinstance(t, DTensor) and isinstance(ref, DTensor)) or \
            tuple(t.placements) == tuple(ref.placements):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def process_mesh() -> ProcessMesh:
    """The process mesh of the current ``rules_ctx``; TypeError outside
    one."""
    mesh = getattr(_tls, "mesh", None)
    if not isinstance(mesh, ProcessMesh):
        raise TypeError("a DTensor op outside rules_ctx of its process "
                        "mesh")
    return mesh


def split_axes(t, dim: int) -> tuple:
    """The mesh axes (indices, in mesh order) that split dimension ``dim``
    of the DTensor ``t``."""
    return tuple(i for i, p in enumerate(t.placements) if p.is_shard(dim))


def whole_over(t, dims: tuple):
    """The DTensor ``t`` redistributed so that each dimension in ``dims``
    is whole and no partial sum is left; the splits of the other
    dimensions stay.  A parameter's FSDP split (its "embed" dimension) is
    gathered so, as the reference gathers it for each forward."""
    from torch.distributed.tensor import Replicate

    mesh = process_mesh()
    want = tuple(Replicate() if p.is_partial() or any(
        p.is_shard(d) for d in dims) else p for p in t.placements)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh.device_mesh, want)
    return t


def piece_span(t, dim: int) -> tuple:
    """(start, length) of this rank's piece of dimension ``dim`` of the
    DTensor ``t``."""
    return _offsets(tuple(t.shape), tuple(t.placements),
                    process_mesh())[dim]


def rank_index(axes: tuple) -> tuple:
    """(index, count): this rank's position along the mesh axes ``axes``
    (indices) taken together, major to minor in mesh order, and their
    number of positions."""
    mesh = process_mesh()
    i, n = 0, 1
    for a in axes:
        i = i * mesh.shape[a] + mesh.coordinate[a]
        n *= mesh.shape[a]
    return i, n


def gather_ranks(local: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Every rank's ``local`` along the mesh axes ``axes`` (indices),
    stacked in :func:`rank_index` order: a plain (n, *local.shape) tensor,
    the same on every rank of those axes.  An all-gather of torch's
    functional collectives (so ``spmd.stage_through_host`` stages it and
    ``plan.ShardMeter`` counts it); ``local`` must be the same on the
    other axes."""
    from torch.distributed.tensor import Replicate, Shard

    places = tuple(Shard(0) if i in axes else Replicate()
                   for i in range(len(process_mesh().shape)))
    shape = (rank_index(axes)[1],) + tuple(local.shape)
    return from_pieces(local[None], places, shape).full_tensor()


def sum_ranks(local: torch.Tensor, axes: tuple) -> torch.Tensor:
    """The sum of every rank's ``local`` over the mesh axes ``axes``
    (indices), a plain tensor: an all-reduce of the functional
    collectives, as :func:`gather_ranks`."""
    from torch.distributed.tensor import Partial, Replicate

    places = tuple(Partial() if i in axes else Replicate()
                   for i in range(len(process_mesh().shape)))
    return from_pieces(local, places, tuple(local.shape)).full_tensor()


def all_to_all(local: torch.Tensor, axis: int) -> torch.Tensor:
    """Dimension 0 of ``local`` cut into as many equal chunks as the mesh
    axis ``axis`` (an index) has positions, chunk ``i`` sent to position
    ``i``; returns the chunks this rank received, in position order, as
    one tensor of ``local``'s shape.  Torch's functional all-to-all (so
    ``spmd.stage_through_host`` stages it and ``plan.ShardMeter`` counts
    it)."""
    from torch.distributed import _functional_collectives as funcol

    mesh = process_mesh()
    if local.shape[0] % mesh.shape[axis]:
        raise ValueError(f"{local.shape[0]} rows in {mesh.shape[axis]} "
                         "chunks")
    out = funcol.all_to_all_single(local.contiguous(), None, None,
                                   (mesh.device_mesh, axis))
    return funcol.wait_tensor(out)


def from_pieces(local: torch.Tensor, places: tuple, shape: tuple):
    """The DTensor of global ``shape`` whose piece on this rank is
    ``local``, laid out by ``places``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, process_mesh().device_mesh, places,
                              run_check=False, shape=tuple(shape),
                              stride=_contiguous(shape))


def _place(x: torch.Tensor, spec: P) -> torch.Tensor:
    """``x`` itself, once ``spec`` is checked against it and the current
    mesh (none: nothing to check); on a process mesh, ``x`` laid out by
    ``spec``."""
    mesh = getattr(_tls, "mesh", None)
    if mesh is None:
        return x
    if isinstance(mesh, ProcessMesh):
        return _redistribute(x, spec, mesh)
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
