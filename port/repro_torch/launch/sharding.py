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
           "current_rules", "backward_in_ctx", "constraint", "param_constraint",
           "logical_to_spec", "param_sharding", "shard_shape", "placements",
           "distribute", "local_shard", "index_copy_", "embedding",
           "cross_entropy", "by_heads", "on_pieces", "laid_out_as", "process_mesh", "split_axes", "whole_over",
           "piece_span", "rank_index", "gather_ranks", "sum_ranks",
           "reduce_ranks", "grad_summed", "all_to_all", "from_pieces"]

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


def _state() -> tuple:
    """This thread's (rules, mesh axis sizes, mesh): its :func:`rules_ctx`'s
    or, on a thread with none, while autograd runs the backward of a loss
    that went through :func:`backward_in_ctx`, that loss's."""
    here = (getattr(_tls, "rules", None), getattr(_tls, "mesh_axes", None),
            getattr(_tls, "mesh", None))
    task = getattr(_tls, "backward", None)
    if here == (None, None, None) and task is not None and \
            task[0] == torch._C._current_graph_task_id():
        return task[1]
    return here


def current_rules():
    return _state()[:2]


def backward_in_ctx(loss):
    """``loss``, whose backward runs under the current :func:`rules_ctx` of
    a process mesh on whatever thread autograd runs it.  On a card that is
    autograd's device thread: autograd hands it the caller's dispatch
    state (DTensor's implicit replication among it), but not Python's
    thread-locals, so a layer recomputed there (remat), or a hand
    collective's backward, would run without the rules and the mesh.  A
    hook on ``loss``, the backward's first step, hands them to that
    thread for this backward alone: :func:`_state` reads them only while
    autograd runs the graph task that set them, so a later backward on
    the thread (an unsharded one, say) sees none of them."""
    state = _state()
    if not isinstance(state[2], ProcessMesh) or not loss.requires_grad:
        return loss

    def enter(grad):
        _tls.backward = (torch._C._current_graph_task_id(), state)
        return grad
    loss.register_hook(enter)
    return loss


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
                # DTensor's implicit replication, the flag put back as it
                # was (torch's ``implicit_replication`` clears it on exit,
                # which would end an outer context's too: a recomputation
                # in the backward enters this context again)
                from torch.distributed.tensor import DTensor
                disp = DTensor._op_dispatcher
                stack.callback(setattr, disp, "_allow_implicit_replication",
                               disp._allow_implicit_replication)
                disp._allow_implicit_replication = True
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


def cross_entropy(logits, labels, softcap: float = 0.0):
    """Mean token NLL in f32 of DTensor ``logits`` (B, S, V) against
    ``labels`` (B, S), by hand: DTensor's own strategy gathers the gold
    logit from a vocab-split tensor through the same masked partial sum as
    :func:`embedding`'s, and fails the same way.  Each rank works on its
    piece of the logits (``softcap`` applied first, as in the plain
    version).  The log-sum-exp over a split vocabulary is each piece's max
    reduced by max, then its summed exp reduced by sum; the gold logit is
    taken from the piece that holds it (zeros elsewhere) and reduced by
    sum; the loss is the sum over the rows a rank holds, reduced over the
    axes splitting the rows, over the global token count.  Its backward
    is the plain version's, ``softmax - onehot`` over the count, on each
    rank's piece with no collective.  Returns a replicated scalar
    DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = process_mesh()
    logits = whole_over(logits, ())                 # no partial sum left
    want = tuple(p if p.is_shard() and p.dim < 2 else Replicate()
                 for p in logits.placements)
    if not isinstance(labels, DTensor):
        raise TypeError("plain labels under a process mesh: lay them out "
                        "with inputs.shard_batch")
    lab = labels.redistribute(mesh.device_mesh, want).to_local()
    lg = logits.to_local().float()
    if softcap:
        lg = torch.tanh(lg / softcap) * softcap
    vaxes = split_axes(logits, 2)
    raxes = tuple(sorted(split_axes(logits, 0) + split_axes(logits, 1)))
    count = labels.shape[0] * labels.shape[1]
    loss = _Nll.apply(lg, lab.long(), piece_span(logits, 2)[0], vaxes,
                      raxes, count)
    return from_pieces(loss, (Replicate(),) * len(mesh.shape), ())


class _Nll(torch.autograd.Function):
    """:func:`cross_entropy` on one rank's piece ``lg`` (b, s, v) of the
    logits, whose vocabulary starts at ``start``."""

    @staticmethod
    def forward(ctx, lg, lab, start, vaxes, raxes, count):
        m = lg.amax(dim=-1)
        if vaxes:
            m = reduce_ranks(m, vaxes, "max")
        se = torch.exp(lg - m[..., None]).sum(dim=-1)
        if vaxes:
            se = reduce_ranks(se, vaxes)
        logz = m + torch.log(se)
        idx = lab - start
        ok = (idx >= 0) & (idx < lg.shape[-1])
        idx = idx.clamp(0, lg.shape[-1] - 1)
        gold = torch.gather(lg, -1, idx[..., None])[..., 0] * ok
        if vaxes:
            gold = reduce_ranks(gold, vaxes)
        total = torch.sum(logz - gold)
        if raxes:
            total = reduce_ranks(total, raxes)
        ctx.save_for_backward(lg, logz, idx, ok)
        ctx.count = count
        return total / count

    @staticmethod
    def backward(ctx, g):
        lg, logz, idx, ok = ctx.saved_tensors
        g = g / ctx.count
        grad = g * torch.exp(lg - logz[..., None])
        grad.scatter_add_(-1, idx[..., None],
                          torch.where(ok, -g, 0.0)[..., None].to(grad.dtype))
        return grad, None, None, None, None, None


def by_heads(t, shape: tuple):
    """``t.reshape(shape)``, where one dimension of ``t`` is cut in two
    (H * hd into heads of hd, or H heads into KV groups of g), or two are
    merged into one (heads of hd into H * hd).  On a DTensor outside
    inference mode, whose cut dimension is split over a count of positions
    that does not divide the first of the two (qwen2-0.5b's 14 heads, or
    mixtral's 8 KV groups, on a "model" axis of 16), that split is
    gathered whole first, as GSPMD gathers a split that does not divide:
    DTensor's reshape is then a strict view and refuses to cut unevenly
    (inside inference mode it copies).  A merge's backward is the cut of
    its gradient, which DTensor may hand back split on the merged
    dimension (by the product it feeds): there the gradient is gathered
    so first."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor) or torch.is_inference_mode_enabled():
        return t.reshape(shape)
    d = next(i for i, (a, b) in enumerate(zip(t.shape, shape)) if a != b)
    if len(shape) < t.ndim:
        return _CutGrad.apply(t.reshape(shape), d, t.shape[d])
    if shape[d] % math.prod(t.device_mesh.shape[a]
                            for a in split_axes(t, d)):
        t = whole_over(t, (d,))
    return t.reshape(shape)


class _CutGrad(torch.autograd.Function):
    """The identity, whose gradient's dimension ``d`` is gathered whole
    where its split does not divide ``first`` (the merged dimension's
    first part, which the reshape's backward cuts it into)."""

    @staticmethod
    def forward(ctx, t, d, first):
        ctx.d, ctx.first = d, first
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        if ctx.first % math.prod(g.device_mesh.shape[a]
                                 for a in split_axes(g, ctx.d)):
            g = g.redistribute(g.device_mesh, tuple(
                Replicate() if p.is_shard(ctx.d) else p
                for p in g.placements))
        return g, None, None


def on_pieces(lead, others: tuple, dims: tuple, weights: tuple = ()):
    """For work that runs independently along ``dims`` (a batch and heads):
    when ``lead`` is a DTensor outside inference mode split only on
    ``dims``, and each of ``others`` (whose dimensions ``dims`` mean what
    the lead's do) can be laid out alike, returns (the local pieces of
    ``lead``, of ``others`` and of ``weights`` so laid out, ``wrap``),
    ``wrap(local, shape)`` making a result of global ``shape`` laid out as
    ``lead`` from this rank's piece.  Else None.

    ``weights`` are (tensor, {lead dimension: its dimension}) pairs: a
    value the same for every row of the batch (a parameter), split as the
    lead on the mapped dimensions (heads) and whole on the rest.  Its
    piece's gradient is a partial sum over the mesh axes that split the
    lead on the other dimensions (the batch), which autograd then reduces
    into the weight's layout.

    DTensor's strategies would run such work (attention's products) as
    batched products, whose flatten of two split batch dimensions torch
    2.11 refuses outside inference mode; on the pieces each rank runs its
    own batch rows and heads, with no collective."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(lead, DTensor) or torch.is_inference_mode_enabled():
        return None
    if any(p.is_partial() or p.is_shard() and p.dim not in dims
           for p in lead.placements):
        return None
    sizes = lead.device_mesh.shape
    split = [(d, math.prod(sizes[a] for a in split_axes(lead, d)))
             for d in dims]
    pairs = [(t, {d: d for d in dims}) for t in others] + list(weights)
    for t, dmap in pairs:
        if not isinstance(t, DTensor) or \
                any(t.shape[dmap[d]] % n for d, n in split if d in dmap):
            return None
    pieces = [lead.to_local()]
    for t, dmap in pairs:
        places = tuple(Shard(dmap[p.dim]) if p.is_shard() and p.dim in dmap
                       else Replicate() for p in lead.placements)
        grads = tuple(Partial() if p.is_shard() and p.dim not in dmap
                      else q for p, q in zip(lead.placements, places))
        t = whole_over(t, ())
        if tuple(t.placements) != places:
            t = t.redistribute(t.device_mesh, places)
        pieces.append(t.to_local(grad_placements=grads))

    def wrap(local, shape):
        return from_pieces(local.contiguous(), tuple(lead.placements),
                           tuple(shape))
    return pieces, wrap


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
    mesh = _state()[2]
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


def sum_ranks(local: torch.Tensor, axes: tuple,
              partial_grad: bool = False) -> torch.Tensor:
    """The sum of every rank's ``local`` over the mesh axes ``axes``
    (indices), a plain tensor: an all-reduce of the functional
    collectives, as :func:`gather_ranks`.  Its backward hands each rank
    the gradient of the sum as that rank sees it, when every rank reads
    the sum alike (an aux loss); with ``partial_grad`` each rank reads it
    its own way (its own slice of a product), so the backward sums the
    ranks' gradients (an all-reduce)."""
    from torch.distributed.tensor import Partial, Replicate

    n = len(process_mesh().shape)
    places = tuple(Partial() if i in axes else Replicate() for i in range(n))
    grad = tuple(Partial() if i in axes else Replicate()
                 for i in range(n)) if partial_grad else None
    return from_pieces(local, places, tuple(local.shape)).full_tensor(
        grad_placements=grad)


def grad_summed(local: torch.Tensor, axes: tuple) -> torch.Tensor:
    """``local`` itself, whose gradient is summed over the mesh axes
    ``axes`` (indices) in the backward: the entry of a value that every
    rank of those axes holds alike into work each does its own share of
    (each rank's experts), so that each then holds the whole gradient."""
    return _GradSummed.apply(local, tuple(axes)) if axes else local


class _GradSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, axes):
        ctx.axes = axes
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        return reduce_ranks(g.contiguous(), ctx.axes), None


def reduce_ranks(local: torch.Tensor, axes: tuple, op: str = "sum"):
    """The ``op`` ("sum" or "max") of every rank's ``local`` over the mesh
    axes ``axes`` (indices), a plain tensor, with no backward: an
    all-reduce of the functional collectives, as :func:`sum_ranks`."""
    from torch.distributed.tensor import Partial, Replicate

    places = tuple(Partial(op) if i in axes else Replicate()
                   for i in range(len(process_mesh().shape)))
    with torch.no_grad():
        return from_pieces(local, places, tuple(local.shape)).full_tensor()


def all_to_all(local: torch.Tensor, axis: int) -> torch.Tensor:
    """Dimension 0 of ``local`` cut into as many equal chunks as the mesh
    axis ``axis`` (an index) has positions, chunk ``i`` sent to position
    ``i``; returns the chunks this rank received, in position order, as
    one tensor of ``local``'s shape.  Torch's functional all-to-all (so
    ``spmd.stage_through_host`` stages it and ``plan.ShardMeter`` counts
    it).  Its backward is the same all-to-all of the gradient, which
    sends each chunk's gradient back to the rank it came from (written
    here: torch 2.11's functional all-to-all has no autograd formula)."""
    if local.shape[0] % process_mesh().shape[axis]:
        raise ValueError(f"{local.shape[0]} rows in "
                         f"{process_mesh().shape[axis]} chunks")
    return _AllToAll.apply(local, axis)


def _all_to_all(local: torch.Tensor, axis: int) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    out = funcol.all_to_all_single(local.contiguous(), None, None,
                                   (process_mesh().device_mesh, axis))
    return funcol.wait_tensor(out)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, axis):
        ctx.axis = axis
        return _all_to_all(local, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.axis), None


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
    mesh = _state()[2]
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
