"""The meters of the dry run's plan (``launch/dryrun``).

The reference compiles each cell and reads XLA's ``memory_analysis``,
``cost_analysis`` and the collectives of the compiled HLO
(``repro.launch.hlo_parse``).  The port compiles nothing: it runs the
step eagerly on ``meta`` tensors, which hold shapes and no memory, and
takes the same quantities from that run and from the resolved specs:

- :class:`StepMeter` watches every aten op of the run: the peak bytes of
  the storages the run allocated that were alive at once, and the bytes
  of each op's tensor operands and results;
- :func:`param_collectives` counts the parameter and gradient traffic the
  specs imply (the activations' collectives are left out);
- :class:`ShardMeter` watches a run of ``DTensor``s on one position of a
  :func:`fake_process_group`: the same meters over that position's local
  ops, and every collective DTensor issues, by kind.
"""

from __future__ import annotations

import contextlib
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves

__all__ = ["COLLECTIVES", "StepMeter", "ShardMeter", "fake_process_group",
           "tree_bytes", "param_collectives"]

# the reference's collective kinds (hlo_parse), in its order
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepMeter(TorchDispatchMode):
    """Over the aten ops run inside it: ``peak``, the most bytes of
    storages allocated by those ops alive at one time (a storage counts
    from the op that made it to its release; a view or an in-place result
    makes none), and ``accessed``, the bytes of every op's tensor operands
    and results (view ops move none)."""

    def __init__(self) -> None:
        super().__init__()
        self.live = 0
        self.peak = 0
        self.accessed = 0
        self._owned: set = set()

    def _free(self, key: int, n: int) -> None:
        self._owned.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ins = [t for t in _leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.accessed += sum(_nbytes(t) for t in ins + outs)
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._owned:
                continue
            seen.add(key)
            self._owned.add(key)
            n = st.nbytes()
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)


# torch's functional collectives (the ``_c10d_functional`` ops DTensor's
# redistributions issue, and its own shard all-to-all) by the reference's
# kinds
_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"))
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")


def _kind(func) -> str | None:
    """The collective kind of ``func``; None for an op that is no
    collective; KeyError for a collective of an unknown kind."""
    ns, name = func.namespace, func.__name__.split(".")[0]
    if ns == "_dtensor" and "alltoall" not in name:
        return None
    if ns not in ("_c10d_functional", "c10d_functional", "c10d",
                  "_dtensor") or name in _NOT_COLLECTIVES:
        return None
    for part, kind in _KINDS:
        if part in name:
            return kind
    raise KeyError(f"collective {ns}.{name} of no known kind")


def _sharding_propagation() -> tuple:
    """(class, method names) of DTensor's sharding propagation, which runs
    ops of global shapes on ``meta`` and fake tensors to learn an output's
    layout: no position's work, so :class:`ShardMeter` leaves them out.
    They are torch's private names, pinned here only; a torch without
    them raises rather than count that work as position 0's."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = ("propagate_op_sharding_non_cached",
             "_propagate_tensor_meta_non_cached")
    missing = [n for n in names if not hasattr(ShardingPropagator, n)]
    if missing:
        raise RuntimeError(
            f"torch {torch.__version__}'s ShardingPropagator has no "
            f"{missing}: ShardMeter cannot tell DTensor's sharding "
            "propagation from a position's ops")
    return ShardingPropagator, names


class ShardMeter(StepMeter):
    """:class:`StepMeter` over the local ops of one position of a run of
    ``DTensor``s (the ops DTensor runs on each rank's pieces, not the ops
    on ``DTensor``s, whose shapes are global, nor those of its sharding
    propagation), and ``collectives``: the result bytes of every
    collective the position takes part in, by the reference's five kinds
    (``counts``: how many; ``log``: their kinds in the order issued)."""

    def __init__(self) -> None:
        super().__init__()
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        self.log: list = []
        self._propagating = 0
        self._saved: list = []

    def __enter__(self):
        cls, names = _sharding_propagation()
        for name in names:
            fn = getattr(cls, name)
            self._saved.append((cls, name, fn))
            setattr(cls, name, self._flagged(fn))
        return super().__enter__()

    def __exit__(self, *exc):
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        self._saved = []
        return super().__exit__(*exc)

    def _flagged(self, fn):
        def run(*args, **kwargs):
            self._propagating += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._propagating -= 1
        return run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs the local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._propagating:
            return out
        self._count(func, args, kwargs, out)
        kind = _kind(func)
        if kind is not None:
            self.log.append(kind)
            self.counts[kind] += 1
            self.collectives[kind] += sum(
                _nbytes(t) for t in _leaves(out)
                if isinstance(t, torch.Tensor))
        return out


@contextlib.contextmanager
def fake_process_group(world: int):
    """A default process group of ``world`` ranks in this one process, as
    its rank 0, whose collectives move nothing: what a plan on ``meta``
    pieces needs to run ``DTensor``s of a mesh of ``world`` positions.
    It is torch's testing backend (``fake_pg``, a private module, imported
    here only); the group is destroyed on exit, and a process that already
    has a default group raises (it is global)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a fake process group needs a process without a "
                           "default group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def tree_bytes(tree) -> int:
    """Per-position bytes of a tree of :class:`Sharded` stand-ins."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.shard_bytes()


def _specs(tree) -> list:
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _specs(v)]
    return [tree]


def param_collectives(params, batch_axes: tuple, kind: str,
                      microbatch: int = 1) -> dict:
    """Per-position bytes of the collectives the parameter specs imply, by
    the reference's five kinds, each counted by its result's bytes as the
    HLO walk counts them:

    - an all-gather of each parameter over its FSDP axes (the batch axes
      "pod" and "data" in its spec) on every pass: one a forward, and in
      training one more a backward, for each of ``microbatch`` steps;
    - in training, a reduce-scatter of each FSDP-split gradient over those
      axes, and an all-reduce of each gradient over the batch axes
      ``batch_axes`` its spec leaves it replicated on.

    ``params`` is a tree of :class:`Sharded`; the gradient has its
    parameter's dtype and spec."""
    out = dict.fromkeys(COLLECTIVES, 0)
    passes = 2 * microbatch if kind == "train" else 1
    for s in _specs(params):
        sizes = s.mesh.axis_sizes
        used = {a for part in s.spec if part is not None
                for a in (part if isinstance(part, tuple) else (part,))}
        fsdp = [a for a in ("pod", "data") if a in used]
        f = math.prod(sizes[a] for a in fsdp)
        shard = s.shard_bytes()
        if f > 1:
            out["all-gather"] += passes * shard * f
        if kind == "train":
            if f > 1:
                out["reduce-scatter"] += shard
            if any(sizes[a] > 1 for a in batch_axes if a not in used):
                out["all-reduce"] += shard
    return out

