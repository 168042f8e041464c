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
  specs imply (the activations' collectives are left out).
"""

from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves

__all__ = ["COLLECTIVES", "StepMeter", "tree_bytes", "param_collectives"]

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
        return out


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

