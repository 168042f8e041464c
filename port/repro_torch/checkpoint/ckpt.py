"""Checkpoints: one ``.npy`` a leaf, committed by a manifest written last
(the port of ``repro.checkpoint.ckpt``).

Layout, the reference's: ``<dir>/step_<N>/``
    manifest.json            step, and per leaf its file, shape and dtype
    <leaf-name>__full.npy    one file a leaf, the whole (logical) array

Leaf names are dotted key paths in sorted key order, as the reference's
``tree_flatten_with_path`` names them (``o.m.stages.s0_attn_mlp.attn.wq``).
The manifest is written to ``manifest.json.tmp`` and renamed, so a crash
mid-save leaves no checkpoint that :func:`latest_step` would take.

Two faults of the reference are fixed here.  Its ``save`` writes a
bfloat16 leaf with ``np.save``, whose file holds the void dtype ``|V2``,
and its ``restore`` cannot load that back; the port writes a bfloat16 leaf
as its 16-bit pattern (``uint16``) and records ``"bfloat16"`` as the
leaf's dtype.  Its ``restore`` checks shapes only, though it says it
checks dtypes; the port's raises ``ValueError`` on either mismatch.
:func:`restore` also reads what the reference wrote: float and integer
leaves as they are, and a ``"bfloat16"`` leaf in ``|V2`` form as the same
16-bit pattern.

:class:`AsyncSaver` copies the tree to host memory before its thread
starts (the caller may then update its tensors in place) and keeps one
save in flight: the next save waits for the last.

On a process mesh (``DTensor`` leaves) every rank calls :func:`save` or
``save_async`` alike: each leaf is gathered whole, leaf by leaf (a
collective every rank joins), and rank 0 alone keeps the host copy and
writes the files and the manifest, in the same layout, so that the
checkpoint restores unsharded and the reference reads it.
:func:`restore` with ``shardings`` on a process mesh gives back
``DTensor``s: each rank reads each whole leaf and keeps its own piece.
"""

from __future__ import annotations

import json
import pathlib
import threading

import numpy as np
import torch

from repro_torch.models.layers import tree_leaves, tree_paths, tree_unflatten

__all__ = ["save", "save_async", "restore", "latest_step", "AsyncSaver"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float64": torch.float64,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _host(t) -> torch.Tensor | None:
    """A host copy of ``t`` that later in-place updates do not touch; of
    a ``DTensor``, the whole tensor on rank 0 and None on the others."""
    t = _whole(t)
    return None if t is None else t.to("cpu", copy=True)


def _whole(t) -> torch.Tensor | None:
    """``t`` itself, detached; a ``DTensor`` gathered whole (every rank
    joins), kept on rank 0 only (None on the others)."""
    if hasattr(t, "full_tensor"):
        import torch.distributed as dist
        t = t.detach().full_tensor()
        return t if dist.get_rank() == 0 else None
    return torch.as_tensor(t).detach()


def _dtype_name(t: torch.Tensor) -> str:
    if t.dtype not in _NAMES:
        raise ValueError(f"cannot checkpoint dtype {t.dtype}")
    return _NAMES[t.dtype]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """The array written for ``t``: a bfloat16 leaf as its bit pattern."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def save(tree, directory: str | pathlib.Path, step: int) -> pathlib.Path:
    """Synchronous save of a nested dict of tensors (on a process mesh,
    see the module docstring).  Returns the checkpoint dir."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    pairs = [(name, _whole(leaf)) for name, leaf in tree_paths(tree)]
    if any(t is None for _, t in pairs):
        return d                                  # not rank 0 of a mesh
    d.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for name, t in pairs:
        t = t.cpu().contiguous()
        fn = f"{name.replace('/', '_')}__full.npy"
        np.save(d / fn, _to_numpy(t))
        manifest["leaves"][name] = {
            "file": fn, "shape": list(t.shape), "dtype": _dtype_name(t)}
    tmp = d / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest))
    tmp.rename(d / "manifest.json")      # atomic commit
    return d


class AsyncSaver:
    """One in-flight async checkpoint at a time (back-pressure on the next
    save, like production async checkpointers)."""

    def __init__(self) -> None:
        self._thread: threading.Thread | None = None
        self.last_path: pathlib.Path | None = None

    def save_async(self, tree, directory, step: int) -> None:
        self.wait()
        host_tree = {}
        for name, leaf in tree_paths(tree):
            host_tree[name] = _host(leaf)
        if any(t is None for t in host_tree.values()):
            return                                # not rank 0 of a mesh

        def work():
            self.last_path = save(host_tree, directory, step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


_SAVER = AsyncSaver()


def save_async(tree, directory, step, saver=None) -> AsyncSaver:
    """``saver.save_async`` on one saver shared by every call that passes
    none, as the reference's default argument is."""
    saver = saver or _SAVER
    saver.save_async(tree, directory, step)
    return saver


def latest_step(directory) -> int | None:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.glob("step_*"):
        if (p / "manifest.json").exists():   # only committed checkpoints
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _load(path: pathlib.Path, dtype: str,
          mmap: bool = False) -> torch.Tensor:
    """The leaf in ``path`` (``mmap``: mapped, not read, so that a caller
    that cuts a piece of it reads only that piece)."""
    arr = np.load(path, mmap_mode="r" if mmap else None)
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "uiV":
            raise ValueError(f"{path.name}: a bfloat16 leaf stored as "
                             f"{arr.dtype}")
        bits = arr.view(np.uint16) if mmap else \
            np.asarray(arr, order="C").view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    t = torch.from_numpy(arr if mmap else np.asarray(arr, order="C"))
    if dtype not in _DTYPES or t.dtype != _DTYPES[dtype]:
        raise ValueError(f"{path.name}: manifest dtype {dtype}, file "
                         f"{arr.dtype}")
    return t


def restore(tree_like, directory, step: int | None = None,
            shardings=None):
    """Restore into the structure of ``tree_like`` (a nested dict of
    tensors): each leaf's shape and dtype must equal the saved ones, else
    ``ValueError``.  Returns (tree, step), each leaf a new tensor on its
    ``tree_like`` leaf's device, or with ``shardings`` (a tree of
    :class:`~repro_torch.launch.sharding.Sharded` of the same structure,
    as ``param_sharding`` and ``opt_state_specs`` give) on its spec's mesh
    device, once the spec is checked against the leaf's shape: on a
    process mesh, where the ``tree_like`` leaf is a ``DTensor``, a
    ``DTensor`` laid out by the spec (this rank's piece).
    A mesh of distinct devices raises ``NotImplementedError``."""
    from repro_torch.core.mesh import ProcessMesh
    from repro_torch.launch.sharding import distribute, local_shard

    d = pathlib.Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {d}")
    cd = d / f"step_{step:08d}"
    manifest = json.loads((cd / "manifest.json").read_text())
    leaves = manifest["leaves"]
    named = tree_paths(tree_like)
    specs = None if shardings is None else tree_leaves(shardings)
    if specs is not None and len(specs) != len(named):
        raise ValueError(f"{len(specs)} shardings for {len(named)} leaves")
    out = []
    for i, (name, ref) in enumerate(named):
        if name not in leaves:
            raise ValueError(f"{name}: not in the checkpoint at {cd}")
        meta = leaves[name]
        want = _dtype_name(ref)
        if meta["dtype"] != want:
            raise ValueError(f"{name}: dtype {meta['dtype']} in the "
                             f"checkpoint, {want} expected")
        s = specs[i] if specs is not None else None
        piece = s is not None and isinstance(s.mesh, ProcessMesh) and \
            hasattr(ref, "to_local")
        t = _load(cd / meta["file"], meta["dtype"], mmap=piece)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} in the "
                             f"checkpoint, {tuple(ref.shape)} expected")
        dev = ref.device
        if s is not None:
            if tuple(s.shape) != tuple(t.shape):
                raise ValueError(f"{name}: sharding of shape {s.shape}, "
                                 f"leaf {tuple(t.shape)}")
            s.shard_shape()      # raises if the spec does not split the leaf
            dev = s.mesh.device()
            if piece:            # this rank reads its piece alone (a copy:
                # the mapped file is read-only)
                out.append(distribute(t, s.spec, s.mesh, local=local_shard(
                    t, s.spec, s.mesh).to(dev, copy=True).contiguous()))
                continue
        out.append(t.to(dev))
    return tree_unflatten(tree_like, out), step
