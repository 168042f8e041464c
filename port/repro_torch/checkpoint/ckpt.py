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


def _host(t) -> torch.Tensor:
    """A host copy of ``t`` that later in-place updates do not touch."""
    t = torch.as_tensor(t).detach()
    return t.to("cpu", copy=True)


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
    """Synchronous save of a nested dict of tensors.  Returns the
    checkpoint dir."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in tree_paths(tree):
        t = torch.as_tensor(leaf).detach().cpu().contiguous()
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


def _load(path: pathlib.Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "uiV":
            raise ValueError(f"{path.name}: a bfloat16 leaf stored as "
                             f"{arr.dtype}")
        return torch.from_numpy(
            np.asarray(arr, order="C").view(np.uint16)).view(torch.bfloat16)
    t = torch.from_numpy(np.asarray(arr, order="C"))
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
    device, once the spec is checked against the leaf's shape.  A mesh of
    distinct devices raises ``NotImplementedError``."""
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
        t = _load(cd / meta["file"], meta["dtype"])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} in the "
                             f"checkpoint, {tuple(ref.shape)} expected")
        dev = ref.device
        if specs is not None:
            s = specs[i]
            if tuple(s.shape) != tuple(t.shape):
                raise ValueError(f"{name}: sharding of shape {s.shape}, "
                                 f"leaf {tuple(t.shape)}")
            s.shard_shape()      # raises if the spec does not split the leaf
            dev = s.mesh.device()
        out.append(t.to(dev))
    return tree_unflatten(tree_like, out), step
