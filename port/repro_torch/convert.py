"""Carry a store's state, a model's parameters and an optimizer's state
across from plain numpy arrays.

``store_from_numpy(state, cfg)`` builds a port :class:`BourbonStore` whose
answers equal those of the store the arrays were taken from (for example a
``repro`` store read out with ``np.asarray``; this module never imports
it).  The ``state`` dict holds::

    levels:        [[file, ...] per level], each file a dict of
                   keys, seqs, vptrs, fences, bloom (uint64), bloom_k,
                   level, file_id, created_at and model (None or a dict of
                   starts, slopes, intercepts, n_segments)
    vlog_buf:      (capacity, value_size) uint8;  vlog_head: int
    memtable:      dict of keys, seqs, vptrs (arrival order)
    level_filters: [None or dict of bits, n_words, k_hashes, bits_per_key,
                    n_keys, epoch] per level
    level_models:  [None or dict of starts, slopes, intercepts, n_segments,
                    epoch] per level (level granularity; optional)
    level_version: [int] per level;  seq: int;  clock: float

Level models and filters are carried as current for the carried level
versions, with their epochs, so the converted store neither relearns nor
rebuilds them.

``shard_params(params, mesh, rules)`` lays a model's parameters out over
a process mesh, each leaf a ``DTensor`` by its ``param_sharding`` spec;
``shard_opt_state(state, mesh, rules, cfg)`` lays out an AdamW state
(numpy, or the port's unsharded one) by ``steps.opt_state_specs``, and
``tree_to_numpy`` gathers any such tree back whole.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.filters import LevelFilter
from repro_torch.core.lsm import N_LEVELS
from repro_torch.core.plr import PLRModel
from repro_torch.core.sstable import SSTable, advance_file_ids
from repro_torch.core.store import BourbonStore, StoreConfig
from repro_torch.launch.sharding import (distribute, local_shard,
                                         param_sharding)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_paths, tree_unflatten
from repro_torch.models.model import Model, param_shapes

__all__ = ["store_from_numpy", "params_from_numpy", "opt_state_from_numpy",
           "shard_params", "shard_opt_state", "tree_to_numpy"]


def _model(m: dict | None, delta: int) -> PLRModel | None:
    if m is None:
        return None
    return PLRModel(np.asarray(m["starts"], np.float64),
                    np.asarray(m["slopes"], np.float64),
                    np.asarray(m["intercepts"], np.float64),
                    int(m["n_segments"]), delta=delta,
                    epoch=int(m.get("epoch", -1)))


def _table(d: dict, delta: int) -> SSTable:
    model = _model(d.get("model"), delta)
    return SSTable(keys=np.ascontiguousarray(d["keys"], np.int64),
                   seqs=np.ascontiguousarray(d["seqs"], np.int64),
                   vptrs=np.ascontiguousarray(d["vptrs"], np.int64),
                   fences=np.ascontiguousarray(d["fences"], np.int64),
                   bloom=np.ascontiguousarray(d["bloom"], np.uint64),
                   bloom_k=int(d["bloom_k"]), level=int(d["level"]),
                   file_id=int(d["file_id"]),
                   created_at=float(d["created_at"]), model=model)


def store_from_numpy(state: dict, cfg: StoreConfig) -> BourbonStore:
    st = BourbonStore(cfg)
    delta = cfg.lsm.plr_delta
    levels = [[_table(d, delta) for d in lvl] for lvl in state["levels"]]
    if len(levels) != N_LEVELS:
        raise ValueError(f"expected {N_LEVELS} levels, got {len(levels)}")
    st.tree.levels = levels
    st.tree.level_version = [int(v) for v in state["level_version"]]
    ids = [t.file_id for t in st.tree.all_files()]
    if ids:
        advance_file_ids(max(ids) + 1)
    buf = np.asarray(state["vlog_buf"], np.uint8)
    if buf.ndim != 2 or buf.shape[1] != cfg.value_size:
        raise ValueError(f"vlog_buf must be (n, {cfg.value_size}) uint8")
    st.vlog._buf = buf.copy()
    st.vlog._head = int(state["vlog_head"])
    mt = state["memtable"]
    mk = np.asarray(mt["keys"], np.int64)
    if mk.shape[0]:
        st.memtable.put_batch(mk, np.asarray(mt["seqs"], np.int64),
                              np.asarray(mt["vptrs"], np.int64))
    epochs = []
    for li, f in enumerate(state["level_filters"]):
        if f is None:
            continue
        st.level_filters[li] = LevelFilter(
            bits=np.asarray(f["bits"], np.uint64), n_words=int(f["n_words"]),
            k_hashes=int(f["k_hashes"]), bits_per_key=int(f["bits_per_key"]),
            n_keys=int(f["n_keys"]), epoch=int(f["epoch"]))
        epochs.append(int(f["epoch"]))
    # carried filters are current for their level versions: no rebuild
    st._filter_versions = list(st.tree.level_version)
    for li, m in enumerate(state.get("level_models") or [None] * N_LEVELS):
        st.level_models[li] = _model(m, delta)
        if m is not None:
            epochs.append(int(m["epoch"]))
    st._level_model_versions = list(st.tree.level_version)
    if epochs:
        st.executor.next_model_epoch = max(epochs) + 1
    st._seq = int(state["seq"])
    st.clock.advance(float(state["clock"]))
    # unlearned files re-enter the learning pipeline, as after recovery
    st._pending_wait.extend(t for t in st.tree.all_files() if t.model is None)
    return st


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str = "cuda") -> Model:
    """The port's model holding the reference parameter ``tree`` (numpy
    leaves, bf16 ones as float32) on ``device``."""
    leaf = _leaf(resolve_device(device))
    return Model(cfg, _walk(param_shapes(cfg), tree, leaf))


def _leaf(dev: torch.device, dtype: torch.dtype | None = None):
    """``leaf(spec, array, path)``: the array, of the spec's shape, as a
    tensor of ``dtype`` (else the spec's) on ``dev``."""
    def leaf(spec, a, path):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, expected "
                             f"{spec.shape}")
        return torch.from_numpy(np.array(a, order="C")).to(
            device=dev, dtype=dtype or spec.dtype)
    return leaf


def _walk(specs, sub, leaf, path=()):
    """``leaf(spec, array, path)`` over ``sub``, whose keys must be those
    of the spec tree ``specs``."""
    if not isinstance(specs, dict):
        return leaf(specs, sub, path)
    if not isinstance(sub, dict) or set(sub) != set(specs):
        keys = sorted(sub) if isinstance(sub, dict) else type(sub).__name__
        raise ValueError(f"{'/'.join(path) or 'tree'}: keys {keys}, "
                         f"expected {sorted(specs)}")
    return {k: _walk(specs[k], sub[k], leaf, path + (k,)) for k in specs}


def opt_state_from_numpy(state: dict, cfg: ModelConfig,
                         device: str = "cuda") -> dict:
    """The port's AdamW state (``optim.adamw_init``'s tree) holding the
    reference's ``state`` (numpy leaves): ``step`` as an int32 scalar and
    ``m``, ``v`` and, when present, ``master`` as float32 trees shaped
    like the parameters of ``cfg``, on ``device``."""
    dev = resolve_device(device)
    specs = param_shapes(cfg)
    leaf = _leaf(dev, torch.float32)
    extra = set(state) - {"step", "m", "v", "master"}
    if extra or not {"step", "m", "v"} <= set(state):
        raise ValueError(f"optimizer state keys {sorted(state)}, expected "
                         "step, m, v and optionally master")
    out = {"step": torch.tensor(int(np.asarray(state["step"])),
                                dtype=torch.int32, device=dev)}
    for k in ("m", "v", "master"):
        if k in state:
            out[k] = _walk(specs, state[k], leaf, (k,))
    return out


def shard_params(params, mesh, rules, cfg: ModelConfig | None = None) -> Model:
    """The port's model with every parameter a ``DTensor`` on the process
    ``mesh``, laid out by its ``param_sharding`` spec under ``rules``.

    ``params`` is a :class:`Model` (``params_from_numpy`` from the
    reference's numpy tree, or ``init_params``), or ``models.init_leaves``'
    (name, tensor) pairs with ``cfg``: every rank makes the same whole
    leaves, keeps its own piece of each and drops the rest before the next
    leaf.  The ranks make each leaf in turn (a barrier a leaf), so that
    ranks that share one card never hold more than one whole leaf at
    once."""
    import torch.distributed as dist

    if isinstance(params, Model):
        cfg = params.cfg
        leaves, turns = iter(tree_paths(params.tree())), False
    elif cfg is None:
        raise ValueError("leaves without their config")
    else:
        leaves, turns = iter(params), True
    specs = param_sharding(mesh, rules, param_shapes(cfg))
    rank, world = dist.get_rank(), dist.get_world_size()
    out = []
    for name, want in tree_paths(specs):
        piece = None
        for r in range(world if turns else 1):
            if not turns or r == rank:
                got, whole = next(leaves)
                if got != name or tuple(whole.shape) != want.shape:
                    raise ValueError(f"leaf {got} {tuple(whole.shape)}, "
                                     f"expected {name} {want.shape}")
                piece = local_shard(whole, want.spec, mesh)
                piece = piece.clone() if piece.is_contiguous() \
                    else piece.contiguous()
                stand_in = torch.empty(want.shape, dtype=whole.dtype,
                                       device="meta")
                del whole
                if piece.is_cuda:
                    torch.cuda.empty_cache()
            if turns:
                dist.barrier()
        out.append(distribute(stand_in, want.spec, mesh, local=piece))
    return Model(cfg, tree_unflatten(specs, out))


def shard_opt_state(state: dict, mesh, rules, cfg: ModelConfig) -> dict:
    """The AdamW state on the process ``mesh``: ``m``, ``v`` and, when
    present, ``master`` each a tree of float32 ``DTensor``s laid out as
    their parameters (``steps.opt_state_specs``), ``step`` a plain int32
    scalar on the mesh's device.  ``state`` is the reference's (numpy
    leaves) or the port's unsharded one (tensors); every rank holds the
    same and keeps its own piece of each leaf."""
    if not isinstance(state["step"], torch.Tensor):       # numpy
        state = opt_state_from_numpy(state, cfg, "cpu")
    dev = mesh.device()
    specs = param_sharding(mesh, rules, param_shapes(cfg))
    out = {"step": torch.as_tensor(state["step"]).to(dev, torch.int32)}
    for k in ("m", "v", "master"):
        if k in state:
            got = dict(tree_paths(state[k]))
            out[k] = tree_unflatten(specs, [
                distribute(got[name], s.spec, mesh,
                           local=local_shard(got[name], s.spec, mesh)
                           .to(dev, torch.float32).contiguous())
                for name, s in tree_paths(specs)])
    return out


def tree_to_numpy(tree):
    """A nested dict of tensors or ``DTensor``s (each gathered whole: a
    collective every rank of the mesh joins) as numpy, floats as float32
    (bfloat16 exactly)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.full_tensor() if hasattr(tree, "full_tensor") else tree
    t = t.detach()
    if t.is_floating_point():
        t = t.float()
    return np.array(t.cpu().numpy())          # a copy, never a view
