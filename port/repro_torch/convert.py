"""Carry a store's state across from plain numpy arrays.

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
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, param_shapes

__all__ = ["store_from_numpy", "params_from_numpy"]


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
    dev = resolve_device(device)

    def leaf(spec, a, path):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, expected "
                             f"{spec.shape}")
        return torch.from_numpy(np.array(a, order="C")).to(
            device=dev, dtype=spec.dtype)

    def walk(specs, sub, path=()):
        if not isinstance(specs, dict):
            return leaf(specs, sub, path)
        if set(sub) != set(specs):
            raise ValueError(f"{'/'.join(path) or 'tree'}: keys "
                             f"{sorted(sub)}, expected {sorted(specs)}")
        return {k: walk(specs[k], sub[k], path + (k,)) for k in specs}

    return Model(cfg, walk(param_shapes(cfg), tree))
