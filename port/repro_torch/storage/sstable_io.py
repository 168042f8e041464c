"""SSTable file format: keys/seqs/vptrs + bloom + fences + learned model.

Layout (all offsets 8-byte aligned, little endian)::

    header (72 B): magic, file_id, level, bloom_k, n, n_blocks,
                   bloom_words, created_at, base_crc, model_offset
    keys   [n]        int64
    seqs   [n]        int64
    vptrs  [n]        int64
    fences [n_blocks] int64
    bloom  [W]        uint64
    model block (optional, appended when the file is learned):
        magic, n_segments, delta, crc, then starts/slopes/intercepts [ns] f64

Persisting the PLR segments *inside* the table file is the Bourbon move
(§4.2 "integrate the learned index with the storage format"): a reopened
store serves model-path lookups immediately, no retraining.  Because
learning is asynchronous, the model block is appended after the fact —
``append_model`` writes the block at EOF and patches ``model_offset`` in
the header (a single 8-byte in-place update, crash-safe: a torn patch
leaves offset 0 = "no model", never a dangling pointer, since the offset
is only written after the block itself is flushed).

Loading maps the file with ``np.memmap`` and returns array views over it
(zero-copy); the engine's device stacking copies out of these views.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from repro_torch.core.plr import PLRModel
from repro_torch.core.sstable import FileStats, SSTable

from .format import (MAGIC_FILTER, MAGIC_MODEL, MAGIC_SST, crc32, fsync_dir,
                     sst_path)

__all__ = ["write_sstable", "append_model", "load_sstable",
           "write_level_model", "load_level_model",
           "write_level_filter", "load_level_filter"]

_HDR = struct.Struct("<8sqiiqqqdIxxxxq")
HEADER_SIZE = _HDR.size          # 72, a multiple of 8
_MODEL_HDR = struct.Struct("<8siiIxxxx")  # 24 bytes, multiple of 8
_FILTER_HDR = struct.Struct("<8sqqiiIxxxx")  # 40 bytes, multiple of 8
_MODEL_OFF_POS = HEADER_SIZE - 8  # model_offset is the last header field


def _sections(table: SSTable) -> bytes:
    return (np.ascontiguousarray(table.keys, np.int64).tobytes()
            + np.ascontiguousarray(table.seqs, np.int64).tobytes()
            + np.ascontiguousarray(table.vptrs, np.int64).tobytes()
            + np.ascontiguousarray(table.fences, np.int64).tobytes()
            + np.ascontiguousarray(table.bloom, np.uint64).tobytes())


def _model_block(model: PLRModel) -> bytes:
    ns = int(model.n_segments)
    arrays = (np.asarray(model.starts, np.float64)[:ns].tobytes()
              + np.asarray(model.slopes, np.float64)[:ns].tobytes()
              + np.asarray(model.intercepts, np.float64)[:ns].tobytes())
    return _MODEL_HDR.pack(MAGIC_MODEL, ns, model.delta,
                           crc32(arrays)) + arrays


def write_sstable(dirpath: str, table: SSTable, fsync: bool = False) -> str:
    """Write a complete table file (including its model, if already fit)."""
    path = sst_path(dirpath, table.file_id)
    body = _sections(table)
    model_offset = 0
    model = b""
    if table.model is not None:
        model_offset = HEADER_SIZE + len(body)
        model = _model_block(table.model)
    hdr = _HDR.pack(MAGIC_SST, table.file_id, table.level, table.bloom_k,
                    table.n, table.fences.shape[0], table.bloom.shape[0],
                    table.created_at, crc32(body), model_offset)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(hdr)
        f.write(body)
        f.write(model)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic: readers never see a partial table
    if fsync:
        fsync_dir(dirpath)  # the rename itself must survive power loss
    return path


def append_model(path: str, model: PLRModel, fsync: bool = False) -> None:
    """Persist a just-learned model into an existing table file."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        offset = f.tell()
        f.write(_model_block(model))
        f.flush()
        if fsync:
            os.fsync(f.fileno())
        f.seek(_MODEL_OFF_POS)
        f.write(struct.pack("<q", offset))
        f.flush()
        if fsync:
            os.fsync(f.fileno())


def write_level_model(path: str, model: PLRModel, fsync: bool = False) -> None:
    """Persist a level-granularity model as a standalone sidecar file —
    the same model-block encoding that rides inside sstables, written via
    tmp + ``os.replace`` so a reader never sees a partial file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_model_block(model))
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        # the rename itself must be durable before the MANIFEST edit that
        # references this sidecar can be written
        fsync_dir(os.path.dirname(path) or ".")


def load_level_model(path: str, verify: bool = True) -> PLRModel | None:
    """Load a level-model sidecar; returns None when the file is missing,
    torn, or fails its checksum — a level model is always recomputable, so
    the caller falls back to relearning instead of refusing to open."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < _MODEL_HDR.size:
        return None
    magic, ns, delta, mcrc = _MODEL_HDR.unpack_from(data, 0)
    arrays = data[_MODEL_HDR.size: _MODEL_HDR.size + 3 * 8 * ns]
    if (magic != MAGIC_MODEL or len(arrays) < 3 * 8 * ns
            or (verify and crc32(arrays) != mcrc)):
        return None
    starts = np.frombuffer(arrays, np.float64, count=ns)
    slopes = np.frombuffer(arrays, np.float64, count=ns, offset=8 * ns)
    icepts = np.frombuffer(arrays, np.float64, count=ns, offset=16 * ns)
    return PLRModel(starts.copy(), slopes.copy(), icepts.copy(), int(ns),
                    delta=delta)


def write_level_filter(path: str, flt, fsync: bool = False) -> None:
    """Persist a level bloom filter as a standalone sidecar file —
    same tmp + ``os.replace`` publish discipline as level models, so a
    reader never sees a partial filter and the rename is durable before
    the MANIFEST ``filter`` record that points at it."""
    words = np.ascontiguousarray(flt.bits, np.uint64).tobytes()
    hdr = _FILTER_HDR.pack(MAGIC_FILTER, int(flt.n_keys), int(flt.n_words),
                           int(flt.k_hashes), int(flt.bits_per_key),
                           crc32(words))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(hdr)
        f.write(words)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(path) or ".")


def load_level_filter(path: str, verify: bool = True):
    """Load a filter sidecar; returns None when the file is missing, torn,
    or fails its checksum — a filter is always recomputable from the level's
    keys, so the caller rebuilds lazily instead of refusing to open."""
    from repro_torch.core.filters import LevelFilter
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < _FILTER_HDR.size:
        return None
    magic, n_keys, n_words, k_hashes, bpk, fcrc = _FILTER_HDR.unpack_from(
        data, 0)
    words = data[_FILTER_HDR.size: _FILTER_HDR.size + 8 * n_words]
    if (magic != MAGIC_FILTER or len(words) < 8 * n_words
            or (verify and crc32(words) != fcrc)):
        return None
    bits = np.frombuffer(words, np.uint64, count=n_words).copy()
    return LevelFilter(bits=bits, n_words=n_words, k_hashes=k_hashes,
                       bits_per_key=bpk, n_keys=n_keys)


def load_sstable(path: str, verify: bool = True) -> SSTable:
    """mmap the file and return an SSTable whose arrays view it zero-copy."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    (magic, file_id, level, bloom_k, n, n_blocks, n_words, created_at,
     base_crc, model_offset) = _HDR.unpack_from(mm[:HEADER_SIZE].tobytes(), 0)
    if magic != MAGIC_SST:
        raise ValueError(f"{path}: bad sstable magic {magic!r}")

    off = HEADER_SIZE

    def view(count, dtype):
        nonlocal off
        arr = np.frombuffer(mm, dtype, count=count, offset=off)
        off += count * arr.dtype.itemsize
        return arr

    keys = view(n, np.int64)
    seqs = view(n, np.int64)
    vptrs = view(n, np.int64)
    fences = view(n_blocks, np.int64)
    bloom = view(n_words, np.uint64)
    if verify and crc32(mm[HEADER_SIZE:off].tobytes()) != base_crc:
        raise ValueError(f"{path}: sstable body checksum mismatch")

    model = None
    if model_offset:
        mh = mm[model_offset: model_offset + _MODEL_HDR.size].tobytes()
        mmagic, ns, delta, mcrc = _MODEL_HDR.unpack(mh)
        if mmagic != MAGIC_MODEL:
            raise ValueError(f"{path}: bad model magic {mmagic!r}")
        aoff = model_offset + _MODEL_HDR.size
        if verify and crc32(mm[aoff: aoff + 3 * 8 * ns].tobytes()) != mcrc:
            raise ValueError(f"{path}: model checksum mismatch")
        starts = np.frombuffer(mm, np.float64, count=ns, offset=aoff)
        slopes = np.frombuffer(mm, np.float64, count=ns, offset=aoff + 8 * ns)
        icepts = np.frombuffer(mm, np.float64, count=ns, offset=aoff + 16 * ns)
        model = PLRModel(starts.copy(), slopes.copy(), icepts.copy(), int(ns),
                         delta=delta)

    return SSTable(keys=keys, seqs=seqs, vptrs=vptrs, fences=fences,
                   bloom=bloom, bloom_k=bloom_k, level=level, file_id=file_id,
                   created_at=created_at, model=model,
                   learn_submitted=model is not None,
                   stats=FileStats())
