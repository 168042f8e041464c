"""Recovery: MANIFEST replay -> live SSTables (mmap) -> WAL re-ingestion.

MANIFEST replay is checkpoint-then-tail: after a checkpoint compaction the
file named by CURRENT starts with one edit holding the entire folded state
(live files, counters, reclaimed segments, per-segment dead-entry
estimates), followed by whatever edits appended since — replaying in order
needs no special casing.  Orphan numbered manifests from a crash
mid-checkpoint are swept by ``StorageEngine`` before the writer reopens.

``load_tables`` turns a replayed :class:`ManifestState` into per-level
lists of mmap-backed :class:`SSTable` objects, with their persisted PLR
models reconstructed (no retraining — the whole point of serializing the
segments into the table files).  Unreferenced ``.sst`` files (a crash
between file write and manifest edit) are deleted as garbage.

The store drives the rest of the protocol: it re-ingests the old WAL's
batches through its normal write path (so they land in the fresh WAL and,
if the memtable fills, in new sstables), restores the value log's GC
bookkeeping (``vlog_removed``, ``vlog_dead``), then calls
``StorageEngine.finish_recovery``.
"""

from __future__ import annotations

import os

from repro_torch.core.lsm import N_LEVELS
from repro_torch.core.sstable import SSTable, advance_file_ids

from .format import sst_path
from .manifest import ManifestState
from .sstable_io import load_sstable

__all__ = ["load_tables"]


def load_tables(dirpath: str, state: ManifestState,
                verify: bool = True) -> list[list[SSTable]]:
    """Returns levels[0..N_LEVELS-1] rebuilt from the manifest's live set.

    L0 is ordered newest-first (higher file_id = later flush); deeper
    levels are sorted by min_key (disjoint ranges).
    """
    levels: list[list[SSTable]] = [[] for _ in range(N_LEVELS)]
    for fid, level in state.live.items():
        t = load_sstable(sst_path(dirpath, fid), verify=verify)
        if t.level != level or t.file_id != fid:
            raise ValueError(
                f"manifest/file mismatch for {fid}: "
                f"file says (id={t.file_id}, level={t.level}), "
                f"manifest says level {level}")
        levels[level].append(t)
    levels[0].sort(key=lambda t: t.file_id, reverse=True)
    for li in range(1, N_LEVELS):
        levels[li].sort(key=lambda t: t.min_key)
    if state.live:
        advance_file_ids(max(state.live) + 1)

    # sweep unreferenced table files (crash between write and manifest
    # edit), orphaned .tmp files (crash before the atomic os.replace), and
    # level-model sidecars the manifest no longer names (superseded epoch,
    # or an lmodel edit that tore before acknowledging the file)
    for name in os.listdir(dirpath):
        if name.endswith(".tmp"):
            os.unlink(os.path.join(dirpath, name))
        elif name.endswith(".sst"):
            fid = int(name.split(".")[0])
            if fid not in state.live:
                os.unlink(os.path.join(dirpath, name))
        elif name.startswith("lm-") and name.endswith(".plm"):
            level, epoch = (int(p) for p in name[3:-4].split("-"))
            if state.level_models.get(level) != epoch:
                os.unlink(os.path.join(dirpath, name))
        elif name.startswith("flt-") and name.endswith(".bf"):
            level, epoch = (int(p) for p in name[4:-3].split("-"))
            if state.filters.get(level) != epoch:
                os.unlink(os.path.join(dirpath, name))
    return levels
