"""Durable storage for BourbonStore: WAL, on-disk SSTables with persisted
PLR models, MANIFEST version edits, and a segmented value log with
WiscKey-style garbage collection — host code copied from ``repro.storage``,
writing the same bytes, so a directory written by either package opens in
the other.  ``src/repro/storage/README.md`` documents the file formats and
the recovery/GC protocols."""

from .engine import StorageEngine
from .manifest import (ManifestState, ManifestWriter, checkpoint_edit,
                       read_manifest, set_current)
from .recovery import load_tables
from .sstable_io import (append_model, load_level_filter, load_level_model,
                         load_sstable, write_level_filter, write_level_model,
                         write_sstable)
from .vlog import DurableValueLog
from .wal import WALWriter, replay_wal

__all__ = [
    "StorageEngine", "ManifestState", "ManifestWriter", "checkpoint_edit",
    "read_manifest", "set_current", "load_tables", "append_model",
    "load_sstable", "write_sstable", "load_level_model", "write_level_model",
    "load_level_filter", "write_level_filter",
    "DurableValueLog", "WALWriter", "replay_wal",
]
