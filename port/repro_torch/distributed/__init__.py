"""The durable, range-partitioned store (port of ``repro.distributed``)."""

from .sharded import (ShardedConfig, ShardedStore, ShardPendingBatch,
                      load_shard_snapshot, merge_live)

__all__ = ["ShardedConfig", "ShardedStore", "ShardPendingBatch",
           "load_shard_snapshot", "merge_live"]
