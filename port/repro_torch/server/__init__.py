"""Batched request-serving front end over the sharded Bourbon store: a
bounded :class:`RequestQueue` + coalescing :class:`Batcher`, a
snapshot-consistent multi-get, the epoch-invalidated
:class:`HotKeyCache`, and the :class:`FleetMaintenanceCoordinator` that
staggers and budgets per-shard GC/checkpointing.  Two tick loops serve
requests: the synchronous :class:`BourbonServer` and the
:class:`PipelinedServer`, which keeps up to ``max_inflight`` read
batches in flight (dispatch/resolve split, writes as barriers,
maintenance in post-drain bubbles).  A copy of ``repro.server``, whose
README.md describes the architecture."""

from .admission import Batch, Batcher, RequestQueue, ServerRequest
from .cache import HotKeyCache
from .coordinator import CoordinatorConfig, FleetMaintenanceCoordinator
from .frontend import BourbonServer, ServerConfig
from .pipeline import PipelineConfig, PipelinedServer

__all__ = ["Batch", "Batcher", "BourbonServer", "CoordinatorConfig",
           "FleetMaintenanceCoordinator", "HotKeyCache", "PipelineConfig",
           "PipelinedServer", "RequestQueue", "ServerConfig",
           "ServerRequest"]
