"""FleetMaintenanceCoordinator — staggered, budgeted background work.

Left alone, every shard's :class:`~repro_torch.core.cba.MaintenanceScheduler`
fires value-log GC and MANIFEST checkpoints from its own write ticks —
independently, so a fleet-wide overwrite burst can put *every* shard
into GC in the same instant and stall the whole front end (the ROADMAP
per-shard-GC open item).  The coordinator closes it:

* on attach, every shard defers its self-driven maintenance
  (``maintenance_deferred = True``) — the coordinator is the only thing
  that ticks the schedulers from then on;
* each server tick offers a shared virtual-clock budget
  (``budget_us_per_tick``) to at most ``max_shards_per_tick`` shards,
  visiting shards **round-robin from a rotating cursor** so collections
  stagger across the fleet instead of synchronizing;
* each shard's :meth:`~repro_torch.core.store.BourbonStore.run_maintenance`
  spends only what fits in the budget it is handed (candidate picking is
  cost-capped inside the CBA), so no single server tick can charge more
  maintenance than the budget — work that didn't fit stays queued on the
  shard's estimates and is re-offered on a later visit.
"""

from __future__ import annotations

import dataclasses

__all__ = ["CoordinatorConfig", "FleetMaintenanceCoordinator"]


@dataclasses.dataclass
class CoordinatorConfig:
    # fleet-wide virtual μs per tick; None = auto (the fleet's atomic
    # unit of work: the worst-case cost of collecting one fully-live
    # value-log segment, the smallest budget that cannot starve)
    budget_us_per_tick: float | None = None
    max_shards_per_tick: int = 1         # at most k shards maintain at once


class FleetMaintenanceCoordinator:
    def __init__(self, store, cfg: CoordinatorConfig | None = None) -> None:
        self.store = store
        self.cfg = cfg if cfg is not None else CoordinatorConfig()
        # GC is atomic per segment: a budget below the worst-case cost of
        # one segment would defer every candidate forever (silent
        # starvation — the estimates grow, nothing ever fits).  Refuse it
        # loudly; with no budget given, the atomic cost IS the budget.
        atomic = max(sh.cfg.costs.t_gc(sh.cfg.vlog_seg_slots,
                                       sh.cfg.vlog_seg_slots)
                     for sh in store.shards)
        if self.cfg.budget_us_per_tick is None:
            self.budget_us = atomic
        elif self.cfg.budget_us_per_tick < atomic:
            raise ValueError(
                f"budget_us_per_tick={self.cfg.budget_us_per_tick:.0f} is "
                f"below the fleet's atomic maintenance unit ({atomic:.0f} "
                f"virtual us to collect one fully-live segment): every "
                f"candidate would be deferred forever.  Raise the budget "
                f"or shrink StoreConfig.vlog_seg_slots")
        else:
            self.budget_us = self.cfg.budget_us_per_tick
        store.set_maintenance_deferred(True)
        self._cursor = 0
        self.ticks = 0
        self.runs = 0                    # shard rounds that did real work
        self.spent_us = 0.0
        self.max_tick_us = 0.0
        self.budget_exhausted = 0        # ticks that hit the budget wall
        self.per_shard_us = [0.0] * store.n_shards
        self.per_shard_runs = [0] * store.n_shards

    def tick(self) -> float:
        """One coordination round; returns the virtual μs spent."""
        n = self.store.n_shards
        spent = 0.0
        active = 0
        last = self._cursor
        for j in range(n):
            if active >= self.cfg.max_shards_per_tick:
                break
            remaining = self.budget_us - spent
            if remaining <= 0.0:
                self.budget_exhausted += 1
                break
            i = (self._cursor + j) % n
            used = self.store.run_shard_maintenance(i, budget_us=remaining)
            if used > 0.0:
                active += 1
                self.runs += 1
                self.per_shard_us[i] += used
                self.per_shard_runs[i] += 1
                spent += used
                last = i
        # resume after the last shard that worked: the next tick's budget
        # goes to the shards this one starved
        self._cursor = (last + 1) % n
        self.ticks += 1
        self.spent_us += spent
        self.max_tick_us = max(self.max_tick_us, spent)
        return spent

    def detach(self) -> None:
        """Hand maintenance back to the shards' own ticks."""
        self.store.set_maintenance_deferred(False)

    def stats(self) -> dict:
        return {
            "ticks": self.ticks,
            "runs": self.runs,
            "spent_us": self.spent_us,
            "max_tick_us": self.max_tick_us,
            "budget_us_per_tick": self.budget_us,
            "max_shards_per_tick": self.cfg.max_shards_per_tick,
            "budget_exhausted": self.budget_exhausted,
            "per_shard_us": list(self.per_shard_us),
            "per_shard_runs": list(self.per_shard_runs),
            "gc_deferred": sum(st.cba.gc_deferred
                               for st in self.store.shards),
        }
