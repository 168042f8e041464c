"""Cost-benefit analyzer (paper §4.4) + the learning executor.

Decides, per sstable file, whether learning is worthwhile:

    learn F  iff  B_model > C_model
    C_model = T_build(F) = learn_per_key * n_keys            (conservative:
              learning threads are assumed to interfere, §4.4.2)
    B_model = (T_nb - T_nm) * N_n  +  (T_pb - T_pm) * N_p

with T_wait (= max file build time, 2-competitive ski-rental argument) before
a file becomes a learning candidate, per-level statistics of files that lived
their full life, bootstrap always-learn mode until stats exist, and a max
priority queue on (B_model - C_model).

The learning executor is a discrete-event simulation over the store's virtual
clock with a configurable number of learner "threads" (slots); model fitting
itself (Greedy-PLR) runs for real on the host.

:class:`MaintenanceScheduler` extends the same discipline from "when to
learn" to "when to GC the value log" and "when to checkpoint the MANIFEST":
background work runs only when an explicit cost-benefit model says it pays
off, with the same T_wait ski-rental framing per sealed segment.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math

from .clock import CostModel
from .lsm import LSMTree
from .sstable import SSTable

__all__ = ["CBAConfig", "CostBenefitAnalyzer", "LevelStats",
           "LearningExecutor", "MaintenanceConfig", "MaintenanceScheduler"]


@dataclasses.dataclass
class CBAConfig:
    policy: str = "cba"            # cba | always | offline | never
    t_wait_us: float | None = None  # None -> max-file build time (paper: 50ms)
    min_stat_files: int = 5        # bootstrap: always-learn until this many
    short_lived_filter_us: float = 1000.0  # exclude very short-lived files
    learner_slots: int = 4


@dataclasses.dataclass
class LevelStats:
    """Stats of files at one level that lived their full life (§4.4.2)."""
    n_files: int = 0
    sum_neg: float = 0.0
    sum_pos: float = 0.0
    sum_size: float = 0.0

    def observe(self, t: SSTable) -> None:
        self.n_files += 1
        self.sum_neg += t.stats.n_neg
        self.sum_pos += t.stats.n_pos
        self.sum_size += t.n

    @property
    def avg_neg(self) -> float:
        return self.sum_neg / self.n_files if self.n_files else 0.0

    @property
    def avg_pos(self) -> float:
        return self.sum_pos / self.n_files if self.n_files else 0.0

    @property
    def avg_size(self) -> float:
        return self.sum_size / self.n_files if self.n_files else 1.0


class CostBenefitAnalyzer:
    def __init__(self, cfg: CBAConfig, costs: CostModel) -> None:
        self.cfg = cfg
        self.costs = costs
        self.level_stats: dict[int, LevelStats] = {}
        self.decisions = {"learned": 0, "skipped": 0, "bootstrap": 0}

    def t_wait(self, file_cap: int) -> float:
        if self.cfg.t_wait_us is not None:
            return self.cfg.t_wait_us
        return self.costs.t_build(file_cap)

    def observe_dead_file(self, t: SSTable, now: float) -> None:
        if t.lifetime(now) < self.cfg.short_lived_filter_us:
            return  # filter very short-lived files (§4.4.2)
        self.level_stats.setdefault(t.level, LevelStats()).observe(t)

    def cost(self, t: SSTable) -> float:
        return self.costs.t_build(t.n)

    def benefit(self, t: SSTable) -> float:
        """B_model estimate. Uses same-level stats of completed files,
        scaled by file size (factor f = s / s_bar_l)."""
        st = self.level_stats.get(t.level)
        c = self.costs
        if st is None or st.n_files < self.cfg.min_stat_files:
            return float("inf")  # bootstrap: always learn (T_wait still applies)
        scale = t.n / max(st.avg_size, 1.0)
        n_n = st.avg_neg * scale
        n_p = st.avg_pos * scale
        return (c.t_nb - c.t_nm) * n_n + (c.t_pb - c.t_pm) * n_p

    def should_learn(self, t: SSTable) -> tuple[bool, float]:
        """Returns (decision, priority = B - C)."""
        if self.cfg.policy == "never" or self.cfg.policy == "offline":
            return False, 0.0
        if self.cfg.policy == "always":
            return True, float("inf")
        b, cst = self.benefit(t), self.cost(t)
        if b == float("inf"):
            self.decisions["bootstrap"] += 1
            return True, float("inf")
        if b > cst:
            self.decisions["learned"] += 1
            return True, b - cst
        self.decisions["skipped"] += 1
        return False, 0.0


@dataclasses.dataclass
class MaintenanceConfig:
    """Knobs for CBA-scheduled background maintenance (durable stores)."""
    auto_gc: bool = True             # schedule value-log GC from _tick
    # maintain per-segment dead-entry estimates in the write path.  On by
    # default even with auto_gc off — the estimates persist via MANIFEST
    # vdead, so a store reopened with auto_gc=True inherits them — but the
    # full-LSM liveness lookup costs per write batch; disable for pure
    # ingest benchmarks
    track_dead: bool = True
    gc_dead_ratio: float = 0.3       # candidacy watermark (estimated)

    def __post_init__(self):
        if self.auto_gc and not self.track_dead:
            # the scheduler's candidacy reads the estimates track_dead
            # maintains; "GC on, tracking off" would silently never collect
            raise ValueError(
                "auto_gc=True requires track_dead=True (GC candidacy is "
                "driven by the write-path dead-entry estimates)")
    gc_t_wait_us: float | None = None  # None -> worst-case collect cost
    gc_max_segments_per_tick: int = 4
    gc_scan_interval_us: float = 256.0  # min virtual time between scans
    auto_checkpoint: bool = True     # fold the MANIFEST once it grows
    checkpoint_bytes: int = 1 << 16  # edit-log size triggering compaction


class MaintenanceScheduler(CostBenefitAnalyzer):
    """CBA for maintenance: GC a sealed value-log segment iff

        B_gc > C_gc
        C_gc = scan cost (all entries) + relocation cost (live entries)
        B_gc = reclaimed dead bytes * avoided-amplification rate

    using the incremental per-segment dead estimates (ValueLog.note_dead)
    instead of a full-log scan, gated by a dead-ratio watermark and a
    per-segment T_wait (2-competitive ski-rental, as for learning: never
    wait longer than the work itself would have cost).  Also decides when
    the MANIFEST edit log is worth folding into a checkpoint.
    """

    def __init__(self, cfg: CBAConfig, costs: CostModel,
                 mcfg: MaintenanceConfig | None = None) -> None:
        super().__init__(cfg, costs)
        self.mcfg = mcfg if mcfg is not None else MaintenanceConfig()
        self.sealed_at: dict[int, float] = {}   # seg -> first-seen-sealed
        # decision counters are per segment-state transition, not per tick
        # (gc_candidates runs every tick; recounting would just measure
        # tick frequency)
        self._last_decision: dict[int, str] = {}
        self.gc_decisions = {"collected": 0, "skipped": 0, "waiting": 0}
        # scan gating: candidacy only changes when dead counts move, a new
        # segment seals, or a T_wait expires — ticks between those events
        # (and within the min scan interval) skip the per-segment loop
        self._seen_dead_version = -1
        self._seen_sealed = -1
        self._next_expiry = 0.0
        self._next_scan_at = 0.0
        self.gc_runs = 0
        self.gc_us = 0.0            # virtual time spent collecting
        self.gc_deferred = 0        # profitable segs pushed to a later tick
        self.last_plan_cost_us = 0.0  # estimated cost of the last candidate set
        self.last_plan_benefit_us = 0.0  # estimated benefit of that set
        self.checkpoints = 0
        self.checkpoint_us = 0.0
        self.checkpoint_overruns = 0  # folds too big for any tick budget
        # filter plane (per-level bloom filters ahead of the descent):
        # sizing decisions + build time, charged like learning jobs
        self.filter_decisions = {"bootstrap": 0, "sized": 0, "rebuilt": 0}
        self.filter_builds = 0
        self.filter_us = 0.0

    def gc_t_wait(self, seg_slots: int) -> float:
        if self.mcfg.gc_t_wait_us is not None:
            return self.mcfg.gc_t_wait_us
        # worst case: scanning + relocating a fully-live segment
        return self.costs.t_gc(seg_slots, seg_slots)

    def gc_cost(self, n_entries: int, n_dead: int) -> float:
        return self.costs.t_gc(n_entries, max(0, n_entries - n_dead))

    def gc_benefit(self, n_dead: int, entry_size: int) -> float:
        return self.costs.b_gc(n_dead * entry_size)

    def gc_candidates(self, vlog, now: float,
                      budget_us: float | None = None) -> list[int]:
        """Profitable sealed segments, best (B - C) first, capped at
        ``gc_max_segments_per_tick``.  Pure estimate — no file I/O, and
        the per-segment loop runs only when something could have changed.

        ``budget_us`` caps the *estimated* collection cost of the whole
        candidate set (the fleet coordinator's per-tick budget).  The
        estimate is conservative — dead counts only ever undercount, so
        estimated relocation work bounds the real thing from above —
        which makes the budget a hard ceiling on the virtual time the
        collection can actually charge.  Profitable segments that don't
        fit re-arm the change gate so the next tick reconsiders them
        instead of waiting for their dead counts to move again."""
        n_sealed = len(vlog) // vlog.seg_slots
        changed = (vlog.dead_version != self._seen_dead_version
                   or n_sealed != self._seen_sealed
                   or now >= self._next_expiry)
        if not changed or now < self._next_scan_at:
            return []
        self._seen_dead_version = vlog.dead_version
        self._seen_sealed = n_sealed
        self._next_scan_at = now + self.mcfg.gc_scan_interval_us
        self._next_expiry = float("inf")
        t_wait = self.gc_t_wait(vlog.seg_slots)
        scored: list[tuple[float, int]] = []
        for seg in vlog.sealed_segments():
            sealed = self.sealed_at.setdefault(seg, now)
            if now < sealed + t_wait:
                self._next_expiry = min(self._next_expiry, sealed + t_wait)
                self._count(seg, "waiting")
                continue
            n_dead = vlog.dead_by_seg.get(seg, 0)
            if vlog.dead_ratio_est(seg) < self.mcfg.gc_dead_ratio:
                self._count(seg, "skipped")
                continue
            b = self.gc_benefit(n_dead, vlog.entry_size)
            c = self.gc_cost(vlog.seg_slots, n_dead)
            if b <= c:
                self._count(seg, "skipped")
                continue
            scored.append((b - c, c, seg))
        scored.sort(reverse=True)
        picked: list[int] = []
        plan_cost = 0.0
        plan_benefit = 0.0
        deferred = 0
        for bc, c, seg in scored:
            if len(picked) >= self.mcfg.gc_max_segments_per_tick:
                deferred += 1
                continue
            if budget_us is not None and plan_cost + c > budget_us:
                deferred += 1
                continue
            picked.append(seg)
            plan_cost += c
            plan_benefit += bc + c   # scored holds (B - C, C, seg)
        if deferred:
            # budget (or the per-tick cap) left profitable work behind:
            # drop the change gate so the next scan re-scores it (the
            # scan-interval gate still rate-limits the per-segment loop)
            self._seen_dead_version = -1
            self.gc_deferred += deferred
        self.last_plan_cost_us = plan_cost
        self.last_plan_benefit_us = plan_benefit
        for seg in picked:
            self._last_decision.pop(seg, None)
        self.gc_decisions["collected"] += len(picked)
        return picked

    def _count(self, seg: int, decision: str) -> None:
        if self._last_decision.get(seg) != decision:
            self._last_decision[seg] = decision
            self.gc_decisions[decision] += 1

    def forget_segment(self, seg: int) -> None:
        """A segment was reclaimed: drop its scheduling bookkeeping."""
        self.sealed_at.pop(seg, None)
        self._last_decision.pop(seg, None)

    def should_checkpoint(self, manifest_bytes: int) -> bool:
        return (self.mcfg.auto_checkpoint
                and manifest_bytes > self.mcfg.checkpoint_bytes)

    # ------------------------------------------------------------ filters
    @staticmethod
    def filter_fpr(bits_per_key: int, k_hashes: int) -> float:
        """Expected bloom false-positive rate at the configured hash count
        (not the optimal-k approximation — k is fixed by the engine)."""
        return (1.0 - math.exp(-k_hashes / bits_per_key)) ** k_hashes

    def filter_bits_per_key(self, level: int, n_keys: int, base: int,
                            lo: int, hi: int, k_hashes: int) -> int:
        """CBA sizing for one level filter (§4.4 framing): per candidate
        bits-per-key, cost = expected false-positive probes over the
        level's observed miss traffic (each one a wasted model probe,
        t_nm) + memory rent on the held bits; pick the cheapest.  Without
        enough completed-file stats the base size is used (bootstrap, like
        always-learn)."""
        st = self.level_stats.get(level)
        if st is None or st.n_files < self.cfg.min_stat_files:
            self.filter_decisions["bootstrap"] += 1
            return base
        # miss traffic seen by a level of this size, scaled the same way
        # benefit() scales per-file stats (factor f = s / s_bar_l)
        n_neg = st.avg_neg * (n_keys / max(st.avg_size, 1.0))
        c = self.costs
        best, best_cost = base, float("inf")
        for bpk in range(lo, hi + 1):
            cost = (n_neg * self.filter_fpr(bpk, k_hashes) * c.t_nm
                    + n_keys * bpk * c.filter_mem_per_bit)
            if cost < best_cost:
                best, best_cost = bpk, cost
        self.filter_decisions["sized"] += 1
        return best


@dataclasses.dataclass(order=True)
class _Job:
    neg_priority: float
    seq: int
    table: SSTable = dataclasses.field(compare=False)
    ready_at: float = dataclasses.field(compare=False, default=0.0)
    level_version: int | None = dataclasses.field(compare=False, default=None)
    is_level: bool = dataclasses.field(compare=False, default=False)
    level: int = dataclasses.field(compare=False, default=-1)


class LearningExecutor:
    """Discrete-event learner pool over the virtual clock.

    Files become candidates T_wait after creation; profitable jobs enter a max
    priority queue on (B - C); ``slots`` jobs can run concurrently, each
    occupying virtual time T_build.  Level jobs fail if the level version
    changes before completion (reproducing §4.3's failed level learnings).
    """

    def __init__(self, cba: CostBenefitAnalyzer, costs: CostModel,
                 slots: int, plr_delta: int, seg_cap: int) -> None:
        self.cba = cba
        self.costs = costs
        self.slots = slots
        self.plr_delta = plr_delta
        self.seg_cap = seg_cap
        self.queue: list[_Job] = []
        self.running: list[tuple[float, _Job]] = []  # (finish_at, job)
        self.learn_time_us = 0.0      # total virtual time spent learning
        self.jobs_done = 0            # jobs that left the pipeline
        self.files_learned = 0
        self.level_attempts = 0
        self.level_failures = 0
        # monotonic identity for level models: every fit gets a fresh
        # epoch, cache keys and the MANIFEST ``lmodel`` record both use it.
        # A recovered store seeds this past the largest persisted epoch so
        # epochs stay unique across reopens.
        self.next_model_epoch = 0
        self._seq = itertools.count()
        # optional obs EventLog (BourbonStore.attach_obs wires it): each
        # job start logs a "learn" event with the CBA's cost/benefit
        # estimates — the paper's §4.4 decision inputs, made observable
        self.events = None

    def alloc_model_epoch(self) -> int:
        epoch = self.next_model_epoch
        self.next_model_epoch += 1
        return epoch

    # ------------------------------------------------------------ submission
    def maybe_submit_file(self, t: SSTable, now: float) -> None:
        if t.model is not None or t.learn_submitted or t.deleted_at is not None:
            return
        decision, prio = self.cba.should_learn(t)
        t.learn_submitted = True
        if decision:
            heapq.heappush(self.queue, _Job(-prio, next(self._seq), t,
                                            ready_at=now))

    def submit_level(self, tree: LSMTree, level: int, now: float) -> None:
        """Level-granularity learning job (§4.3)."""
        if not tree.levels[level]:
            return
        self.level_attempts += 1
        # a pseudo-job carrying the level version for invalidation
        job = _Job(-float("inf"), next(self._seq), tree.levels[level][0],
                   ready_at=now, level_version=tree.level_version[level],
                   is_level=True, level=level)
        heapq.heappush(self.queue, job)

    # ------------------------------------------------------------ execution
    def tick(self, tree: LSMTree, now: float, level_models: list) -> None:
        """Complete finished jobs; start new ones into free slots."""
        still = []
        for finish_at, job in self.running:
            if finish_at > now:
                still.append((finish_at, job))
                continue
            self.jobs_done += 1
            if job.is_level:
                if tree.level_version[job.level] != job.level_version:
                    self.level_failures += 1   # level changed mid-learn
                else:
                    level_models[job.level] = self._fit_level(tree, job.level)
            else:
                t = job.table
                if t.deleted_at is None and t.model is None:
                    t.learn(self.plr_delta, pad_to=self.seg_cap)
                    t.model_built_at = finish_at
                    self.files_learned += 1
        self.running = still
        while self.queue and len(self.running) < self.slots:
            job = heapq.heappop(self.queue)
            if not job.is_level:
                t = job.table
                if t.deleted_at is not None or t.model is not None:
                    self.jobs_done += 1   # drained without running
                    continue
                dur = self.costs.t_build(t.n)
            else:
                if tree.level_version[job.level] != job.level_version:
                    self.level_failures += 1
                    self.jobs_done += 1
                    continue
                dur = self.costs.t_build(tree.level_records(job.level))
            self.learn_time_us += dur
            if self.events is not None:
                prio = -job.neg_priority   # B - C (inf = always/bootstrap)
                self.events.log(
                    "learn", at_us=now, cost_us=dur, is_level=job.is_level,
                    level=job.level if job.is_level else job.table.level,
                    benefit_minus_cost_us=(None if prio == float("inf")
                                           else prio))
            self.running.append((now + dur, job))

    def _fit_level(self, tree: LSMTree, level: int):
        import numpy as np
        from .plr import greedy_plr_np
        keys = np.concatenate([t.keys for t in tree.levels[level]])
        model = greedy_plr_np(keys, delta=self.plr_delta)
        model.epoch = self.alloc_model_epoch()
        return model
