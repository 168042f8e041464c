"""Batched lookup data plane: Bourbon's read path on PyTorch tensors.

The host LSM (lsm.py) is stacked into padded per-level device tensors; a
lookup batch of B probe keys then runs the paper's steps (Fig. 1 / Fig. 6):

  baseline path:  FindFiles -> SearchIB (fence bisect) -> SearchFB (bloom)
                  -> SearchDB (in-block bisect) -> ReadValue
  model path:     FindFiles -> ModelLookup (PLR segment bisect + mul-add)
                  -> SearchFB -> LoadChunk+LocateKey (delta-window probe)
                  -> ReadValue

  level path:     FindFiles -> level-model ModelLookup (one PLR over the
                  whole level: a global index) -> global index to (file,
                  local index) by bisect over the files' first indexes ->
                  window compare -> SearchFB on the selected file

ModelLookup, SearchFB, LoadChunk+LocateKey and SearchIB+SearchDB are the
hand-written CUDA kernels of ``repro_torch.kernels.ops`` (their plain
PyTorch versions on the CPU), and so is the filter plane's stack probe
(``filter_probe``) that prunes levels ahead of the descent when the caller
has no host mask.  FindFiles, the level path's file bisect and window
compare, the masking and the per-file positive/negative counts for the
cost-benefit analyzer are plain tensor code.  The semantics are those of
``repro.core.engine`` exactly: found, vptr, served level, per-file
counters, probe split and filter stats.

PyTorch runs eagerly, so the reference's jit cache, ``state_signature`` and
``trace_count`` have no counterpart here: a dispatch launches its kernels
directly and never synchronizes with the device; ``PendingLookup.resolve``
is the one synchronization point.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops

from .lsm import LSMTree, N_LEVELS
from .sstable import BLOCK_RECORDS

__all__ = ["EngineConfig", "DeviceLevel", "DeviceState", "FilterState",
           "LevelModel", "LookupEngine", "LookupResult", "PendingLookup",
           "resolve_device"]

KEY_SENTINEL = np.iinfo(np.int64).max
MODES = ("baseline", "model", "model_pure", "level")


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def resolve_device(device: str) -> torch.device:
    """The engine's device; raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available (pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# ----------------------------------------------------------------------------
# device state
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceLevel:
    keys: torch.Tensor       # (F, C) int64, padded KEY_SENTINEL
    vptrs: torch.Tensor      # (F, C) int64
    n: torch.Tensor          # (F,) int32 live records per file
    fences: torch.Tensor     # (F, NB) int64 padded KEY_SENTINEL
    n_blocks: torch.Tensor   # (F,) int32
    bloom: torch.Tensor      # (F, W) int64: the uint64 filter words
    bloom_nw: torch.Tensor   # (F,) int32 live filter words (hash modulus)
    min_key: torch.Tensor    # (F,) int64 (SENTINEL when slot empty)
    max_key: torch.Tensor    # (F,) int64 (SENTINEL when slot empty)
    starts: torch.Tensor     # (F, S) f64 PLR segment starts (+inf pad)
    slopes: torch.Tensor     # (F, S) f64
    icepts: torch.Tensor     # (F, S) f64
    nseg: torch.Tensor       # (F,) int32 (0 = no model)
    n_files: int             # host int: reading it never syncs the device


@dataclasses.dataclass
class LevelModel:
    """Level-granularity PLR (§4.3): key -> global index in the level.
    One row, so ModelLookup runs through the rows-form kernel."""
    starts: torch.Tensor     # (1, S) f64, S = level_seg_cap (+inf pad)
    slopes: torch.Tensor     # (1, S) f64
    icepts: torch.Tensor     # (1, S) f64
    nseg: torch.Tensor       # (1,) int32 (0 = no model)
    total: torch.Tensor      # (1,) int32 records in the level
    file_start: torch.Tensor  # (F,) int64 global index of each file's first key
    n_seg: int               # host copy of nseg: reading it never syncs


@dataclasses.dataclass
class DeviceState:
    levels: tuple            # N_LEVELS DeviceLevel
    level_models: tuple      # N_LEVELS LevelModel (n_seg = 0: no model)


@dataclasses.dataclass
class FilterState:
    """Per-level bloom filters stacked to a padded (L, W) device tensor."""
    bits: torch.Tensor       # (N_LEVELS, W) int64 (uint64 words), padded
    nw: torch.Tensor         # (N_LEVELS,) int32 build-time words; 0 = none
    has: torch.Tensor        # (N_LEVELS,) bool — nw > 0, precomputed


class LookupResult:
    """Materialized lookup answers.

    ``found`` / ``vptr`` / ``served_level`` are host arrays.  The per-level
    CBA counter vectors stay on the device until first touched, then are
    copied once."""

    def __init__(self, found, vptr, served_level, pos_counts, neg_counts,
                 values=None):
        self.found = found                 # (B,) bool
        self.vptr = vptr                   # (B,) int64
        self.served_level = served_level   # (B,) int8, -1 = miss everywhere
        self._pos_dev = pos_counts         # per level (F,) int32 tensor
        self._neg_dev = neg_counts
        self._pos_np: list | None = None
        self._neg_np: list | None = None
        self.values = values

    @property
    def pos_counts(self) -> list:
        if self._pos_np is None:
            self._pos_np = [p.cpu().numpy() for p in self._pos_dev]
        return self._pos_np

    @property
    def neg_counts(self) -> list:
        if self._neg_np is None:
            self._neg_np = [n.cpu().numpy() for n in self._neg_dev]
        return self._neg_np


@dataclasses.dataclass
class PendingLookup:
    """The dispatch half of a lookup: every field is a device tensor whose
    kernels may still be running.  ``resolve()`` is the synchronization
    point, so a caller can prepare batch N+1 while the device works on N."""
    found: torch.Tensor      # (B,) bool
    vptr: torch.Tensor       # (B,) int64
    served: torch.Tensor     # (B,) int8
    pos_counts: tuple        # per level (F,) int32
    neg_counts: tuple
    values: torch.Tensor | None = None

    def resolve(self) -> LookupResult:
        """Copy found/vptr/served (and values) to the host; the counter
        vectors stay lazy (see LookupResult)."""
        return LookupResult(self.found.cpu().numpy(), self.vptr.cpu().numpy(),
                            self.served.cpu().numpy(),
                            self.pos_counts, self.neg_counts,
                            None if self.values is None
                            else self.values.cpu().numpy())


# ----------------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class EngineConfig:
    plr_delta: int = 8
    bloom_k: int = 7
    block_records: int = BLOCK_RECORDS
    seg_cap: int = 4096          # max PLR segments per file
    level_seg_cap: int = 65536   # max PLR segments per level model
    fetch_values: bool = False
    # the reference's filter-plane impl switch, accepted and persisted so
    # configs carry across packages; the port always runs its kernel
    filter_impl: str = "ref"
    device: str = "cuda"         # "cpu" runs the kernels' plain versions


class LookupEngine:
    """Builds device state from the host tree and runs batched lookups."""

    def __init__(self, cfg: EngineConfig) -> None:
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self._state_cache: dict[int, DeviceLevel] = {}
        self._state_versions: list[int] = [-1] * N_LEVELS
        self._learned: list[tuple] = [()] * N_LEVELS  # learned flag per file
        self._lm_versions: list = [-1] * N_LEVELS
        self._lm_cache: dict[int, LevelModel] = {}
        # stamp for level models and filters that arrive without an epoch:
        # unique, decreasing, never reused — store-fit ones carry epochs >= 0
        self._unstamped_epoch = -2
        # per-level (model_probes, baseline_probes) and (pruned,
        # false-positive) counts, accumulated on the device as (N_LEVELS, 2)
        # int64 adds per batch and copied to the host only by *_np()
        self.record_probe_split = False
        self.probe_split_acc = None
        self._filter_cache: tuple | None = None
        self.filter_stats_acc = None

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ---------------------------------------------------------------- build
    def _build_level(self, tables) -> DeviceLevel:
        cfg = self.cfg
        F = max(2, _next_pow2(len(tables) + 1))
        C = max(cfg.block_records,
                _next_pow2(max((t.n for t in tables), default=1)))
        NB = max(1, C // cfg.block_records)
        W = max(1, _next_pow2(max((t.bloom.shape[0] for t in tables), default=1)))
        keys = np.full((F, C), KEY_SENTINEL, np.int64)
        vptrs = np.full((F, C), -1, np.int64)
        n = np.zeros(F, np.int32)
        fences = np.full((F, NB), KEY_SENTINEL, np.int64)
        n_blocks = np.zeros(F, np.int32)
        bloom = np.zeros((F, W), np.uint64)
        bloom_nw = np.ones(F, np.int32)
        min_key = np.full(F, KEY_SENTINEL, np.int64)
        max_key = np.full(F, KEY_SENTINEL, np.int64)
        for i, t in enumerate(tables):
            keys[i, : t.n] = t.keys
            vptrs[i, : t.n] = t.vptrs
            n[i] = t.n
            fences[i, : t.fences.shape[0]] = t.fences
            n_blocks[i] = t.fences.shape[0]
            bloom[i, : t.bloom.shape[0]] = t.bloom
            bloom_nw[i] = t.bloom.shape[0]
            min_key[i] = t.min_key
            max_key[i] = t.max_key
        d = self._to_dev
        return DeviceLevel(d(keys), d(vptrs), d(n), d(fences), d(n_blocks),
                           d(bloom.view(np.int64)), d(bloom_nw), d(min_key),
                           d(max_key), n_files=len(tables),
                           **self._stack_models(tables, F))

    def _stack_models(self, tables, F: int) -> dict:
        """The level's PLR segment tables: starts/slopes/icepts (F, S), nseg."""
        # size the segment tables to the live maximum: the bisect step count
        # is log2(S), so padding to cfg.seg_cap would burn gather steps
        live_ns = [int(t.model.n_segments) for t in tables
                   if t.model is not None]
        S = max(16, _next_pow2(max(live_ns, default=1)))
        starts = np.full((F, S), np.inf, np.float64)
        slopes = np.zeros((F, S), np.float64)
        icepts = np.zeros((F, S), np.float64)
        nseg = np.zeros(F, np.int32)
        for i, t in enumerate(tables):
            if t.model is not None:
                ns = int(t.model.n_segments)
                starts[i, :ns] = t.model.starts[:ns]
                slopes[i, :ns] = t.model.slopes[:ns]
                icepts[i, :ns] = t.model.intercepts[:ns]
                nseg[i] = ns
        d = self._to_dev
        return {"starts": d(starts), "slopes": d(slopes), "icepts": d(icepts),
                "nseg": d(nseg)}

    def _build_level_model(self, tree: LSMTree, level: int,
                           model) -> LevelModel:
        """A level model's segment table padded to ``level_seg_cap``, plus
        the global index of each file's first key.  A level without a model
        gets a one-entry table: its probes never reach ModelLookup."""
        tables = tree.levels[level]
        F = max(2, _next_pow2(len(tables) + 1))
        file_start = np.zeros(F, np.int64)
        acc = 0
        for i, t in enumerate(tables):
            file_start[i] = acc
            acc += t.n
        S = self.cfg.level_seg_cap if model is not None else 1
        starts = np.full((1, S), np.inf, np.float64)
        slopes = np.zeros((1, S), np.float64)
        icepts = np.zeros((1, S), np.float64)
        ns = 0
        if model is not None:
            ns = int(model.n_segments)
            starts[0, :ns] = np.asarray(model.starts)[:ns]
            slopes[0, :ns] = np.asarray(model.slopes)[:ns]
            icepts[0, :ns] = np.asarray(model.intercepts)[:ns]
        d = self._to_dev
        return LevelModel(d(starts), d(slopes), d(icepts),
                          d(np.array([ns], np.int32)),
                          d(np.array([acc], np.int32)), d(file_start), ns)

    def build_state(self, tree: LSMTree, level_models=None) -> DeviceState:
        """Stack the host tree to the device, reusing unchanged levels
        (dirty tracking by ``tree.level_version``) and level models (keyed
        on (level version, model epoch)).

        Learning a file does not bump its level's version, so the learned
        set is tracked too: when files were learned since a level was
        stacked, only its segment tables are restacked.  (The reference
        keys on the level version alone and keeps serving ``nseg = 0`` for
        such files, which in mode ``model_pure`` misses every key they
        hold.)"""
        levels = []
        lms = []
        level_models = level_models or [None] * N_LEVELS
        for i in range(N_LEVELS):
            ver = tree.level_version[i]
            # (level version, model epoch): id() is unsafe as a key (the
            # allocator reuses addresses); the epoch is monotonic per store
            # and persisted, so it also survives reopen
            lm = level_models[i]
            if lm is not None and getattr(lm, "epoch", -1) == -1:
                lm.epoch = self._unstamped_epoch
                self._unstamped_epoch -= 1
            mver = (ver, None if lm is None else lm.epoch)
            if self._lm_versions[i] != mver or i not in self._lm_cache:
                self._lm_cache[i] = self._build_level_model(tree, i, lm)
                self._lm_versions[i] = mver
            lms.append(self._lm_cache[i])
            tables = tree.levels[i]
            learned = tuple(t.model is not None for t in tables)
            if self._state_versions[i] != ver or i not in self._state_cache:
                self._state_cache[i] = self._build_level(tables)
                self._state_versions[i] = ver
                self._learned[i] = learned
            elif self._learned[i] != learned:
                lv = self._state_cache[i]
                self._state_cache[i] = dataclasses.replace(
                    lv, **self._stack_models(tables, lv.keys.shape[0]))
                self._learned[i] = learned
            levels.append(self._state_cache[i])
        return DeviceState(tuple(levels), tuple(lms))

    def build_filter_state(self, level_filters) -> FilterState:
        """Stack per-level host filters (core.filters.LevelFilter | None) to
        one padded (N_LEVELS, W) device tensor, reused while no filter epoch
        changed.  A level without a filter gets nw = 0."""
        key = []
        for f in level_filters:
            if f is None:
                key.append(None)
                continue
            if f.epoch == -1:
                f.epoch = self._unstamped_epoch
                self._unstamped_epoch -= 1
            key.append((f.epoch, f.n_words))
        sig = tuple(key)
        if self._filter_cache is not None and self._filter_cache[0] == sig:
            return self._filter_cache[1]
        L = len(level_filters)
        W = max(1, _next_pow2(max((f.n_words for f in level_filters
                                   if f is not None), default=1)))
        bits = np.zeros((L, W), np.uint64)
        nw = np.zeros(L, np.int32)
        for i, f in enumerate(level_filters):
            if f is not None:
                bits[i, : f.n_words] = f.bits
                nw[i] = f.n_words
        fs = FilterState(self._to_dev(bits.view(np.int64)), self._to_dev(nw),
                         self._to_dev(nw > 0))
        self._filter_cache = (sig, fs)
        return fs

    def filter_probe(self, fstate: FilterState,
                     probes: torch.Tensor) -> torch.Tensor:
        """The filter plane: one batched probe of every level's filter for
        the whole batch -> (L, B) maybe-mask ahead of the descent (SearchFB
        hoisted in front of FindFiles), through the stack-probe kernel."""
        return ops.bloom_probe_stack(fstate.bits, fstate.nw, probes,
                                     self.cfg.bloom_k)

    # ---------------------------------------------------------------- probes
    def _probe_file(self, lv: DeviceLevel, f: torch.Tensor, probes, mode: str):
        """One file row per probe (f (B,) int32) -> (hit, vptr); the model
        arm for learned files, the baseline arm for the rest."""
        cfg = self.cfg
        maybe = ops.bloom_probe(lv.bloom, lv.bloom_nw, f, probes, cfg.bloom_k)
        C = lv.keys.shape[-1]
        fl = f.long()
        if mode != "baseline":
            pos = ops.plr_lookup(lv.starts, lv.slopes, lv.icepts, lv.nseg,
                                 lv.n, f, probes)
            idx_m, found_m = ops.bounded_search(lv.keys, lv.n, f, pos, probes,
                                                cfg.plr_delta)
            if mode == "model_pure":
                # every live file is learned: the baseline arm is dead
                hit = maybe & found_m
                return hit, torch.where(hit, lv.vptrs[fl, idx_m.long()], -1)
        idx_b, found_b = ops.sstable_search(lv.fences, lv.keys, lv.n_blocks,
                                            lv.n, f, probes,
                                            cfg.block_records)
        if mode == "baseline":
            idx, found = idx_b, found_b
        else:
            has = lv.nseg[fl] > 0
            idx = torch.where(has, idx_m, idx_b)
            found = torch.where(has, found_m, found_b)
        hit = maybe & found
        idx = idx.long().clamp(max=C - 1)
        return hit, torch.where(hit, lv.vptrs[fl, idx], -1)

    def _probe_level_via_model(self, lv: DeviceLevel, lm: LevelModel,
                               probes):
        """Level-model path: the level PLR gives a global index, each window
        slot maps to (file, local index) by bisect over ``file_start``, and
        the first matching slot selects the file for SearchFB.  Returns
        (hit, vptr, file row per probe)."""
        d = self.cfg.plr_delta
        B = probes.shape[0]
        dev = probes.device
        zero_rows = torch.zeros(B, dtype=torch.int32, device=dev)
        gpos = ops.plr_lookup(lm.starts, lm.slopes, lm.icepts, lm.nseg,
                              lm.total, zero_rows, probes).long()
        top = (lm.total.long() - 1).clamp(min=0)
        offs = torch.arange(-(d + 1), d + 2, dtype=torch.int64, device=dev)
        gidx = torch.minimum((gpos[:, None] + offs).clamp(min=0), top)
        flat = gidx.reshape(-1)
        fidx = torch.searchsorted(lm.file_start[:lv.n_files], flat,
                                  right=True) - 1
        fidx = fidx.clamp(0, lm.file_start.shape[0] - 1)
        local = (flat - lm.file_start[fidx]).clamp(0, lv.keys.shape[-1] - 1)
        win = lv.keys[fidx, local].reshape(B, -1)
        eq = win == probes[:, None]
        hit_in = eq.any(dim=-1)
        rel = torch.argmax(eq.to(torch.uint8), dim=-1)   # argmax rejects bool
        sel = torch.arange(B, device=dev) * win.shape[1] + rel
        f_sel = fidx[sel]
        l_sel = local[sel]
        maybe = ops.bloom_probe(lv.bloom, lv.bloom_nw, f_sel.to(torch.int32),
                                probes, self.cfg.bloom_k)
        hit = maybe & hit_in
        return hit, torch.where(hit, lv.vptrs[f_sel, l_sel], -1), f_sel

    def _find_file(self, lv: DeviceLevel, probes):
        """FindFiles for a sorted level: candidate = first file with
        max_key >= probe; valid if min_key <= probe."""
        nf = lv.n_files
        f = torch.searchsorted(lv.max_key[:nf], probes, side="left")
        f_c = f.clamp(max=lv.max_key.shape[0] - 1)
        valid = (f < nf) & (lv.min_key[f_c] <= probes)
        return f_c, valid

    # ---------------------------------------------------------------- lookup
    def _lookup_impl(self, state: DeviceState, probes: torch.Tensor,
                     mode: str, live: tuple, fmaybe=None, fhas=None):
        dev = self.device
        B = probes.shape[0]
        use_filters = fmaybe is not None
        # L0 files carry file models in every mode but baseline: level mode
        # runs the per-file arms there (L0 ranges overlap)
        file_mode = "model" if mode == "level" else mode
        i64 = torch.int64
        found = torch.zeros(B, dtype=torch.bool, device=dev)
        vptr = torch.full((B,), -1, dtype=i64, device=dev)
        served = torch.full((B,), -1, dtype=torch.int8, device=dev)
        zero = torch.zeros((), dtype=i64, device=dev)
        pos_counts, neg_counts, prn_l, fp_l = [], [], [], []
        for li in range(N_LEVELS):
            lv = state.levels[li]
            Fdim = lv.max_key.shape[0]
            pos_c = torch.zeros(Fdim, dtype=torch.int32, device=dev)
            neg_c = torch.zeros(Fdim, dtype=torch.int32, device=dev)
            prn = fpc = zero
            if not live[li]:
                pass
            elif li == 0:
                # each live L0 slot newest-first (slot 0 = newest file)
                for s in range(lv.n_files):
                    f = torch.full((B,), s, dtype=torch.int32, device=dev)
                    active = (~found & (lv.min_key[s] <= probes)
                              & (probes <= lv.max_key[s]))
                    if use_filters:
                        # the L0 filter row covers the union of all L0
                        # tables: a screened key skips every slot's probe
                        prn = prn + (active & ~fmaybe[0]).sum(dtype=i64)
                        active = active & fmaybe[0]
                    hit, v = self._probe_file(lv, f, probes, file_mode)
                    hit = hit & active
                    miss = active & ~hit
                    if use_filters:
                        fpc = fpc + torch.where(fhas[0], miss.sum(dtype=i64),
                                                zero)
                    pos_c[s] += hit.sum(dtype=torch.int32)
                    neg_c[s] += miss.sum(dtype=torch.int32)
                    vptr = torch.where(hit, v, vptr)
                    served.masked_fill_(hit, 0)
                    found = found | hit
            else:
                f_cand, valid = self._find_file(lv, probes)
                active = ~found & valid
                if use_filters:
                    prn = prn + (active & ~fmaybe[li]).sum(dtype=i64)
                    active = active & fmaybe[li]
                lm = state.level_models[li]
                if mode == "level" and lm.n_seg > 0:
                    hit, v, fattr = self._probe_level_via_model(lv, lm,
                                                                probes)
                else:
                    hit, v = self._probe_file(
                        lv, f_cand.to(torch.int32), probes,
                        "baseline" if mode == "level" else mode)
                    fattr = f_cand
                hit = hit & active
                miss = active & ~hit
                if use_filters:
                    fpc = fpc + torch.where(fhas[li], miss.sum(dtype=i64),
                                            zero)
                pos_c.index_add_(0, fattr, hit.to(torch.int32))
                neg_c.index_add_(0, fattr, miss.to(torch.int32))
                vptr = torch.where(hit, v, vptr)
                served.masked_fill_(hit, li)
                found = found | hit
            pos_counts.append(pos_c)
            neg_counts.append(neg_c)
            prn_l.append(prn)
            fp_l.append(fpc)
        return (found, vptr, served, tuple(pos_counts), tuple(neg_counts),
                prn_l, fp_l)

    def _probe_split(self, state: DeviceState, mode: str, pos_counts,
                     neg_counts) -> torch.Tensor:
        """Per-level (model, baseline) probe attribution, on the device:
        mirrors BourbonStore._account_lookup's has-model rule per mode."""
        rows = []
        for li in range(N_LEVELS):
            tot_f = (pos_counts[li] + neg_counts[li]).to(torch.int64)
            tot = tot_f.sum()
            if mode == "baseline":
                mp = torch.zeros_like(tot)
            elif mode == "model_pure":
                mp = tot
            elif mode == "level" and li > 0:
                mp = tot if state.level_models[li].n_seg > 0 else \
                    torch.zeros_like(tot)
            else:
                mp = torch.where(state.levels[li].nseg > 0, tot_f, 0).sum()
            rows.append(torch.stack([mp, tot - mp]))
        return torch.stack(rows)

    def lookup_async(self, state: DeviceState, probes: np.ndarray, mode: str,
                     vlog=None, l0_live: int | None = None,
                     fstate: FilterState | None = None,
                     fmaybe_host: np.ndarray | None = None,
                     level_maybe: tuple | None = None) -> PendingLookup:
        """Dispatch half of the lookup: launches the device work and returns
        without waiting for it.  With ``fstate`` the caller's host-screen
        mask ``fmaybe_host`` (N_LEVELS, B) prunes the levels each key
        visits; without it the filter plane probes the stacked filters on
        the device (``filter_probe``).  ``level_maybe`` drops levels no
        dispatched key can reach."""
        if mode not in MODES:
            raise ValueError(f"unknown engine mode {mode!r}")
        p_dev = self._upload(np.ascontiguousarray(probes, np.int64))
        live = [lv.n_files > 0 for lv in state.levels]
        if l0_live == 0:
            live[0] = False
        fmaybe = fhas = None
        if fstate is not None:
            fmaybe = (self._upload(np.ascontiguousarray(fmaybe_host, bool))
                      if fmaybe_host is not None
                      else self.filter_probe(fstate, p_dev))
            fhas = fstate.has
            if level_maybe is not None:
                # a level whose maybe row is all-False for every dispatched
                # key cannot serve any of them: skip its probes entirely
                live = [a and b for a, b in zip(live, level_maybe)]
        (found, vptr, served, pos_c, neg_c, prn_l,
         fp_l) = self._lookup_impl(state, p_dev, mode, tuple(live), fmaybe,
                                   fhas)
        if self.record_probe_split:
            split = self._probe_split(state, mode, pos_c, neg_c)
            self.probe_split_acc = (split if self.probe_split_acc is None
                                    else self.probe_split_acc + split)
            if fstate is not None:
                fst = torch.stack([torch.stack(prn_l), torch.stack(fp_l)],
                                  dim=1)
                self.filter_stats_acc = (
                    fst if self.filter_stats_acc is None
                    else self.filter_stats_acc + fst)
        values = None
        if self.cfg.fetch_values and vlog is not None:
            # the device value gather (ReadValue); the store reads values
            # from the host log instead, as the reference does
            dv = vlog.device_view()
            values = dv[vptr.clamp(0, dv.shape[0] - 1)]
        return PendingLookup(found, vptr, served, pos_c, neg_c, values)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            # pinned + non_blocking: a pageable copy would wait for the
            # stream, i.e. for the previous batch's kernels
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def lookup(self, state: DeviceState, probes: np.ndarray, mode: str,
               vlog=None, l0_live: int | None = None,
               fstate: FilterState | None = None,
               fmaybe_host: np.ndarray | None = None) -> LookupResult:
        return self.lookup_async(state, probes, mode, vlog, l0_live, fstate,
                                 fmaybe_host).resolve()

    def probe_split_np(self) -> np.ndarray:
        """The accumulated per-level (model, baseline) probe counts — one
        device-to-host copy."""
        if self.probe_split_acc is None:
            return np.zeros((N_LEVELS, 2), np.int64)
        return self.probe_split_acc.cpu().numpy()

    def filter_stats_np(self) -> np.ndarray:
        """The accumulated per-level (pruned, false-positive) filter counts,
        with the same one-copy discipline as probe_split_np."""
        if self.filter_stats_acc is None:
            return np.zeros((N_LEVELS, 2), np.int64)
        return self.filter_stats_acc.cpu().numpy()
