#!/usr/bin/env python
"""CI gate: the filter plane must never change a single result bit.

A bloom false positive costs wasted probes; a false *negative* is data
loss — a present key reported absent because a filter screened it or the
level maybe-mask pruned the level holding it.  This script runs one
fixed mixed GET workload (present keys, guaranteed-absent keys, deleted
keys whose tombstones must still pass their filter, and batches both
under and over ``host_answer_max`` so the host-answer path and the
device maybe-mask path are each exercised) through two identically
loaded stores of ``repro_torch`` — filters on vs off — and fails unless
every request's found/value arrays are byte-identical.  The filters-on
durable store is then reopened from the MANIFEST so the recovered-filter
path is held to the same bar.

    python port/scripts/check_filter_zero_fn.py [--device cuda|cpu]
                                                [--keys N]

At the default 4096 keys the stores, keys, requests and printed lines
are those of ``scripts/check_filter_zero_fn.py``; above it the tree takes
the default ``LSMConfig`` (more levels for the screen and the maybe-mask
to act on) and the requests keep their mix and sizes.  One more line,
``readings: {...}``, gives the filters-on arm's screened and
host-answered keys and the levels the maybe-mask dropped from a dispatch
(an all-False row, read from the engine call's ``level_maybe``).

Exit status 0 = identical; 1 = any divergence (printed per request).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(REPO_ROOT, "port"))

from repro_torch.core import LSMConfig, StoreConfig  # noqa: E402
from repro_torch.core.filters import FilterConfig  # noqa: E402
from repro_torch.core.store import BourbonStore  # noqa: E402

N_KEYS = 1 << 12
ROUNDS = 8


def _cfg(enabled: bool, n_keys: int, device: str) -> StoreConfig:
    lsm = (LSMConfig(memtable_cap=1 << 10, file_cap=1 << 11,
                     l1_cap_records=1 << 13)
           if n_keys <= N_KEYS else LSMConfig())
    return StoreConfig(mode="bourbon", policy="cba",
                       filters=FilterConfig(enabled=enabled), lsm=lsm,
                       device=device)


def _load(st: BourbonStore, keys: np.ndarray, dead: np.ndarray) -> None:
    for off in range(0, keys.shape[0], 1 << 11):
        st.put_batch(keys[off: off + (1 << 11)])
    st.delete_batch(dead)                 # tombstones must pass filters
    st.flush_all()
    st.learn_all()


def _requests(keys: np.ndarray, dead: np.ndarray) -> list[np.ndarray]:
    """Fixed probe batches: mixed present/absent/deleted at sizes that
    route through the host-answer path (small) and the padded device
    dispatch with the per-level maybe-mask (large)."""
    rng = np.random.default_rng(11)
    absent = keys + 1                     # odd gap keys: never inserted
    reqs = []
    for r in range(ROUNDS):
        size = 64 if r % 2 == 0 else 512  # straddle host_answer_max
        parts = [rng.choice(keys, size // 2),
                 rng.choice(absent, size // 4),
                 rng.choice(dead, size // 4)]
        reqs.append(np.concatenate(parts).astype(np.int64))
    reqs.append(absent[:512].copy())      # pure existence-check sweep
    reqs.append(keys[:512].copy())        # pure hit sweep
    return reqs


class _Pruned:
    """Counts, while installed on a store's engine, the levels its
    dispatches dropped through ``level_maybe`` (an all-False mask row)."""

    def __init__(self, engine):
        self.engine, self.n = engine, 0

    def __enter__(self):
        orig = self.engine.lookup_async

        def counted(*args, **kw):
            hint = kw.get("level_maybe")
            if hint is not None:
                self.n += sum(not h for h in hint)
            return orig(*args, **kw)
        self.engine.lookup_async = counted
        return self

    def __exit__(self, *exc):
        del self.engine.lookup_async


def _run(st: BourbonStore, reqs: list[np.ndarray], tag: str, watch,
         pruned: dict) -> list[tuple]:
    """Every request's (found, values) bytes; ``watch(tag, st)``, when
    given, is a context manager held around the GETs."""
    out = []
    with _Pruned(st.engine) as p, (
            watch(tag, st) if watch else contextlib.nullcontext()):
        for ks in reqs:
            found, vals = st.get_batch(ks)
            out.append((np.asarray(found).tobytes(),
                        np.asarray(vals).tobytes()))
    pruned[tag] = p.n
    return out


def _diff(tag: str, ref: list[tuple], got: list[tuple]) -> bool:
    ok = True
    for i, ((f0, v0), (f1, v1)) in enumerate(zip(ref, got)):
        if f0 != f1:
            print(f"FAIL: {tag} found-mask diverges at request {i} "
                  f"(a screened or pruned key was present: false negative)")
            ok = False
        elif v0 != v1:
            print(f"FAIL: {tag} values diverge at request {i}")
            ok = False
    return ok


def gate(device: str = "cuda", n_keys: int = N_KEYS,
         watch=None) -> tuple[int, dict]:
    """Run the gate; returns its exit status and its readings (request
    and probe counts, the filters-on arm's screened, host-answered and
    pruned counts and its files per level, the reopen's rebuilt filters,
    the seconds of each arm's load and GETs, and each arm's found/value
    bytes)."""
    rng = np.random.default_rng(3)
    keys = rng.permutation(np.arange(1, n_keys + 1, dtype=np.int64) * 4)
    dead = keys[:: 16].copy()             # every 16th key deleted again
    reqs = _requests(keys, dead)
    rec: dict = {"keys": n_keys, "device": device, "requests": len(reqs),
                 "probes": int(sum(r.shape[0] for r in reqs)),
                 "seconds": {}, "levels_pruned": {}, "answers": {}}
    secs = rec["seconds"]

    t0 = time.perf_counter()
    off = BourbonStore(_cfg(False, n_keys, device))
    _load(off, keys, dead)
    t1 = time.perf_counter()
    ref = _run(off, reqs, "filters-off", watch, rec["levels_pruned"])
    secs["filters-off"] = {"load": t1 - t0, "gets": time.perf_counter() - t1}
    rec["answers"]["filters-off"] = ref
    off.close()

    d = tempfile.mkdtemp(prefix="bourbon_zerofn_")
    try:
        t0 = time.perf_counter()
        on = BourbonStore.open(os.path.join(d, "db"),
                               _cfg(True, n_keys, device))
        _load(on, keys, dead)
        t1 = time.perf_counter()
        got = _run(on, reqs, "filters-on", watch, rec["levels_pruned"])
        secs["filters-on"] = {"load": t1 - t0,
                              "gets": time.perf_counter() - t1}
        rec["answers"]["filters-on"] = got
        screened = rec["filter_screened"] = on.filter_screened
        rec["filter_host_answered"] = on.filter_host_answered
        rec["filters_built"] = on.filters_built
        rec["files_per_level"] = [len(lv) for lv in on.tree.levels]
        on.close()
        if not _diff("filters-on", ref, got):
            return 1, rec
        if screened == 0:
            print("FAIL: filters-on arm screened nothing — the gate "
                  "did not exercise the filter plane")
            return 1, rec
        print(f"filters-on: {len(reqs)} requests byte-identical, "
              f"{screened} keys screened pre-dispatch")

        # reopen: recovered filters (MANIFEST record + .bf sidecars) must
        # serve the same answers with zero rebuilds
        t0 = time.perf_counter()
        re = BourbonStore.open(os.path.join(d, "db"),
                               _cfg(True, n_keys, device))
        built = rec["filters_rebuilt_on_reopen"] = re.filters_built
        t1 = time.perf_counter()
        got2 = _run(re, reqs, "filters-on-reopened", watch,
                    rec["levels_pruned"])
        secs["filters-on-reopened"] = {"load": t1 - t0,
                                       "gets": time.perf_counter() - t1}
        rec["answers"]["filters-on-reopened"] = got2
        re.close()
        if built != 0:
            print(f"FAIL: reopen rebuilt {built} filters (expected 0: "
                  f"recovered from MANIFEST)")
            return 1, rec
        if not _diff("filters-on-reopened", ref, got2):
            return 1, rec
        print(f"filters-on reopened: {len(reqs)} requests byte-identical, "
              f"0 filters rebuilt")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print("readings: " + json.dumps({
        k: rec[k] for k in ("filter_screened", "filter_host_answered",
                            "levels_pruned")}))
    print(f"OK: filter plane zero-false-negative across "
          f"{rec['probes']} probes")
    return 0, rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the stores' device (default: the card)")
    ap.add_argument("--keys", type=int, default=N_KEYS,
                    help="keys loaded into each store (default 4096)")
    args = ap.parse_args(argv)
    return gate(args.device, args.keys)[0]


if __name__ == "__main__":
    sys.exit(main())
